// Pairwise Manhattan contraction for Hopper (sm_90a): an (n, f) float32
// table in, the (n, n) float32 matrix num[i][j] = sum_f |x[i][f] - x[j][f]|
// out, the numerator of Bray-Curtis.
//
// Replaces: spark_examples_tpu/ops/pallas/braycurtis_kernel.py,
// pairwise_manhattan_pallas (kernel body _kernel), the TPU kernel that
// sweeps an f32 output tile over feature chunks with a (16, 256, 1024)
// broadcast-abs-reduce in VMEM.
//
// What it computes. Each output element is the feature-ordered f32 sum of
// |x[i][f] - x[j][f]|, the whole square (both triangles, the zero
// diagonal). On a table of integers every partial sum below 2^24 is exact
// in f32 in any order, so there the result is bitwise equal to the plain
// version and to the TPU kernel; on other tables it differs by rounding
// order only. Built without fast math: fabsf and the subtraction are IEEE.
//
// What bounds it. |a - b| is not a product, so the tensor cores cannot
// run it: each (i, j, f) triple is two FP32 instructions on the CUDA
// cores (FADD, then FADD with the |.| operand modifier into the
// accumulator). At the Bray-Curtis job's shape (10,000 samples x 4,096
// features) that is 8.2e11 instructions against 164 MB read and 400 MB
// written: bound by operations (about 24.5 ms at 132 SMs x 128 lanes x
// 1.98 GHz; the bytes take 0.17 ms at 3.35 TB/s).
//
// What this design does about it. A 256-thread block owns a 64 x 64
// output tile and walks the feature axis in 32-wide chunks inside the
// block (the TPU kernel's sequential f grid axis). Each chunk of the
// block's 64 rows and 64 columns is read once from global memory (an
// out-of-range row or feature reads as 0, and |0 - 0| = 0) and stored
// transposed in shared memory, feature-major, so that each thread then
// reads its four rows and four columns of one feature as two 16-byte
// loads. Each thread keeps a 4 x 4 sub-tile of f32 accumulators in
// registers: 16 |a - b| sums per pair of loads, so the inner loop is
// FADDs. One launch covers the whole matrix. Symmetry (only tiles with
// i <= j), wider per-thread tiles and cp.async/TMA staging are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;          // row samples per block
constexpr int BN = 64;          // column samples per block
constexpr int KF = 32;          // features per staged chunk
constexpr int THREADS = 256;
constexpr int TM = 4;           // accumulator rows per thread
constexpr int TN = 4;           // accumulator cols per thread

static_assert((BM / TM) * (BN / TN) == THREADS, "one sub-tile per thread");
static_assert(BM == BN, "one staging role covers rows and cols");
static_assert(THREADS % BM == 0 && KF % (THREADS / BM) == 0,
              "each thread stages whole features of one sample");

__global__ void __launch_bounds__(THREADS)
manhattan_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int n, int f) {
  __shared__ __align__(16) float sa[KF][BM];
  __shared__ __align__(16) float sb[KF][BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // Staging role: sample s of the tile, features q, q + 4, q + 8, ... of
  // the chunk. Neighbouring threads take neighbouring samples, so the
  // transposed stores into shared memory hit distinct banks.
  constexpr int STEP = THREADS / BM;
  const int s = tid % BM;
  const int q = tid / BM;
  const bool row_ok = row0 + s < n;
  const bool col_ok = col0 + s < n;
  const float* rp = x + static_cast<size_t>(row_ok ? row0 + s : 0) * f;
  const float* cp = x + static_cast<size_t>(col_ok ? col0 + s : 0) * f;

  // Compute role: rows ty*TM .., cols tx*TN .. of the tile.
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < f; k0 += KF) {
#pragma unroll
    for (int kk = q; kk < KF; kk += STEP) {
      const int k = k0 + kk;
      sa[kk][s] = (row_ok && k < f) ? rp[k] : 0.0f;
      sb[kk][s] = (col_ok && k < f) ? cp[k] : 0.0f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < KF; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sa[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&sb[kk][tx * TN]);
      const float a4[TM] = {av.x, av.y, av.z, av.w};
      const float b4[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += fabsf(a4[i] - b4[j]);
    }
    __syncthreads();
  }

  // Out is (n, n) f32, contiguous and 16-byte aligned.
  const bool vec = (n % 4) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= n) continue;
    const int c0 = col0 + tx * TN;
    float* dst = out + static_cast<size_t>(r) * n + c0;
    if (vec && c0 + TN <= n) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (c0 + j < n) dst[j] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched). `x` is
// (n, f) f32 row-major, `out` (n, n) f32.
int braycurtis_manhattan(const void* x, void* out, int n, int f,
                         void* stream) {
  if (n < 1 || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BN - 1) / BN, (n + BM - 1) / BM);
  manhattan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, f);
  return static_cast<int>(cudaGetLastError());
}

const char* braycurtis_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
