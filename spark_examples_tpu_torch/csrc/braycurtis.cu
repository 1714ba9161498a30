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
// diagonal). IEEE gives a - b = -(b - a) exactly, so |x_i - x_j| and
// |x_j - x_i| are the same float, and num[j][i] summed in feature order is
// num[i][j]: the kernel computes the i <= j tiles and writes each one
// twice. On a table of integers every partial sum below 2^24 is exact in
// f32 in any order, so there the result is bitwise equal to the plain
// version and to the TPU kernel; on other tables it differs by rounding
// order only. Built without fast math: fabsf and the subtraction are IEEE.
//
// What bounds it. |a - b| is not a product, so the tensor cores cannot
// run it: each (i, j, f) triple is two FP32 instructions on the CUDA
// cores (FADD, then FADD with the |.| operand modifier into the
// accumulator). The output needs the i <= j half: at the Bray-Curtis
// job's shape (10,000 samples x 4,096 features) that is 4.1e11
// instructions against 164 MB read and 400 MB written, bound by operations
// (about 12.2 ms at 132 SMs x 128 lanes x 1.98 GHz; the bytes take
// 0.17 ms at 3.35 TB/s).
//
// What this design does about it.
// - Only the tiles with I <= J run, from a linear block index; each
//   writes its 128 x 128 tile to [I, J] and, off the diagonal, its
//   transpose to [J, I] through a padded shared tile, so both stores
//   coalesce. That halves the work.
// - A 256-thread block owns the 128 x 128 tile; each thread keeps an 8 x 8
//   sub-tile of f32 accumulators (rows ty + 16 i, columns tx + 16 j) in
//   registers. Per four features it reads 8 + 8 float4 from shared memory
//   and makes 256 |a - b| accumulations: 16 LDS.128 per 512 FP32
//   instructions.
// - Staging: the feature axis is contiguous per sample, so each stage
//   (32 features) is copied with 16-byte cp.async, eight lanes per
//   128-byte row segment, into a row-major tile padded to 36 floats a row
//   (so the 16 different rows a warp reads hit distinct bank groups), in
//   a ring of 3 stages with one barrier per stage: the next chunks' loads
//   overlap this chunk's FADDs. Out-of-range rows and features are
//   zero-filled by the copy (|0 - 0| = 0), so one launch covers any (n, f).
// - A feature count that is not a multiple of 4 (or an unaligned table)
//   breaks 16-byte alignment: that case takes 4-byte cp.async copies
//   into the same ring.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;        // samples per block side
constexpr int THREADS = 256;     // 16 x 16
constexpr int TM = 8;            // accumulator rows (and columns) a thread
constexpr int KF = 32;           // features per stage
constexpr int LD = KF + 4;       // padded row stride in floats
constexpr int STAGES = 3;
constexpr int STAGE_FLOATS = 2 * TILE * LD;
constexpr int SMEM = STAGES * STAGE_FLOATS * 4;

static_assert(TILE == 16 * TM, "16 x 16 threads of 8 x 8");
static_assert((2 * TILE * (KF / 4)) % THREADS == 0, "whole copies a thread");
static_assert(TILE * (TILE + 1) <= STAGES * STAGE_FLOATS,
              "the transpose tile reuses the ring");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage: features f0 .. f0 + KF of the block's TILE rows and TILE
// columns, [side][sample][LD floats]. A copy past n or f reads nothing and
// writes zeros (its source address is kept in range all the same).
template <bool ALIGNED>
__device__ __forceinline__ void load_stage(float* dst, const float* x,
                                           int row0, int col0, int n, int f,
                                           int f0, int tid) {
#pragma unroll
  for (int i = 0; i < 2 * TILE * (KF / 4) / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int quad = idx % (KF / 4);
    const int r = (idx / (KF / 4)) % TILE;
    const int side = idx / ((KF / 4) * TILE);
    const int sample = (side ? col0 : row0) + r;
    const int k = f0 + 4 * quad;
    float* d = dst + side * TILE * LD + r * LD + 4 * quad;
    const bool row_ok = sample < n;
    const float* src = x + static_cast<size_t>(row_ok ? sample : 0) * f;
    if constexpr (ALIGNED) {
      const bool ok = row_ok && k < f;
      cp_async16(d, ok ? src + k : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && k + e < f;
        cp_async4(d + e, ok ? src + k + e : x, ok);
      }
    }
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 1)
manhattan_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                 int f) {
  extern __shared__ __align__(16) float smem[];

  // Tile (I, J), I <= J, from the linear block index.
  const int tiles = (n + TILE - 1) / TILE;
  int b = blockIdx.x;
  int ti = 0;
  while (b >= tiles - ti) {
    b -= tiles - ti;
    ++ti;
  }
  const int tj = ti + b;
  const int row0 = ti * TILE;
  const int col0 = tj * TILE;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;

  const int nk = (f + KF - 1) / KF;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<ALIGNED>(smem + s * STAGE_FLOATS, x, row0, col0, n, f,
                          s * KF, tid);
    cp_async_commit();
  }

  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kc + STAGES - 1;
    if (next < nk)
      load_stage<ALIGNED>(smem + (next % STAGES) * STAGE_FLOATS, x, row0,
                          col0, n, f, next * KF, tid);
    cp_async_commit();

    const float* sa = smem + (kc % STAGES) * STAGE_FLOATS;
    const float* sb = sa + TILE * LD;
#pragma unroll
    for (int q = 0; q < KF / 4; ++q) {
      float4 a[TM], bv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(sa + (ty + 16 * i) * LD + 4 * q);
#pragma unroll
      for (int j = 0; j < TM; ++j)
        bv[j] = *reinterpret_cast<const float4*>(sb + (tx + 16 * j) * LD + 4 * q);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] += fabsf(a[i].x - bv[j].x);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] += fabsf(a[i].y - bv[j].y);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] += fabsf(a[i].z - bv[j].z);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] += fabsf(a[i].w - bv[j].w);
    }
  }

  // [I, J] straight from registers: 16 lanes write 16 consecutive floats.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < n) out[static_cast<size_t>(r) * n + c] = acc[i][j];
    }
  }
  if (ti == tj) return;

  // [J, I]: the transpose, through a padded shared tile (the ring is free
  // once every copy has landed and every thread has left the loop).
  cp_async_wait<0>();
  __syncthreads();
  float* tr = smem;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j)
      tr[(ty + 16 * i) * (TILE + 1) + tx + 16 * j] = acc[i][j];
  __syncthreads();
  for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
    const int c = idx / TILE;
    const int r = idx % TILE;
    if (col0 + c < n && row0 + r < n)
      out[static_cast<size_t>(col0 + c) * n + row0 + r] =
          tr[r * (TILE + 1) + c];
  }
}

template <bool ALIGNED>
cudaError_t launch(const float* x, float* out, int n, int f,
                   cudaStream_t stream) {
  auto kernel = manhattan_kernel<ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + TILE - 1) / TILE;
  kernel<<<static_cast<unsigned>(tiles * (tiles + 1) / 2), THREADS, SMEM,
           stream>>>(x, out, n, f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the launch's CUDA error (0 = launched). `x`
// is (n, f) f32 row-major, `out` (n, n) f32.
int braycurtis_manhattan(const void* x, void* out, int n, int f,
                         void* stream) {
  if (n < 1 || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaError_t err = aligned ? launch<true>(xp, o, n, f, s)
                                  : launch<false>(xp, o, n, f, s);
  return static_cast<int>(err);
}

const char* braycurtis_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
