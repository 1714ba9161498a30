// Band to tridiagonal by bulge chasing for Hopper (sm_90a), the second
// stage of the subset eigensolve's two-stage reduction, and the way back
// for its k eigenvectors.
//
// Replaces no TPU kernel. The JAX package leaves its eigensolve to XLA's
// eigh; the port's subset solve reduces to tridiagonal form in two
// stages (dense to band by blocked FP32 products, ops/eigh.py), and no
// library on the card offers the band-to-tridiagonal step, so it is
// written here.
//
// What it computes. `a` is the solve's (n, n) working copy, read
// column-major as A (A(i, j) = a[j * n + i]). Its lower band of width b
// is a symmetric band matrix B. band_chase copies it into a compact
// buffer, band[j * 2b + d] = A(j + d, j) (d <= b; the rows past b are room
// for the bulge), and reduces it to T = Q2^T B Q2 by LAPACK sb2st's
// column-wise scheme: sweep s builds a reflector that annihilates column
// s below its first subdiagonal and applies it to the b x b diagonal
// block from both sides; applied from the right to the block below, it
// fills a bulge, whose first column the next reflector annihilates, and
// so on down the band, b rows a step. T's diagonal and off-diagonal go to
// tri[0, n) and tri[n, 2n - 1), a status to tri's last slot (as int32):
// bit 0 a non-finite T, bit 1 a chase that stalled. Sweep s's reflectors
// tile rows s + 1 .. n - 1, b each; with their unit heads implicit they
// fill the n - 1 - s slots of a's row n - 1 - s (A's strict upper
// triangle, free after the first stage): reflector j's tau at slot j b,
// its tail after it. band_apply_q2 applies Q2 to k columns (c, (k, n)
// row-major), from the last sweep to the first.
//
// What bounds it. Not operations (~6 n^2 b, 1e11 at n = 15,708, b = 64)
// and not bytes (the band, 8 MB at that size, lives in the 50 MB L2), but
// the chain of dependent steps: step j of sweep s may start only once
// sweep s - 1 has finished step j + 1, since their blocks share a column.
// Sweep s can start two steps after sweep s - 1 did, so the last sweep
// ends about 2n steps after the first began, and each step's latency
// (its loads from L2, its block barriers, its stores and the handoff)
// is what counts.
//
// What this design does about it.
// - One persistent launch. Each block takes the next sweep from a ticket
//   (an atomic counter), so sweeps start in order and a block only ever
//   waits on a sweep a running block holds: no deadlock, whatever the
//   number of resident blocks. Sweep s publishes its finished steps in
//   progress[s] (a release store after the block's barrier); step j of
//   sweep s + 1 waits (one thread polling with relaxed loads, backing
//   off, then a fence) until it reads j + 2. About n / 2b sweeps run at
//   once, one a block, and the grid holds little more than that, so few
//   blocks poll for nothing.
// - A step's columns of the band (its diagonal block, the block below
//   with the bulge, and the room under them) are one contiguous run that
//   no other step touches while it runs, so it comes into shared memory
//   whole, in 16-byte loads that bypass L1 (another SM wrote the lines),
//   and goes back the same way. Each row of the step is split over 8
//   threads by columns, with unrolled loops: the row products D v and
//   O v sum a row's partials once, the column product O^T v2 a
//   column's, and the norms are block sums; about ten barriers a step.
//   Compute, not the loads or the wait, is most of a step.
// - A stall (no progress for 5 s) sets the status and carries on, so a
//   fault ends the launch instead of hanging the card.
// - The back-transform: reflector j of sweep s touches rows s + 1 + j b
//   .. s + (j + 1) b, so a sweep's reflectors are disjoint and the only
//   order is between sweeps. One block a block-column j and a chunk of 8
//   columns (from a ticket) walks s from its first sweep down to 0,
//   keeping its b rows in registers (a warp a column, a lane one or two
//   rows): each sweep the window moves up a row, the row that enters
//   coming from block-column j - 1, which stored it when it left there,
//   and the row that will leave stored for block-column j + 1. The
//   sweeps go in aligned groups of 32: a block loads a group's
//   reflectors and entering rows at once, after block-column j - 1 has
//   published the group, so a step costs a few shuffles and no wait.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_B = 64;        // widest band (MAX_BAND in band_chase.py)
constexpr int DONE = 1 << 30;    // progress of a finished sweep
constexpr int Q2_COLS = 8;       // columns a back-transform block (a warp each)
constexpr int Q2_GROUP = 32;     // sweeps a back-transform block takes a wait
constexpr unsigned long long STALL_NS = 5000000000ull;

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.global.relaxed.gpu.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The sum of x over a block of NT threads (a multiple of 32), in every
// thread. `red` holds NT / 32 floats; the caller leaves a barrier
// between two calls.
template <int NT>
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if (NT == 32) return x;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) total += red[w];
  return total;
}

// Thread 0 waits until *flag >= need (relaxed loads, backing off; a
// stall sets status bit 1 and gives up), then fences: the acquire side
// of the flag's release store. Then the whole block goes on.
__device__ void wait_for(const int* flag, int need, int* status) {
  if (threadIdx.x == 0) {
    if (ld_relaxed(flag) < need) {
      const unsigned long long t0 = now_ns();
      unsigned ns = 16;
      while (ld_relaxed(flag) < need) {
        __nanosleep(ns);
        ns = ns < 256 ? 2 * ns : ns;
        if (now_ns() - t0 > STALL_NS) {
          atomicOr(status, 2);
          break;
        }
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// LAPACK larfg on x (x0 its head, norm2 the sum of squares of its
// tail): tau, beta and the scale of the tail, with (I - tau v v^T) x =
// beta e_1 for v = (1, scale x_tail).
__device__ __forceinline__ void householder(float x0, float norm2, float* tau,
                                            float* beta, float* scale) {
  *tau = 0.f;
  *beta = x0;
  *scale = 0.f;
  if (norm2 != 0.f) {
    const float bt = -copysignf(sqrtf(x0 * x0 + norm2), x0);
    *tau = (bt - x0) / bt;
    *beta = bt;
    *scale = 1.f / (x0 - bt);
  }
}

__global__ void pack_kernel(const float* __restrict__ a, int n, int b,
                            float* __restrict__ band) {
  const int j = blockIdx.x;
  const int d = threadIdx.x;
  const int ld = 2 * b;
  if (d < ld) {
    band[static_cast<size_t>(j) * ld + d] =
        d <= b && j + d < n ? a[static_cast<size_t>(j) * n + j + d] : 0.f;
  }
}

// One block a sweep at a time, NT x QS threads: thread (r, q) is row r
// of the step's diagonal block D (rows st .. ed) and of the block below
// it, O (rows ed + 1 .. ed + M), for the columns c = q mod QS, its loops
// unrolled to their NT / QS columns. The step's columns st .. ed of the
// band, D and O and the bulge room below them, are one contiguous run of
// L x 2b floats that no other step touches while this one runs: it is
// copied into shared memory whole (16-byte loads for an even b) and
// back. In it, D(r, c) = sB[c ld + r - c] for r >= c and O(r, c) =
// sB[c ld + L + r - c]; ld - 1 is odd, so a column read across the rows
// (r ld + c - r, the upper half of D) hits distinct banks too.
template <int NT, int QS>
__global__ void __launch_bounds__(NT * QS)
chase_kernel(float* __restrict__ a, int n, int b, float* __restrict__ band,
             int* __restrict__ work, float* __restrict__ tri) {
  constexpr int THREADS = NT * QS;
  constexpr int CS = NT / QS;  // columns a thread
  __shared__ __align__(16) float sB[NT * 2 * NT];
  __shared__ float part[2][QS][NT];
  __shared__ float sv[NT], sw[NT], sy[NT], sv2[NT], sx[NT], sz[NT];
  __shared__ float red[THREADS / 32];
  __shared__ int sweep;
  int* ticket = work;
  int* progress = work + 1;
  int* status = reinterpret_cast<int*>(tri + 2 * n - 1);
  const int ld = 2 * b;
  const int tid = threadIdx.x;
  const int r = tid % NT, q = tid / NT;
  const bool vec = (b & 1) == 0;  // the run is 16-byte aligned

  for (;;) {
    if (tid == 0) sweep = atomicAdd(ticket, 1);
    __syncthreads();
    const int s = sweep;
    __syncthreads();
    if (s >= n) return;
    const int rows = n - 1 - s;
    const int steps = rows > 1 ? (rows + b - 1) / b : 0;
    const int prev_steps = (rows + b) / b;  // sweep s - 1: rows + 1 rows
    float* store = a + static_cast<size_t>(n - 1 - s) * n;
    if (rows == 1 && tid == 0) store[0] = 0.f;
    float tau = 0.f;
    for (int j = 0; j < steps; ++j) {
      if (s > 0) wait_for(progress + s - 1, min(j + 2, prev_steps), status);
      const int st = s + 1 + j * b;
      const int ed = min(st + b, n) - 1;
      const int L = ed - st + 1;
      const int M = ed < n - 1 ? min(ed + b, n - 1) - ed : 0;
      float* run = band + static_cast<size_t>(st) * ld;
      float* col_s = band + static_cast<size_t>(s) * ld + 1;
      if (j == 0 && q == 0) sx[r] = r < L ? __ldcg(col_s + r) : 0.f;
      if (vec) {
        const float4* src = reinterpret_cast<const float4*>(run);
        float4* dst = reinterpret_cast<float4*>(sB);
        for (int i = tid; i < L * ld / 4; i += THREADS) dst[i] = __ldcg(src + i);
      } else {
        for (int i = tid; i < L * ld; i += THREADS) sB[i] = __ldcg(run + i);
      }
      __syncthreads();
      if (j == 0) {
        // The first reflector annihilates column s below row s + 1.
        const float xr = sx[r];
        const float norm2 =
            block_sum<THREADS>(q == 0 && r >= 1 ? xr * xr : 0.f, red);
        float beta, scale;
        householder(sx[0], norm2, &tau, &beta, &scale);
        if (q == 0) {
          sv[r] = r == 0 ? 1.f : xr * scale;
          if (r < L) col_s[r] = r == 0 ? beta : 0.f;
        }
        __syncthreads();
      }
      const float vr = sv[r];
      if (q == 0 && r < L) store[j * b + r] = r == 0 ? tau : vr;
      // Partial row products: D v and O v over this thread's columns.
      {
        float pw = 0.f, py = 0.f;
#pragma unroll
        for (int i = 0; i < CS; ++i) {
          const int c = q + QS * i;
          if (c < L) {
            const float vc = sv[c];
            pw += (c <= r ? sB[c * ld + r - c] : sB[r * ld + c - r]) * vc;
            py += sB[c * ld + L + r - c] * vc;
          }
        }
        part[0][q][r] = pw;
        part[1][q][r] = py;
      }
      __syncthreads();
      // w = tau D v and y = tau O v, summed once a row.
      float wv = 0.f;
      if (q == 0) {
        float w = 0.f, y = 0.f;
#pragma unroll
        for (int i = 0; i < QS; ++i) {
          w += part[0][i][r];
          y += part[1][i][r];
        }
        w = r < L ? tau * w : 0.f;
        sw[r] = w;
        sy[r] = r < M ? tau * y : 0.f;
        wv = w * vr;
      }
      // D -= v w'^T + w' v^T (its lower half), w' = w - tau (w^T v) v / 2;
      // O -= y v^T.
      const float alpha = -0.5f * tau * block_sum<THREADS>(wv, red);
      const float y = sy[r];
      const float wr = sw[r] + alpha * vr;
#pragma unroll
      for (int i = 0; i < CS; ++i) {
        const int c = q + QS * i;
        if (c < L) {
          const float vc = sv[c];
          if (c <= r && r < L)
            sB[c * ld + r - c] -= vr * (sw[c] + alpha * vc) + wr * vc;
          if (r < M) sB[c * ld + L + r - c] -= y * vc;
        }
      }
      __syncthreads();
      if (M > 0) {
        // The next reflector annihilates O's first column below its top;
        // then O[:, 1:] -= v2 (tau2 v2^T O[:, 1:]).
        const float xr = r < M ? sB[L + r] : 0.f;
        const float norm2 =
            block_sum<THREADS>(q == 0 && r >= 1 ? xr * xr : 0.f, red);
        float tau2, beta, scale;
        householder(sB[L], norm2, &tau2, &beta, &scale);
        const float v2 = r == 0 ? 1.f : xr * scale;
        if (q == 0) sv2[r] = v2;
        __syncthreads();
        if (q == 0) {
          if (r < M) sB[L + r] = r == 0 ? beta : 0.f;
          sv[r] = v2;
        }
        {
          float pz = 0.f;
          if (r >= 1 && r < L) {
#pragma unroll
            for (int k = 0; k < CS; ++k) {
              const int i = q + QS * k;
              if (i < M) pz += sv2[i] * sB[r * ld + L + i - r];
            }
          }
          part[0][q][r] = pz;
        }
        __syncthreads();
        if (q == 0) {
          float z = 0.f;
#pragma unroll
          for (int i = 0; i < QS; ++i) z += part[0][i][r];
          sz[r] = tau2 * z;
        }
        __syncthreads();
        if (r < M) {
#pragma unroll
          for (int k = 0; k < CS; ++k) {
            const int c = q + QS * k;
            if (c >= 1 && c < L) sB[c * ld + L + r - c] -= v2 * sz[c];
          }
        }
        tau = tau2;
      }
      __syncthreads();
      if (vec) {
        const float4* src = reinterpret_cast<const float4*>(sB);
        float4* dst = reinterpret_cast<float4*>(run);
        for (int i = tid; i < L * ld / 4; i += THREADS) dst[i] = src[i];
      } else {
        for (int i = tid; i < L * ld; i += THREADS) run[i] = sB[i];
      }
      __syncthreads();
      if (tid == 0) st_release(progress + s, j + 1);
    }
    // Column s is final once sweep s - 1 has ended: d_s, e_s to tri.
    if (s > 0) wait_for(progress + s - 1, DONE, status);
    if (tid == 0) {
      const float d = __ldcg(band + static_cast<size_t>(s) * ld);
      tri[s] = d;
      bool finite = isfinite(d);
      if (s < n - 1) {
        const float e = __ldcg(band + static_cast<size_t>(s) * ld + 1);
        tri[n + s] = e;
        finite = finite && isfinite(e);
      }
      if (!finite) atomicOr(status, 1);
      st_release(progress + s, DONE);
    }
  }
}

// One block a (column chunk, block-column j): warp w is column
// chunk * Q2_COLS + w, lane l rows l and l + 32 of the window; window
// index i is row s + 1 + j b + i at sweep s. The sweeps go in groups of
// Q2_GROUP, aligned across block-columns: a group's reflectors are
// loaded into shared memory and its entering rows into the lanes at
// once, after block-column j - 1 has ended the same group.
template <int NT>
__global__ void __launch_bounds__(32 * Q2_COLS)
q2_kernel(const float* __restrict__ a, int n, int b, float* __restrict__ c,
          int k, int* __restrict__ work) {
  constexpr int R = NT / 32;
  constexpr int THREADS = 32 * Q2_COLS;
  __shared__ float sv[Q2_GROUP][NT];  // tau in [t][0], the tail after it
  __shared__ int slot;
  int* ticket = work;
  int* status = work + 1;
  int* done = work + 2;
  const int blocks = (n - 2) / b + 1;
  const int chunks = (k + Q2_COLS - 1) / Q2_COLS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int leave_lane = (b - 1) & 31, leave_q = (b - 1) >> 5;
  for (;;) {
    if (threadIdx.x == 0) slot = atomicAdd(ticket, 1);
    __syncthreads();
    const int t0 = slot;
    __syncthreads();
    if (t0 >= blocks * chunks) return;
    const int chunk = t0 / blocks, j = t0 - chunk * blocks;
    const int ci = chunk * Q2_COLS + warp;
    float* col = ci < k ? c + static_cast<size_t>(ci) * n : nullptr;
    int* flag = done + chunk * blocks;
    const int first = n - 2 - j * b;  // block-column j's first sweep
    float x[R];
#pragma unroll
    for (int q = 0; q < R; ++q) x[q] = 0.f;
    for (int hi = first; hi >= 0;) {
      const int lo = hi / Q2_GROUP * Q2_GROUP;
      const int g = hi - lo + 1;
      for (int idx = threadIdx.x; idx < g * NT; idx += THREADS) {
        const int t = idx / NT, i = idx - t * NT;
        const int s = hi - t;
        const int L = min(b, n - 1 - s - j * b);
        sv[t][i] = i < L ? a[static_cast<size_t>(n - 1 - s) * n + j * b + i]
                         : 0.f;
      }
      // Block-column j - 1 has ended this group: sweep lo + 1 is done.
      if (j > 0)
        wait_for(flag + j - 1, first + b - lo, status);
      else
        __syncthreads();
      // Step t's entering row, s + 1 + j b with s = hi - t, in lane t.
      const float e = col != nullptr && lane < g
                          ? __ldcg(col + hi - lane + 1 + j * b) : 0.f;
      for (int t = 0; t < g; ++t) {
        const int s = hi - t;
        const float enter = __shfl_sync(0xffffffffu, e, t);
        float up[R];
#pragma unroll
        for (int q = 0; q < R; ++q)
          up[q] = __shfl_up_sync(0xffffffffu, x[q], 1);
#pragma unroll
        for (int q = R - 1; q >= 1; --q) {
          const float carry = __shfl_sync(0xffffffffu, x[q - 1], 31);
          x[q] = lane == 0 ? carry : up[q];
        }
        x[0] = lane == 0 ? enter : up[0];
        const float tau = sv[t][0];
        if (tau != 0.f) {
          float v[R], dot = 0.f;
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int i = lane + 32 * q;
            v[q] = i == 0 ? 1.f : sv[t][i];
            dot += v[q] * x[q];
          }
          dot = tau * warp_sum(dot);
#pragma unroll
          for (int q = 0; q < R; ++q) x[q] -= v[q] * dot;
        }
        // The row at index b - 1 leaves at the next sweep: store it.
        const int leave = s + j * b + b;
        if (col != nullptr && lane == leave_lane && leave < n) {
#pragma unroll
          for (int q = 0; q < R; ++q)
            if (q == leave_q) col[leave] = x[q];
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) st_release(flag + j, first - lo + 1);
      hi = lo - 1;
    }
    // After sweep 0 the window's rows 1 + j b .. j b + b - 1 are final.
    if (col != nullptr) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + 32 * q;
        const int row = 1 + j * b + i;
        if (i < b - 1 && row < n) col[row] = x[q];
      }
    }
  }
}

template <typename K>
int resident_grid(K kernel, int threads, int want) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    threads, 0) !=
          cudaSuccess) {
    return 0;
  }
  const int most = sms * (per_sm > 0 ? per_sm : 1);
  return want < most ? want : most;
}

// NT rows a block, each split over QS threads (8 columns a thread). One
// instantiation, NT = MAX_B, takes every b <= MAX_B; the solve runs
// b = MAX_B (BAND_WIDTH in ops/eigh.py).
template <int NT, int QS>
cudaError_t launch_chase(float* a, int n, int b, float* band, int* work,
                         float* tri, cudaStream_t s) {
  // About n / 2b sweeps are under way at once: more blocks would only
  // wait.
  const int grid = resident_grid(chase_kernel<NT, QS>, NT * QS,
                                 min(n, n / (2 * b) + 32));
  if (grid < 1) return cudaGetLastError();
  chase_kernel<NT, QS><<<grid, NT * QS, 0, s>>>(a, n, b, band, work, tri);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_q2(const float* a, int n, int b, float* c, int k,
                      int* work, int items, cudaStream_t s) {
  const int grid = resident_grid(q2_kernel<NT>, 32 * Q2_COLS, items);
  if (grid < 1) return cudaGetLastError();
  q2_kernel<NT><<<grid, 32 * Q2_COLS, 0, s>>>(a, n, b, c, k, work);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the launches' CUDA error (0 = launched).
// `a` (n, n) f32, `band` n * 2b f32 scratch, `work` n + 1 int32 scratch,
// `tri` 2n f32 (d, e, the status).
int band_chase(void* a, int n, int b, void* band, void* work, void* tri,
               void* stream) {
  if (n < 1 || b < 2 || b > MAX_B)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<float*>(tri);
  cudaError_t err =
      cudaMemsetAsync(work, 0, sizeof(int) * (static_cast<size_t>(n) + 1), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(t + 2 * n - 1, 0, sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_kernel<<<n, 2 * b, 0, s>>>(static_cast<const float*>(a), n, b,
                                  static_cast<float*>(band));
  auto* ap = static_cast<float*>(a);
  auto* bp = static_cast<float*>(band);
  auto* wp = static_cast<int*>(work);
  err = launch_chase<MAX_B, 8>(ap, n, b, bp, wp, t, s);
  return static_cast<int>(err);
}

// `c` (k, n) f32 row-major: k columns of length n. `work`
// band_q2_work_ints(n, b, k) int32 scratch; work[1] is the status (bit 1:
// a stall).
int band_q2_work_ints(int n, int b, int k) {
  const int blocks = n >= 2 ? (n - 2) / b + 1 : 0;
  return 2 + blocks * ((k + Q2_COLS - 1) / Q2_COLS);
}

int band_apply_q2(const void* a, int n, int b, void* c, int k, void* work,
                  void* stream) {
  if (n < 1 || b < 2 || b > MAX_B || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int ints = band_q2_work_ints(n, b, k);
  cudaError_t err = cudaMemsetAsync(
      work, 0, sizeof(int) * static_cast<size_t>(ints), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ints == 2 || k == 0) return 0;
  const auto* ap = static_cast<const float*>(a);
  auto* cp = static_cast<float*>(c);
  auto* wp = static_cast<int*>(work);
  err = launch_q2<MAX_B>(ap, n, b, cp, k, wp, ints - 2, s);
  return static_cast<int>(err);
}

const char* band_chase_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
