// Transducer lattice recursions for Hopper (sm_90a): the forward lattice
// alpha, the backward lattice beta, and the probability-space affine rows
// of the expected delay.
//
// Replaces the Pallas TPU kernels of
// wav2vec_s_tpu/ops/transducer/pallas_kernel.py:
//   alphas_kernel      <- pallas_alphas (_alphas_kernel), K5a;
//   betas_kernel       <- pallas_betas (the alphas kernel on the flipped,
//                         lane-rolled lattice), K5b;
//   affine_rows_kernel <- pallas_affine_rows (_affine_rows_kernel), K6,
//                         forward for the expected delay, reverse for its
//                         backward.
// All three work on [B, T, U] float32 lattices (T source steps, U label
// cells), contiguous.
//
//   alpha(t,u) = lae(alpha(t-1,u) + blank(t-1,u), alpha(t,u-1) + emit(t,u-1))
//   beta(t,u)  = lae(beta(t+1,u) + blank'(t,u),   beta(t,u+1) + emit'(t,u))
//   x(t,u)     = a(t,u) x(t,u-/+1) + pb(t,u) x(t-/+1,u) + c(t,u)
// with lae = log-add-exp.  beta runs on the virtually extended lattice of
// wav2vec_s_tpu/ops/transducer/analytic.py (_betas): rows t >= T_b pass
// blanks through with log-prob 0 (blank'), emits are BLOCK = -1e9 outside
// u < U_b, t < T_b (emit'), and the virtual row t = T is 0 at u = U_b and
// BLOCK elsewhere.  The affine rows start from zero outside the lattice.
//
// What bounds it: latency.  Each cell depends on its left (or right) and
// upper (or lower) neighbour, so a lattice is T + U - 1 dependent steps of
// at most min(T, U) independent cells; the work (a few flops per cell) and
// the bytes (4-12 per cell) are negligible next to the step count.
//
// What the design does about it: one block per utterance walks the
// anti-diagonals (the wavefront of warp_transducer's compute_alphas_kernel,
// which the TPU kernel's docstring cites), one thread per label cell u
// (several cells per thread when U > 1024, so U is not capped: the CAAT
// default max_target_positions is 1024).  The newest value of every column
// lives in shared memory, double-buffered, so a diagonal costs one
// __syncthreads and no global read of the recursion itself.  The TPU
// kernel's row scans with Hillis-Steele prefix operators, flips and lane
// rolls were its way to vectorise on a sequential grid; they are not
// carried over.
//
// Plain C interface (loaded with ctypes): each w2vs_transducer_* returns the
// cudaGetLastError() code of its launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBlock = -1e9f;   // analytic.BLOCK: survives sums in f32
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// alpha over the full [T, U] lattice (no lengths: cells past an
// utterance's lengths hold finite values its loss never reads).
__global__ void alphas_kernel(const float* __restrict__ lpb,
                              const float* __restrict__ lpe,
                              float* __restrict__ alpha, int T, int U) {
  extern __shared__ float col[];               // 2 x U: column heads
  float* cur = col;
  float* nxt = col + U;
  const size_t base = (size_t)blockIdx.x * T * U;
  lpb += base;
  lpe += base;
  alpha += base;
  for (int u = threadIdx.x; u < U; u += blockDim.x) cur[u] = 0.f;
  __syncthreads();
  for (int d = 0; d < T + U - 1; ++d) {
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      const int t = d - u;
      float v = cur[u];                          // alpha(t-1, u)
      if (t >= 0 && t < T) {
        if (t == 0) {
          v = u == 0 ? 0.f : cur[u - 1] + lpe[u - 1];
        } else if (u == 0) {
          v = v + lpb[(size_t)(t - 1) * U];
        } else {
          v = lae(v + lpb[(size_t)(t - 1) * U + u],
                  cur[u - 1] + lpe[(size_t)t * U + u - 1]);
        }
        alpha[(size_t)t * U + u] = v;
      }
      nxt[u] = v;
    }
    __syncthreads();
    float* s = cur;
    cur = nxt;
    nxt = s;
  }
}

__global__ void betas_kernel(const float* __restrict__ lpb,
                             const float* __restrict__ lpe,
                             const int* __restrict__ act_lens,
                             const int* __restrict__ label_lens,
                             float* __restrict__ beta, int T, int U) {
  extern __shared__ float col[];
  float* cur = col;
  float* nxt = col + U;
  const int b = blockIdx.x;
  const int Tb = act_lens[b];
  const int Ub = label_lens[b];
  const size_t base = (size_t)b * T * U;
  lpb += base;
  lpe += base;
  beta += base;
  // the virtual row t = T
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    cur[u] = u == Ub ? 0.f : kBlock;
  }
  __syncthreads();
  for (int d = T + U - 2; d >= 0; --d) {
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      const int t = d - u;
      float v = cur[u];                          // beta(t+1, u)
      if (t >= 0 && t < T) {
        const bool row_valid = t < Tb;
        const size_t i = (size_t)t * U + u;
        v += row_valid ? lpb[i] : 0.f;
        if (u + 1 < U) {
          const float em = (row_valid && u < Ub) ? lpe[i] : kBlock;
          v = lae(v, cur[u + 1] + em);           // beta(t, u+1)
        }
        beta[i] = v;
      }
      nxt[u] = v;
    }
    __syncthreads();
    float* s = cur;
    cur = nxt;
    nxt = s;
  }
}

__global__ void affine_rows_kernel(const float* __restrict__ a,
                                   const float* __restrict__ pb,
                                   const float* __restrict__ c,
                                   float* __restrict__ x, int T, int U,
                                   int reverse) {
  extern __shared__ float col[];
  float* cur = col;
  float* nxt = col + U;
  const size_t base = (size_t)blockIdx.x * T * U;
  a += base;
  pb += base;
  c += base;
  x += base;
  for (int u = threadIdx.x; u < U; u += blockDim.x) cur[u] = 0.f;
  __syncthreads();
  const int n_diag = T + U - 1;
  for (int k = 0; k < n_diag; ++k) {
    const int d = reverse ? n_diag - 1 - k : k;
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      const int t = d - u;
      float v = cur[u];                          // x(t -/+ 1, u)
      if (t >= 0 && t < T) {
        const int un = reverse ? u + 1 : u - 1;  // the row neighbour
        const float side = (un >= 0 && un < U) ? cur[un] : 0.f;
        const size_t i = (size_t)t * U + u;
        v = a[i] * side + pb[i] * v + c[i];
        x[i] = v;
      }
      nxt[u] = v;
    }
    __syncthreads();
    float* s = cur;
    cur = nxt;
    nxt = s;
  }
}

int threads_for(int U) {
  const int t = (U + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

}  // namespace

// lp_blank, lp_emit, alpha: [B, T, U] float32.
extern "C" int w2vs_transducer_alphas(const float* lp_blank,
                                      const float* lp_emit, float* alpha,
                                      int B, int T, int U, void* stream) {
  alphas_kernel<<<B, threads_for(U), 2 * U * sizeof(float),
                  (cudaStream_t)stream>>>(lp_blank, lp_emit, alpha, T, U);
  return (int)cudaGetLastError();
}

// lp_blank, lp_emit, beta: [B, T, U] float32; act_lens, label_lens: [B]
// int32 (T_b frames, U_b labels: the final cell is (T_b - 1, U_b)).
extern "C" int w2vs_transducer_betas(const float* lp_blank,
                                     const float* lp_emit,
                                     const int* act_lens,
                                     const int* label_lens, float* beta,
                                     int B, int T, int U, void* stream) {
  betas_kernel<<<B, threads_for(U), 2 * U * sizeof(float),
                 (cudaStream_t)stream>>>(lp_blank, lp_emit, act_lens,
                                         label_lens, beta, T, U);
  return (int)cudaGetLastError();
}

// a, pb, c, x: [B, T, U] float32; reverse 0 runs t and u upwards, 1
// downwards.
extern "C" int w2vs_transducer_affine_rows(const float* a, const float* pb,
                                           const float* c, float* x, int B,
                                           int T, int U, int reverse,
                                           void* stream) {
  affine_rows_kernel<<<B, threads_for(U), 2 * U * sizeof(float),
                       (cudaStream_t)stream>>>(a, pb, c, x, T, U, reverse);
  return (int)cudaGetLastError();
}
