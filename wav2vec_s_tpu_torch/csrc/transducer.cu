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
//                         backward;
//   alphas_delay_kernel,
//   betas_delay_kernel <- pallas_alphas / pallas_betas followed by
//                         pallas_expected_delay(_bwd): the fused walks that
//                         the loss runs past the warp set's U (the warp set,
//                         csrc/transducer_warp.cu, has its own).
// All of them work on [B, T, U] float32 lattices (T source steps, U label
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
// The fused walks carry the expected delay beside alpha (beta) in a second
// pair of shared-memory heads.  Past U 256 |alpha| reaches ~2000, where one
// float32 rounding is ~1e-4 absolute: the unfused sequence they replace
// (alphas_kernel, the transition probabilities exp(arg - alpha(t,u)) formed
// from the stored alpha, affine_rows_kernel) put the expected delay 10x
// further from float64 than the plain f32 computation, whose prefix form
// keeps the large emission sums out of the within-row differences (PERF.md,
// Findings).  So the fused walks
// - keep the heads (alpha or beta, and the delay) in float64, and add in
//   float64; only exp and log1p of the small difference of a cell's two
//   arguments run in float32, each a rounding of a value below 1;
// - form the cell's transition probabilities from the arguments of its
//   log-add-exp (a = blank argument, b = emit argument, x = exp(-|a - b|)):
//     p(larger) = 1 / (1 + x),  p(smaller) = x / (1 + x),
//   which sum to 1 within a float32 rounding;
// - store alpha (beta) and the delay rounded once to float32.
// Their alpha and beta are thus closer to float64 than alphas_kernel's and
// betas_kernel's (which keep the float32 recursion of the warp set, bit for
// bit), and differ from them in the last places.
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

// log(exp(a) + exp(b)) in float64 around float32 exp / log1p of the
// difference, and the two normalised transition probabilities: *pa of the
// edge with argument a, *pb of b.
__device__ __forceinline__ double lae_split(double a, double b, float* pa,
                                            float* pb) {
  const float x = expf(-(float)fabs(a - b));
  const float big = 1.f / (1.f + x), small = x * big;
  *pa = a >= b ? big : small;
  *pb = a >= b ? small : big;
  return fmax(a, b) + (double)log1pf(x);
}

// the fused walks' float64 heads: 4 x U doubles of shared memory
constexpr int kMaxFusedU = 48 * 1024 / (4 * (int)sizeof(double));

__device__ __forceinline__ int length_at(const void* p, int is64, int b) {
  return is64 ? (int)static_cast<const long long*>(p)[b]
              : static_cast<const int*>(p)[b];
}

// alpha and the expected delay ad (ops/transducer/lattice.py:
// expected_delay): ad(t,u) = pe ad(t,u-1) + pb ad(t-1,u) + pe dv(t,u), with
// pe = 1 on row 0 (u > 0), pb = 1 in column 0 (t > 0).  dv at element
// strides (st, su) from the utterance's base.
__global__ void alphas_delay_kernel(const float* __restrict__ lpb,
                                    const float* __restrict__ lpe,
                                    const float* __restrict__ dv,
                                    long long sb, long long st, long long su,
                                    float* __restrict__ alpha,
                                    float* __restrict__ ad, int T, int U) {
  extern __shared__ double dcol[];             // 2 x U alpha, 2 x U ad
  double* cur = dcol;
  double* nxt = dcol + U;
  double* xcur = dcol + 2 * U;
  double* xnxt = dcol + 3 * U;
  const size_t base = (size_t)blockIdx.x * T * U;
  lpb += base;
  lpe += base;
  alpha += base;
  ad += base;
  dv += blockIdx.x * sb;
  for (int u = threadIdx.x; u < U; u += blockDim.x) cur[u] = xcur[u] = 0.0;
  __syncthreads();
  for (int d = 0; d < T + U - 1; ++d) {
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      const int t = d - u;
      double v = cur[u], x = xcur[u];            // (t-1, u)
      if (t >= 0 && t < T) {
        float pe, pb;
        if (t == 0) {
          v = u == 0 ? 0.0 : cur[u - 1] + (double)lpe[u - 1];
          pe = u == 0 ? 0.f : 1.f;
          pb = 0.f;
        } else if (u == 0) {
          v = v + (double)lpb[(size_t)(t - 1) * U];
          pe = 0.f;
          pb = 1.f;
        } else {
          v = lae_split(v + (double)lpb[(size_t)(t - 1) * U + u],
                        cur[u - 1] + (double)lpe[(size_t)t * U + u - 1], &pb,
                        &pe);
        }
        const double side = u > 0 ? xcur[u - 1] : 0.0;
        x = (double)pe * (side + (double)dv[t * st + u * su]) +
            (double)pb * x;
        alpha[(size_t)t * U + u] = (float)v;
        ad[(size_t)t * U + u] = (float)x;
      }
      nxt[u] = v;
      xnxt[u] = x;
    }
    __syncthreads();
    double* s = cur;
    cur = nxt;
    nxt = s;
    s = xcur;
    xcur = xnxt;
    xnxt = s;
  }
}

// beta and the expected remaining delay bd (lattice.py:expected_delay_bwd):
// bd(t,u) = pe' (bd(t,u+1) + dv(t,u+1)) + pb' bd(t+1,u), pe' 0 where the
// emit is not allowed (u >= U_b or t >= T_b), on the virtually extended
// lattice of betas_kernel.
__global__ void betas_delay_kernel(const float* __restrict__ lpb,
                                   const float* __restrict__ lpe,
                                   const void* act_lens, int act64,
                                   const void* label_lens, int label64,
                                   const float* __restrict__ dv,
                                   long long sb, long long st, long long su,
                                   float* __restrict__ beta,
                                   float* __restrict__ bd, int T, int U) {
  extern __shared__ double dcol[];
  double* cur = dcol;
  double* nxt = dcol + U;
  double* xcur = dcol + 2 * U;
  double* xnxt = dcol + 3 * U;
  const int b = blockIdx.x;
  const int Tb = length_at(act_lens, act64, b);
  const int Ub = length_at(label_lens, label64, b);
  const size_t base = (size_t)b * T * U;
  lpb += base;
  lpe += base;
  beta += base;
  bd += base;
  dv += b * sb;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    cur[u] = u == Ub ? 0.0 : (double)kBlock;     // the virtual row t = T
    xcur[u] = 0.0;
  }
  __syncthreads();
  for (int d = T + U - 2; d >= 0; --d) {
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      const int t = d - u;
      double v = cur[u], x = xcur[u];            // (t+1, u)
      if (t >= 0 && t < T) {
        const bool row_valid = t < Tb;
        const size_t i = (size_t)t * U + u;
        v += row_valid ? (double)lpb[i] : 0.0;
        float pe = 0.f, pb = 1.f;
        double side = 0.0;
        if (u + 1 < U) {
          const bool emit_ok = row_valid && u < Ub;
          const float em = emit_ok ? lpe[i] : kBlock;
          float qe;
          v = lae_split(v, cur[u + 1] + (double)em, &pb, &qe);  // (t, u+1)
          pe = emit_ok ? qe : 0.f;
          side = xcur[u + 1] + (double)dv[t * st + (u + 1) * su];
        }
        x = (double)pe * side + (double)pb * x;
        beta[i] = (float)v;
        bd[i] = (float)x;
      }
      nxt[u] = v;
      xnxt[u] = x;
    }
    __syncthreads();
    double* s = cur;
    cur = nxt;
    nxt = s;
    s = xcur;
    xcur = xnxt;
    xnxt = s;
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

// The forward fused walk: alpha and the expected delay ad, [B, T, U]
// float32 contiguous; delay_values [B, T, U] float32 at element strides
// (sb, st, su).  The signature of w2vs_lattice_warp_alphas_delay.
extern "C" int w2vs_transducer_alphas_delay(
    const float* lp_blank, const float* lp_emit, const float* delay_values,
    long long sb, long long st, long long su, float* alpha, float* ad, int B,
    int T, int U, void* stream) {
  if (U > kMaxFusedU) return (int)cudaErrorInvalidValue;
  alphas_delay_kernel<<<B, threads_for(U), 4 * U * sizeof(double),
                        (cudaStream_t)stream>>>(lp_blank, lp_emit,
                                                delay_values, sb, st, su,
                                                alpha, ad, T, U);
  return (int)cudaGetLastError();
}

// The reverse fused walk: beta and the expected remaining delay bd; lengths
// [B] int32 or int64 (act64 / label64 not 0) on the device.  The signature
// of w2vs_lattice_warp_betas_delay.
extern "C" int w2vs_transducer_betas_delay(
    const float* lp_blank, const float* lp_emit, const void* act_lens,
    int act64, const void* label_lens, int label64,
    const float* delay_values, long long sb, long long st, long long su,
    float* beta, float* bd, int B, int T, int U, void* stream) {
  if (U > kMaxFusedU) return (int)cudaErrorInvalidValue;
  betas_delay_kernel<<<B, threads_for(U), 4 * U * sizeof(double),
                       (cudaStream_t)stream>>>(
      lp_blank, lp_emit, act_lens, act64, label_lens, label64, delay_values,
      sb, st, su, beta, bd, T, U);
  return (int)cudaGetLastError();
}
