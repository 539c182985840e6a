// A measuring aid, not a kernel of any path and not part of the kernel
// library: the time of ONE dependent step of the lattice recursions, with
// nothing else around it, and the time of one device-memory round trip.
//
// The lattice kernels are bound by latency: T + U - 1 anti-diagonals, each
// a log-add-exp (expf and log1pf) per cell for alpha and beta, a fused
// multiply-add pair for the affine rows, or both for the fused walks.  The
// probe runs that step `steps` times with no global read inside the loop,
// so time / steps is the latency of one step:
// - the block set's step (csrc/transducer.cu): the newest column heads in
//   shared memory, a block barrier per step, a block of the same size;
// - the warp set's step (`shuffle` not 0; csrc/transducer_warp.cu): one
//   warp per lattice, every lane holding ceil(U / 32) consecutive column
//   heads in registers, the head below a lane's first one passed by ONE
//   warp shuffle per step, no shared memory and no block barrier, and the
//   walks' own log-add-exp (csrc/lattice_math.cuh: log1pf's arithmetic
//   without its branch) (U <= 256, as the warp set);
//   `kind` 2 is the fused walks' step: one log-add-exp, the two transition
//   probabilities (two expf) and one affine update per cell, two shuffles.
// chip_smoke.py prints (T + U - 1) times the least of these steps (the warp
// step at one cell per lane, U <= 32, and at the lattice's U; the block
// set's step) as the bound of each recursion on this card, beside the
// kernels' device times.
//
// w2vs_load_chain_probe walks a chain of dependent global loads (each
// address read from the load before), so time / loads is one round trip to
// wherever the chain lies (L2 or device memory, by its size): what a step
// would wait if it read its inputs on the dependent chain.
//
// chip_smoke.py compiles this file into a shared library of its own.  Plain
// C interface (loaded with ctypes): each function returns the
// cudaGetLastError() code of its launch, or -1 for a shape or kind the asked
// variant does not take.

#include <cuda_runtime.h>
#include <math.h>

#include "../csrc/lattice_math.cuh"

namespace {

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void lattice_step_probe_kernel(float* __restrict__ out, int U,
                                          int steps, int affine, float c) {
  extern __shared__ float col[];               // 2 x U: column heads
  float* cur = col;
  float* nxt = col + U;
  for (int u = threadIdx.x; u < U; u += blockDim.x) cur[u] = -(float)u;
  __syncthreads();
  for (int d = 0; d < steps; ++d) {
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      float v = cur[u];
      if (u > 0) {
        v = affine ? c * cur[u - 1] + c * v + c : lae(v + c, cur[u - 1] + c);
      }
      nxt[u] = v;
    }
    __syncthreads();
    float* s = cur;
    cur = nxt;
    nxt = s;
  }
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    out[(size_t)blockIdx.x * U + u] = cur[u];
  }
}

// The step without shared memory and without a barrier: lane l holds the
// heads u = l * PER .. l * PER + PER - 1.  Elements update from the top one
// down, so each reads its lower neighbour's value of the step before.
// KIND 0: log-add-exp; 1: affine; 2: the fused walks' step.
template <int PER, int KIND>
__global__ void lattice_step_probe_shfl_kernel(float* __restrict__ out, int U,
                                               int steps, float c) {
  const int lane = threadIdx.x;
  float v[PER], x[PER];
  bool live[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int u = lane * PER + e;
    v[e] = -(float)u;
    x[e] = (float)u;
    live[e] = u > 0 && u < U;
  }
  for (int d = 0; d < steps; ++d) {
    const float below = __shfl_up_sync(0xffffffffu, v[PER - 1], 1);
    const float xbelow =
        KIND == 2 ? __shfl_up_sync(0xffffffffu, x[PER - 1], 1) : 0.f;
    // straight-line code over the lane's elements, stage by stage as the
    // walks have it (w2vs_lattice::lae), so that their updates overlap:
    // each is computed, then kept or dropped by a select
    float lo[PER], nv[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) lo[e] = e > 0 ? v[e - 1] : below;
    if (KIND == 1) {
#pragma unroll
      for (int e = 0; e < PER; ++e) nv[e] = c * lo[e] + c * v[e] + c;
    } else {
      float arg_b[PER], arg_e[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        arg_b[e] = v[e] + c;
        arg_e[e] = lo[e] + c;
      }
      w2vs_lattice::lae(arg_b, arg_e, nv);
      if (KIND == 2) {
        float nx[PER];
#pragma unroll
        for (int e = 0; e < PER; ++e) {
          const float pe = expf(fminf(arg_e[e] - nv[e], 0.f));
          const float pb = expf(fminf(arg_b[e] - nv[e], 0.f));
          const float xs = e > 0 ? x[e - 1] : xbelow;
          nx[e] = pe * xs + pb * x[e] + pe * c;
        }
#pragma unroll
        for (int e = 0; e < PER; ++e) x[e] = live[e] ? nx[e] : x[e];
      }
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) v[e] = live[e] ? nv[e] : v[e];
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int u = lane * PER + e;
    if (u < U) out[(size_t)blockIdx.x * U + u] = v[e] + x[e];
  }
}

template <int PER>
void launch_shfl(float* out, int B, int U, int steps, int kind, float c,
                 cudaStream_t stream) {
  if (kind == 2) {
    lattice_step_probe_shfl_kernel<PER, 2><<<B, 32, 0, stream>>>(
        out, U, steps, c);
  } else if (kind == 1) {
    lattice_step_probe_shfl_kernel<PER, 1><<<B, 32, 0, stream>>>(
        out, U, steps, c);
  } else {
    lattice_step_probe_shfl_kernel<PER, 0><<<B, 32, 0, stream>>>(
        out, U, steps, c);
  }
}

// One thread follows next[] from `start` for `loads` dependent loads.
__global__ void load_chain_kernel(const int* __restrict__ next, int start,
                                  int loads, int* __restrict__ out) {
  int j = start;
  for (int n = 0; n < loads; ++n) j = next[j];
  out[0] = j;
}

}  // namespace

// out: [B, U] float32.  B blocks of min(1024, U rounded up to a warp)
// threads (the block set's launch shape) take `steps` steps each:
// log-add-exp steps (`kind` 0), affine ones (1) or, with `shuffle` only,
// the fused walks' steps (2); `c` is the constant they combine with (a
// run-time value, so nothing folds).  With `shuffle` not 0: B blocks of one
// warp, the register-and-shuffle step.
extern "C" int w2vs_lattice_step_probe(float* out, int B, int U, int steps,
                                       int kind, float c, int shuffle,
                                       void* stream) {
  if (shuffle) {
    cudaStream_t st = (cudaStream_t)stream;
    switch ((U + 31) / 32) {
      case 1: launch_shfl<1>(out, B, U, steps, kind, c, st); break;
      case 2: launch_shfl<2>(out, B, U, steps, kind, c, st); break;
      case 3: launch_shfl<3>(out, B, U, steps, kind, c, st); break;
      case 4: launch_shfl<4>(out, B, U, steps, kind, c, st); break;
      case 5: launch_shfl<5>(out, B, U, steps, kind, c, st); break;
      case 6: launch_shfl<6>(out, B, U, steps, kind, c, st); break;
      case 7: launch_shfl<7>(out, B, U, steps, kind, c, st); break;
      case 8: launch_shfl<8>(out, B, U, steps, kind, c, st); break;
      default: return -1;
    }
    return (int)cudaGetLastError();
  }
  if (kind == 2) return -1;
  const int affine = kind;
  int threads = (U + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  lattice_step_probe_kernel<<<B, threads, 2 * U * sizeof(float),
                              (cudaStream_t)stream>>>(out, U, steps, affine,
                                                      c);
  return (int)cudaGetLastError();
}

// next: a chain of int32 indices on the device; out: one int32.
extern "C" int w2vs_load_chain_probe(const int* next, int start, int loads,
                                     int* out, void* stream) {
  load_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, start, loads,
                                                        out);
  return (int)cudaGetLastError();
}
