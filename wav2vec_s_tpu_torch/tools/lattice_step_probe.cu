// A measuring aid, not a kernel of any path and not part of the kernel
// library: the time of ONE dependent step of the lattice recursions as
// csrc/transducer.cu is designed today, with nothing else around it.
//
// The lattice kernels are bound by latency: T + U - 1 anti-diagonals, each
// of which reads the newest column heads from shared memory, combines two of
// them (one log-add-exp with expf and log1pf for alpha and beta, one fused
// multiply-add pair for the affine rows), writes the result back and meets
// the block at a barrier.  This kernel runs exactly that step `steps` times
// on a block of the same size, with no global read inside the loop, so
// time / steps is the step latency of the present design (shared memory +
// block barrier).  It is no floor of the card, so a second variant runs the
// step a redesign would have: one warp per lattice, every lane holding
// ceil(U / 32) consecutive column heads in registers, the head below a
// lane's first one passed by ONE warp shuffle per step, no shared memory
// and no block barrier (`shuffle` not 0; U <= 256).  chip_smoke.py prints
// both beside the kernels' device times: (T + U - 1) times the shuffle step
// is the bound of the recursion on this card, (T + U - 1) times the barrier
// step what the present design can reach.
//
// chip_smoke.py compiles this file into a shared library of its own.  Plain
// C interface (loaded with ctypes): w2vs_lattice_step_probe returns the
// cudaGetLastError() code of its launch, or -1 for a shape the asked
// variant does not take.

#include <cuda_runtime.h>
#include <math.h>

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
template <int PER, bool AFFINE>
__global__ void lattice_step_probe_shfl_kernel(float* __restrict__ out, int U,
                                               int steps, float c) {
  const int lane = threadIdx.x;
  float v[PER];
  bool live[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int u = lane * PER + e;
    v[e] = -(float)u;
    live[e] = u > 0 && u < U;
  }
  for (int d = 0; d < steps; ++d) {
    const float below = __shfl_up_sync(0xffffffffu, v[PER - 1], 1);
    // straight-line code over the lane's elements, so that their updates
    // overlap: each is computed, then kept or dropped by a select
#pragma unroll
    for (int e = PER - 1; e >= 0; --e) {
      const float lo = e > 0 ? v[e - 1] : below;
      const float nv = AFFINE ? c * lo + c * v[e] + c : lae(v[e] + c, lo + c);
      v[e] = live[e] ? nv : v[e];
    }
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int u = lane * PER + e;
    if (u < U) out[(size_t)blockIdx.x * U + u] = v[e];
  }
}

template <int PER>
void launch_shfl(float* out, int B, int U, int steps, int affine, float c,
                 cudaStream_t stream) {
  if (affine) {
    lattice_step_probe_shfl_kernel<PER, true><<<B, 32, 0, stream>>>(
        out, U, steps, c);
  } else {
    lattice_step_probe_shfl_kernel<PER, false><<<B, 32, 0, stream>>>(
        out, U, steps, c);
  }
}

}  // namespace

// out: [B, U] float32.  B blocks of min(1024, U rounded up to a warp)
// threads (the lattice kernels' launch shape) take `steps` steps each:
// log-add-exp steps, or affine ones when `affine` is not 0; `c` is the
// constant they combine with (a run-time value, so nothing folds).  With
// `shuffle` not 0: B blocks of one warp, the register-and-shuffle step.
extern "C" int w2vs_lattice_step_probe(float* out, int B, int U, int steps,
                                       int affine, float c, int shuffle,
                                       void* stream) {
  if (shuffle) {
    cudaStream_t st = (cudaStream_t)stream;
    switch ((U + 31) / 32) {
      case 1: launch_shfl<1>(out, B, U, steps, affine, c, st); break;
      case 2: launch_shfl<2>(out, B, U, steps, affine, c, st); break;
      case 3: launch_shfl<3>(out, B, U, steps, affine, c, st); break;
      case 4: launch_shfl<4>(out, B, U, steps, affine, c, st); break;
      case 5: launch_shfl<5>(out, B, U, steps, affine, c, st); break;
      case 6: launch_shfl<6>(out, B, U, steps, affine, c, st); break;
      case 7: launch_shfl<7>(out, B, U, steps, affine, c, st); break;
      case 8: launch_shfl<8>(out, B, U, steps, affine, c, st); break;
      default: return -1;
    }
    return (int)cudaGetLastError();
  }
  int threads = (U + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  lattice_step_probe_kernel<<<B, threads, 2 * U * sizeof(float),
                              (cudaStream_t)stream>>>(out, U, steps, affine,
                                                      c);
  return (int)cudaGetLastError();
}
