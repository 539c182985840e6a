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
// block barrier), and (T + U - 1) times it is what chip_smoke.py prints
// beside the kernels' device times.  It is no floor of the card: at U <= 64
// a step that passes the heads by warp shuffles, with no barrier, would be
// shorter, and a redesign is to be held against its own step.
//
// chip_smoke.py compiles this file into a shared library of its own.  Plain
// C interface (loaded with ctypes): w2vs_lattice_step_probe returns the
// cudaGetLastError() code of its launch.

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

}  // namespace

// out: [B, U] float32.  B blocks of min(1024, U rounded up to a warp)
// threads (the lattice kernels' launch shape) take `steps` steps each:
// log-add-exp steps, or affine ones when `affine` is not 0; `c` is the
// constant they combine with (a run-time value, so nothing folds).
extern "C" int w2vs_lattice_step_probe(float* out, int B, int U, int steps,
                                       int affine, float c, void* stream) {
  int threads = (U + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  lattice_step_probe_kernel<<<B, threads, 2 * U * sizeof(float),
                              (cudaStream_t)stream>>>(out, U, steps, affine,
                                                      c);
  return (int)cudaGetLastError();
}
