// Counter-based dropout for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wav2vec_s_tpu/ops/dropout.py (_run,
// _mask_kernel), which drew its keep mask from the TPU's hardware PRNG,
// reseeded per row tile.  Here every element draws its own bits from
// Philox4x32-10 (Salmon et al. 2011, the generator cuRAND uses), keyed on
// the 64-bit step seed and counted by (flat element index / 4, site
// offset): element i takes word i % 4 of the block
//   philox(counter = (i/4 lo, i/4 hi, offset lo, offset hi), key = seed).
// The mask thus depends on (seed, offset, i) only -- not on the launch
// shape, the dtype or the tensor's width -- so the backward regenerates it
// exactly and nothing is stored, and the plain twin in ops/dropout.py
// computes the same bits in integer arithmetic.
//
// A shard of a tensor (a data-parallel rank's rows, a context-parallel
// rank's time block) draws the bits of its elements' places in the whole
// tensor: local element i has the index
//   base + (i / span_local) * span_global + i % span_local,
// span_local (span_global) the elements below the split axis in the shard
// (the whole tensor), base the whole tensor's index of the shard's first
// element.  span_local == span_global is the identity plus base; base 0 on
// top of it is the unsharded mask, bit for bit.  Where the map keeps every
// aligned group of 4 elements together (base, and both spans unless they
// are equal, multiples of 4) a thread still draws one Philox block for its
// 4 elements; elsewhere each element draws the block of its own index.  keep <=> (word >> 8) >=
// threshold, threshold = ceil(p * 2^24): the TPU kernel's "24 top bits as
// a uniform in [0, 1), keep if >= p", compared in integers so that the
// twin agrees bit for bit.  y = x * (keep ? 1/(1-p) : 0), the product in
// f32 (f64 for double), rounded once to the element type.
//
// What bounds it: memory.  One read and one write of the tensor; 10 Philox
// rounds (20 multiplies) per 4 elements is far below the card's integer
// rate at 3.35 TB/s.  Each thread takes one Philox block (4 neighbouring
// elements), a grid-stride loop covers any size; no shared memory.
//
// Plain C interface (loaded with ctypes): w2vs_dropout returns the
// cudaGetLastError() code of its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;   // Philox4x32 multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;   // key schedule (golden ratio, sqrt 3)
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kW0;
    k.y += kW1;
  }
  return c;
}

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ double load(const double* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half(v);
}

// where element i of the shard lies in the whole tensor
struct IndexMap {
  unsigned long long base;
  long long span_local, span_global;
  int grouped;               // aligned groups of 4 stay together
};

__device__ __forceinline__ unsigned long long global_index(const IndexMap& m,
                                                           long long i) {
  if (m.span_local == m.span_global) return m.base + (unsigned long long)i;
  return m.base + (unsigned long long)(i / m.span_local) * m.span_global +
         (unsigned long long)(i % m.span_local);
}

__device__ __forceinline__ uint4 philox_block(unsigned long long g, uint2 key,
                                              uint32_t off_lo,
                                              uint32_t off_hi) {
  return philox4x32_10(
      make_uint4((uint32_t)g, (uint32_t)(g >> 32), off_lo, off_hi), key);
}

template <typename T>
__global__ void dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                               long long n, uint2 key, uint32_t off_lo,
                               uint32_t off_hi, uint32_t threshold,
                               typename Acc<T>::type scale, IndexMap map) {
  using A = typename Acc<T>::type;
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long first = g * 4;
    uint32_t w[4];
    if (map.grouped) {
      const uint4 r =
          philox_block(global_index(map, first) >> 2, key, off_lo, off_hi);
      w[0] = r.x;
      w[1] = r.y;
      w[2] = r.z;
      w[3] = r.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned long long gi = global_index(map, first + j);
        const uint4 r = philox_block(gi >> 2, key, off_lo, off_hi);
        const int k = (int)(gi & 3);
        w[j] = k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = first + j;
      if (i < n) {
        const A keep = (w[j] >> 8) >= threshold ? scale : A(0);
        store(y + i, load(x + i) * keep);
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, uint64_t seed,
           uint64_t offset, uint32_t threshold, double scale,
           const IndexMap& map, cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  dropout_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)x, (T*)y, n, key, (uint32_t)offset,
      (uint32_t)(offset >> 32), threshold,
      (typename Acc<T>::type)scale, map);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: n contiguous elements on the current device (y may be x).
// dtype_code 0 float32, 1 bfloat16, 2 float16, 3 float64.  base,
// span_local, span_global: the index map of a shard (span_local ==
// span_global and base 0 for a whole tensor); span_local > 0.
extern "C" int w2vs_dropout(const void* x, void* y, long long n,
                            unsigned long long seed,
                            unsigned long long offset, unsigned threshold,
                            double scale, int dtype_code,
                            unsigned long long base, long long span_local,
                            long long span_global, void* stream) {
  if (span_local < 1 || span_global < span_local) {
    return (int)cudaErrorInvalidValue;
  }
  const bool same = span_local == span_global;
  const IndexMap map = {base, span_local, span_global,
                        base % 4 == 0 &&
                            (same || (span_local % 4 == 0 &&
                                      span_global % 4 == 0))};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype_code) {
    case 1:
      return launch<__nv_bfloat16>(x, y, n, seed, offset, threshold, scale,
                                   map, s);
    case 2:
      return launch<__half>(x, y, n, seed, offset, threshold, scale, map, s);
    case 3:
      return launch<double>(x, y, n, seed, offset, threshold, scale, map, s);
    default:
      return launch<float>(x, y, n, seed, offset, threshold, scale, map, s);
  }
}
