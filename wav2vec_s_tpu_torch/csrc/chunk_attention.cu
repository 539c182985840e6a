// Incremental-chunk attention over a time-major K/V cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wav2vec_s_tpu/ops/chunk_attention.py
// (chunk_cache_attention, _kernel).  For every stream b, head h and each of
// the R query rows of a chunk (q pre-scaled by Dh**-0.5):
//   logits = [ q . k_cache[t]          for the committed rows t < t0 ;
//              q . k_new[j] + bias[r,j] for the chunk's own R rows      ]
//   out    = softmax(logits) . [v_cache[:t0] ; v_new]
// with one shared max and a 1 / max(l, 1e-20) normalisation, all in f32;
// neither the logits nor the probabilities ever reach device memory.
//
// What bounds it: memory, in principle.  A cached (key, value) pair is 4*Dh
// bytes in bf16 and serves R*Dh multiply-adds for q.k plus R*Dh for p.v:
// about R flops per byte (48 at R = 48, the ds2 main path), far below the
// ~295 flops per byte at which an H100 stops being bound by its memory.  The
// cache is TIME-MAJOR [T_cap, B, D]: the key row of (t, b, h) is Dh
// contiguous elements (128 bytes in bf16 at Dh=64) at a stride of B*D
// elements per time step.
//
// What the design does about it:
// - only the t0 committed rows are read (the TPU kernel streamed the whole
//   [kv_cap] slice and masked it); skipping the masked rows is exact, since
//   they would contribute exp(-1e9 - m) == 0 in f32;
// - one block per (32-row tile, head, stream) stages its query rows once in
//   shared memory, then walks the cache in tiles of 64 key rows (each row a
//   contiguous 128-byte read) and ends with the chunk's own keys plus the
//   intra-chunk bias, under an online softmax held in registers;
// - the products run on the CUDA cores in f32, register-blocked: each lane
//   scores 2 keys against its warp's 4 rows (8 FMAs per one broadcast
//   16-byte q load and one 8-byte k load from the transposed K tile), and
//   accumulates 4 rows x 2 output dims per (broadcast p, 8-byte v) pair.
//   A first version that scored one row at a time needed two shared-memory
//   loads per FMA and was bound by them (see PERF.md).
// wgmma/TMA are later work.
//
// Plain C interface (loaded with ctypes): w2vs_chunk_attention returns the
// cudaGetLastError() code of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;                         // warps per block
constexpr int kRowsPerWarp = 4;                   // query rows per warp
constexpr int kRows = kWarps * kRowsPerWarp;      // query rows per block
constexpr int kTile = 64;                         // key rows per tile (2 per lane)
constexpr int kKStride = kTile + 2;               // transposed K row (even)
constexpr int kMaxDh = 128;                       // 2 float2 of dims per lane
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRowsPerWarp == 4, "p_s and q_t hold one float4 of rows");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Shared-memory layout, in floats (each part keeps the alignment its vector
// loads need):
//   p_s [kWarps][kTile][kRowsPerWarp]  probabilities, float4 per key
//   q_t [dh][kRows]                    query rows, transposed, float4 per d
//   k_t [dh][kKStride]                 key tile, transposed, float2 per d
//   v_s [kTile][dv]                    value tile, float2 per key (dv even)
__host__ __device__ constexpr int smem_floats(int dh, int dv) {
  return kWarps * kTile * kRowsPerWarp + dh * kRows + dh * kKStride +
         kTile * dv;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
chunk_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                       const T* __restrict__ v_cache,
                       const T* __restrict__ k_new,
                       const T* __restrict__ v_new,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int B, int R, int D, int dh, int t0) {
  extern __shared__ float4 smem4[];
  const int dv = (dh + 1) & ~1;
  float* p_s = reinterpret_cast<float*>(smem4);
  float* q_t = p_s + kWarps * kTile * kRowsPerWarp;
  float* k_t = q_t + dh * kRows;
  float* v_s = k_t + dh * kKStride;

  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long head = (long)h * dh;
  const long cache_stride = (long)B * D;   // one time step of the cache
  const int n_q = min(kRows, R - r0);

  // query rows, transposed; rows past R are zero (scored, never stored)
  for (int i = threadIdx.x; i < kRows * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh;
    q_t[d * kRows + r] =
        r < n_q ? to_float(q[((long)b * R + r0 + r) * D + head + d]) : 0.f;
  }

  const int wr = warp * kRowsPerWarp;      // the warp's first row in the tile
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }

  // key tiles: the committed cache rows [0, t0), then the chunk rows [0, R)
  const int n_cache_tiles = (t0 + kTile - 1) / kTile;
  const int n_tiles = n_cache_tiles + (R + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool intra = tile >= n_cache_tiles;
    const int j0 = (intra ? tile - n_cache_tiles : tile) * kTile;
    const int n_k = min(kTile, (intra ? R : t0) - j0);   // >= 1
    const T* k_src = intra ? k_new + ((long)b * R + j0) * D + head
                           : k_cache + (long)j0 * cache_stride + (long)b * D +
                                 head;
    const T* v_src = intra ? v_new + ((long)b * R + j0) * D + head
                           : v_cache + (long)j0 * cache_stride + (long)b * D +
                                 head;
    const long src_stride = intra ? D : cache_stride;
    __syncthreads();                     // the previous tile is consumed
    for (int i = threadIdx.x; i < n_k * dh; i += blockDim.x) {
      const int j = i / dh, d = i - j * dh;
      k_t[d * kKStride + j] = to_float(k_src[j * src_stride + d]);
      v_s[j * dv + d] = to_float(v_src[j * src_stride + d]);
    }
    __syncthreads();

    // scores: rows wr..wr+3 against keys 2*lane, 2*lane+1 of the tile
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(q_t + d * kRows + wr);
      const float2 kv =
          *reinterpret_cast<const float2*>(k_t + d * kKStride + 2 * lane);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        s[i][0] = fmaf(qr[i], kv.x, s[i][0]);
        s[i][1] = fmaf(qr[i], kv.y, s[i][1]);
      }
    }

    float4* p4 = reinterpret_cast<float4*>(p_s) + warp * kTile;
    float p[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = wr + i;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = 2 * lane + c;
        float v = -INFINITY;             // no key: exp(-inf - m) == 0
        if (j < n_k) {
          v = s[i][c];
          if (intra && r < n_q) v += bias[(long)(r0 + r) * R + j0 + j];
        }
        s[i][c] = v;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);   // 0 on the first tile
      p[i][0] = expf(s[i][0] - m_new);
      p[i][1] = expf(s[i][1] - m_new);
      l[i] = l[i] * alpha + warp_sum(p[i][0] + p[i][1]);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      p4[2 * lane + c] = make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
    }
    __syncwarp();

    // P.V: lane owns dims 2*lane + {0, 1} and 64 + 2*lane + {0, 1}
    const bool lo = 2 * lane < dh, hi = 64 + 2 * lane < dh;
    for (int j = 0; j < n_k; ++j) {
      const float4 pj = p4[j];
      const float pr[4] = {pj.x, pj.y, pj.z, pj.w};
      const float* vr = v_s + j * dv + 2 * lane;
      if (lo) {
        const float2 v2 = *reinterpret_cast<const float2*>(vr);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          acc[i][0] = fmaf(pr[i], v2.x, acc[i][0]);
          acc[i][1] = fmaf(pr[i], v2.y, acc[i][1]);
        }
      }
      if (hi) {
        const float2 v2 = *reinterpret_cast<const float2*>(vr + 64);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          acc[i][2] = fmaf(pr[i], v2.x, acc[i][2]);
          acc[i][3] = fmaf(pr[i], v2.y, acc[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = wr + i;
    if (r < n_q) {
      const float inv = 1.f / fmaxf(l[i], 1e-20f);
      T* o = out + ((long)b * R + r0 + r) * D + head;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 2 * lane + (e & 1) + 64 * (e >> 1);
        if (d < dh) store(o + d, acc[i][e] * inv);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_new, const void* v_new, const float* bias, void* out,
           int B, int R, int D, int H, int t0, cudaStream_t stream) {
  const int dh = D / H;
  if (dh > kMaxDh) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(dh, (dh + 1) & ~1) * sizeof(float);
  auto kernel = chunk_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dim3 grid((R + kRows - 1) / kRows, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k_cache, (const T*)v_cache, (const T*)k_new,
      (const T*)v_new, bias, (T*)out, B, R, D, dh, t0);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k_new, v_new, out: [B, R, D]; k_cache, v_cache: [>= t0, B, D];
// bias: [R, R] f32; all contiguous, on the current device.  dtype_code 0 is
// float32, 1 is bfloat16.
extern "C" int w2vs_chunk_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* k_new,
                                    const void* v_new, const float* bias,
                                    void* out, int B, int R, int D, int H,
                                    int t0, int dtype_code, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype_code == 1) {
    return launch<__nv_bfloat16>(q, k_cache, v_cache, k_new, v_new, bias, out,
                                 B, R, D, H, t0, s);
  }
  return launch<float>(q, k_cache, v_cache, k_new, v_new, bias, out, B, R, D,
                       H, t0, s);
}
