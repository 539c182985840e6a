// Shared pieces of the block-sparse flash-attention kernels.  Used by both
// sets of kernels: the block layout rule and the attention-dropout mask
// (Philox on the element's coordinates).  Used by the CUDA-core set only
// (forward in flash_attention.cu, backward in flash_attention_bwd.cu): the
// 32 x 64 tile geometry and the register-blocked f32 products below.  The
// tensor-core set (flash_attention_mma.cu, flash_attention_bwd_mma.cu) keeps
// its geometry, fragments and staging in flash_mma.cuh.
//
// Geometry of the CUDA-core kernels.  They are bound by f32 FMA throughput
// and by shared-memory reads, so each value read from shared memory is used
// 4 or 2 times from registers: a block of kWarps warps owns kRows = 32
// "rows" (4 per warp) and walks "tiles" of kTile = 64 "columns" (2 per
// lane).  In the forward and in the dQ kernel rows are queries and columns
// keys; in the dK/dV kernel rows are keys and columns queries.  Row
// operands (f32 copies of the inputs, whatever their type) sit in shared memory
// transposed, [dh][kRows], so that one float4 holds a warp's 4 rows of one
// dim; a tile sits there transposed, [dh][kKStride] (float2 = a lane's 2
// columns), and/or row-major, [kTile][dv] (float2 = a lane's 2 dims).
//
// Attention dropout.  The keep mask is a function of absolute coordinates:
// element (b, h, q, k) of the [B, H, S, S] probabilities has the flat index
// i = ((b*H_all + h)*S + q)*S + k and takes word i % 4 of
//   philox4x32_10(counter = (i/4 lo, i/4 hi, offset lo, offset hi),
//                 key = seed),
// keep <=> (word >> 8) >= threshold, kept probabilities scaled by
// 1/(1 - rate): exactly the scheme of dropout.cu applied to the
// probabilities tensor that never exists.  A shard places itself in the
// whole batch's [B_all, H_all, S, S] probabilities: H_all (`heads`) is the
// whole head count (H unsharded, H * tp for a tensor-parallel rank's H
// heads) and base = (b0*H_all + h0)*S*S the index of its element
// (0, 0, 0, 0), for a shard whose first row is row b0 and first head head
// h0 of the whole; base is added to every i: its masks are the matching
// part of the whole batch's.  Any tiling regenerates the same
// bits, so the forward and both backward kernels agree, the plain twin
// builds the mask with ops/dropout.keep_mask, and flash training equals
// dense training (which drops the materialised probabilities through
// dropout.cu at the same site offset) under one seed.  When S % 4 == 0 a
// Philox block never straddles a row end, and one block serves 4
// neighbouring keys of a query: 2 lanes share it in the row-major kernels,
// one lane's 4 key rows take it whole in the CUDA-core dK/dV kernel, 4 lanes
// exchange its keep bits in the tensor-core one (flash_mma.cuh).  Otherwise
// each element draws its own block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace w2vs_flash {

constexpr int kWarps = 8;                         // warps per block
constexpr int kRowsPerWarp = 4;                   // rows per warp
constexpr int kRows = kWarps * kRowsPerWarp;      // rows per block (32)
constexpr int kTile = 64;                         // columns per tile
constexpr int kKStride = kTile + 2;               // transposed tile row (even)
constexpr int kMaxDh = 128;                       // 2 float2 of dims per lane
constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRowsPerWarp == 4, "one float4 holds a warp's rows");

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

// dynamic shared memory above 48 KB is opted in per kernel; the CUDA error
// of the call, 0 if none was needed
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---- the block layout rule (wav2vec_s_tpu/ops/block_mask.py:40-80) --------

// effective block of query index r: a copy row counts in its block
__device__ __forceinline__ int query_block(int r, int T_frames, int mc,
                                           int rc) {
  return (r < T_frames || rc == 0) ? r / mc : (r - T_frames) / rc;
}
// block of key index j (copy keys exist only when rc > 0)
__device__ __forceinline__ int key_block(int j, int T_frames, int mc, int rc) {
  return j >= T_frames ? (j - T_frames) / rc : j / mc;
}
__device__ __forceinline__ bool pair_allowed(int q_blk, int k_blk,
                                             bool key_is_copy) {
  return key_is_copy ? q_blk == k_blk : q_blk >= k_blk;
}

// ---- attention dropout ----------------------------------------------------

struct Dropout {
  uint2 key;            // the step seed
  uint32_t off_lo, off_hi;   // the site offset
  unsigned long long base;   // flat index of element (0, 0, 0, 0)
  int heads;            // heads of the whole probabilities (the b stride)
  uint32_t threshold;   // ceil(rate * 2^24)
  float scale;          // 1 / (1 - rate)
};

// the C entry points' dropout arguments (threshold 0: none)
inline Dropout make_dropout(unsigned long long seed, unsigned long long offset,
                            unsigned long long base, int heads,
                            unsigned threshold, double keep_scale) {
  return {make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)), (uint32_t)offset,
          (uint32_t)(offset >> 32), base, heads, threshold, (float)keep_scale};
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// the Philox block of flat elements 4g .. 4g+3 of the shard (the aligned
// paths: S % 4 == 0 makes the base a multiple of 4)
__device__ __forceinline__ uint4 philox_group(const Dropout& d,
                                              unsigned long long g) {
  g += d.base >> 2;
  return philox4x32_10(
      make_uint4((uint32_t)g, (uint32_t)(g >> 32), d.off_lo, d.off_hi), d.key);
}
__device__ __forceinline__ float keep_of(const Dropout& d, uint32_t word) {
  return (word >> 8) >= d.threshold ? d.scale : 0.f;
}
// 0 or 1/(1-rate) for the flat element idx, from a Philox block of its own
__device__ __forceinline__ float keep_at(const Dropout& d,
                                         unsigned long long idx) {
  idx += d.base;
  const unsigned long long g = idx >> 2;
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)g, (uint32_t)(g >> 32), d.off_lo, d.off_hi), d.key);
  const int w = (int)(idx & 3);
  return keep_of(d, w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w);
}

// keep[i][c] of element (query row i of the warp, key col0 + c), col0 =
// tile start + 2*lane, flat index row_base[i] + col0 + c.  `aligned`
// (S % 4 == 0, the same for the whole grid) makes row_base and the tile
// start multiples of 4, so lanes 2m and 2m+1 share one Philox block per
// row: the even lane draws rows 0 and 1, the odd lane rows 2 and 3, and
// they swap the halves.  Every lane of the warp must call this.
__device__ __forceinline__ void keep_query_rows(
    const Dropout& d, const unsigned long long (&row_base)[kRowsPerWarp],
    int col0, bool aligned, int lane, float (&keep)[kRowsPerWarp][2]) {
  if (aligned) {
    const bool odd = lane & 1;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      // even lane: row t, own words x, y; odd lane: row 2 + t, own z, w
      const unsigned long long base = odd ? row_base[2 + t] : row_base[t];
      const uint4 r = philox_group(d, (base + (unsigned)col0) >> 2);
      const uint32_t own0 = odd ? r.z : r.x, own1 = odd ? r.w : r.y;
      const uint32_t got0 = __shfl_xor_sync(kFull, odd ? r.x : r.z, 1);
      const uint32_t got1 = __shfl_xor_sync(kFull, odd ? r.y : r.w, 1);
      keep[t][0] = keep_of(d, odd ? got0 : own0);
      keep[t][1] = keep_of(d, odd ? got1 : own1);
      keep[2 + t][0] = keep_of(d, odd ? own0 : got0);
      keep[2 + t][1] = keep_of(d, odd ? own1 : got1);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      keep[i][0] = keep_at(d, row_base[i] + (unsigned)col0);
      keep[i][1] = keep_at(d, row_base[i] + (unsigned)col0 + 1);
    }
  }
}

// keep[i][c] of element (query c of the lane, key row key0 + i of the warp),
// flat index query_base[c] + key0 + i; key0 is a multiple of 4, so with
// `aligned` the warp's 4 key rows are one Philox block of each query.
__device__ __forceinline__ void keep_key_rows(
    const Dropout& d, const unsigned long long (&query_base)[2], int key0,
    bool aligned, float (&keep)[kRowsPerWarp][2]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const unsigned long long idx = query_base[c] + (unsigned)key0;
    if (aligned) {
      const uint4 r = philox_group(d, idx >> 2);
      keep[0][c] = keep_of(d, r.x);
      keep[1][c] = keep_of(d, r.y);
      keep[2][c] = keep_of(d, r.z);
      keep[3][c] = keep_of(d, r.w);
    } else {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) keep[i][c] = keep_at(d, idx + i);
    }
  }
}

// ---- tiles in shared memory -----------------------------------------------

// rows r0 .. r0+kRows-1 of head (base) -> dst [dh][kRows], times scale;
// rows past n are zero
template <typename T>
__device__ __forceinline__ void load_rows_t(float* dst,
                                            const T* __restrict__ src,
                                            long base, int r0, int n, int dh,
                                            int D, float scale) {
  for (int i = threadIdx.x; i < kRows * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh;
    dst[d * kRows + r] =
        r < n ? to_float(src[base + (long)(r0 + r) * D + d]) * scale : 0.f;
  }
}

// rows j0 .. j0+kTile-1 -> dst_t [dh][kKStride] and dst_s [kTile][dv] (either
// may be null), times scale; rows past n are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst_t, float* dst_s,
                                          const T* __restrict__ src, long base,
                                          int j0, int n, int dh, int dv,
                                          int D, float scale) {
  for (int i = threadIdx.x; i < kTile * dh; i += blockDim.x) {
    const int j = i / dh, d = i - j * dh;
    const float x =
        j < n ? to_float(src[base + (long)(j0 + j) * D + d]) * scale : 0.f;
    if (dst_t != nullptr) dst_t[d * kKStride + j] = x;
    if (dst_s != nullptr) dst_s[j * dv + d] = x;
  }
}

// s[i][c] = rows_t(row wr + i) . tile_t(column 2*lane + c)
__device__ __forceinline__ void tile_scores(const float* rows_t,
                                            const float* tile_t, int wr,
                                            int lane, int dh,
                                            float (&s)[kRowsPerWarp][2]) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
  for (int d = 0; d < dh; ++d) {
    const float4 rv = *reinterpret_cast<const float4*>(rows_t + d * kRows + wr);
    const float2 tv =
        *reinterpret_cast<const float2*>(tile_t + d * kKStride + 2 * lane);
    const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      s[i][0] = fmaf(rr[i], tv.x, s[i][0]);
      s[i][1] = fmaf(rr[i], tv.y, s[i][1]);
    }
  }
}

// acc[i][e] += sum_{j < n} p4[j](row i) * tile_s[j][dim e of the lane]; the
// lane owns dims 2*lane + {0, 1} and 64 + 2*lane + {0, 1}
__device__ __forceinline__ void tile_accumulate(const float4* p4,
                                                const float* tile_s, int n,
                                                int lane, int dh, int dv,
                                                float (&acc)[kRowsPerWarp][4]) {
  const bool lo = 2 * lane < dh, hi = 64 + 2 * lane < dh;
  for (int j = 0; j < n; ++j) {
    const float4 pj = p4[j];
    const float pr[4] = {pj.x, pj.y, pj.z, pj.w};
    const float* tr = tile_s + j * dv + 2 * lane;
    if (lo) {
      const float2 t2 = *reinterpret_cast<const float2*>(tr);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        acc[i][0] = fmaf(pr[i], t2.x, acc[i][0]);
        acc[i][1] = fmaf(pr[i], t2.y, acc[i][1]);
      }
    }
    if (hi) {
      const float2 t2 = *reinterpret_cast<const float2*>(tr + 64);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        acc[i][2] = fmaf(pr[i], t2.x, acc[i][2]);
        acc[i][3] = fmaf(pr[i], t2.y, acc[i][3]);
      }
    }
  }
}

// the lane's 4 accumulators of row i -> dst (one head's row of dh dims)
template <typename T>
__device__ __forceinline__ void store_row(T* dst, const float (&acc)[4],
                                          float factor, int lane, int dh) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = 2 * lane + (e & 1) + 64 * (e >> 1);
    if (d < dh) store(dst + d, acc[e] * factor);
  }
}

}  // namespace w2vs_flash
