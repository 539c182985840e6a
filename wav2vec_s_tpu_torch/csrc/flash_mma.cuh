// Tensor-core pieces of the attention kernels for bf16 inputs: the
// block-sparse flash-attention kernels (forward in flash_attention_mma.cu,
// backward in flash_attention_bwd_mma.cu) and the incremental-chunk attention
// over the K/V cache (chunk_attention_mma.cu, which takes the staging, the
// fragments, the product and the quad reductions, with its own row tiles).
// Here: the tile geometry, the shared-memory layout, cp.async staging,
// ldmatrix fragment loads, the mma.sync product and the attention-dropout
// mask on an accumulator fragment.
//
// Geometry.  A block of 4 warps owns 64 "rows" (16 per warp) and walks tiles
// of 64 "columns".  In the forward and in the dQ kernel rows are queries and
// columns keys; in the dK/dV kernel rows are keys and columns queries.
// Every product is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: a
// warp's 16 rows against 8 columns over 16 of the inner dimension, bf16
// operands, f32 accumulator.  With g = lane / 4 and t = lane % 4 a lane holds
//   accumulator (16 x 8):  c0, c1 = (row g,     columns 2t, 2t + 1)
//                          c2, c3 = (row g + 8, columns 2t, 2t + 1)
//   A operand (16 x 16):   a0 = (row g, k 2t..), a1 = (row g + 8, k 2t..),
//                          a2 = (row g, k 8 + 2t..), a3 = (row g + 8, ..)
// so two neighbouring accumulators, packed to bf16 pairs, ARE the A operand
// of the next product: probabilities and dS never leave the registers.
//
// Shared memory.  One bf16 copy of each operand, [64][DH] row-major as in
// device memory, filled by 16-byte cp.async.cg (rows past S zero-filled, so
// that nothing non-finite is ever multiplied by a zero probability).  The
// 16-byte chunks of a row are XOR-swizzled with the row index so that the 8
// row addresses of every ldmatrix fall into 8 different bank groups.  Both
// uses of a tile come from that one copy: ldmatrix for the operand whose
// inner dimension is DH (q.k, do.v), ldmatrix.trans for the one whose inner
// dimension is the tile's rows (p.v, ds.k, p^T.do, ds^T.q).
//
// Masks.  Per column of the staged tile a small record is kept beside it:
// the additive bias (0, NEG for a padded key, -inf for a key past S) and the
// block-layout rule as an interval test, allowed <=> (unsigned)(q_blk - lo)
// <= span (a frame key of block kb: lo = kb, span = 2^31 - 1, i.e. q_blk >=
// kb; a look-ahead copy: lo = kb, span = 0, i.e. q_blk == kb).  The integer
// divisions happen once per column and tile, not per element.

#pragma once

#include "flash_common.cuh"

namespace w2vs_flash {
namespace tc {

constexpr int kTileRows = 64;                 // rows per block, columns per tile
constexpr int kTcWarps = 4;
constexpr int kThreads = kTcWarps * 32;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// offset, in elements, of 16-byte chunk `chunk` of row `row` of a swizzled
// [rows][DH] bf16 tile
template <int DH>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int C = DH / 8;                   // chunks per row: 4, 8, 16
  constexpr int M = C < 8 ? C : 8;            // chunks that share 128 bytes
  constexpr int R = 8 / M;                    // rows per 128 bytes
  return row * DH + ((chunk ^ ((row / R) % M)) << 3);
}

// ---- cp.async ---------------------------------------------------------------

// 16 bytes global -> shared; !valid writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows row0 .. row0+ROWS-1 of one head (row 0 at src + base, row stride D
// elements) -> the swizzled [ROWS][DH] tile dst; rows past S are zero and are
// never read.  Every thread of the block (THREADS of them) calls.
template <int DH, int ROWS = kTileRows, int THREADS = kThreads>
__device__ __forceinline__ void load_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                long base, int row0, int S,
                                                long D) {
  constexpr int C = DH / 8;
  const uint32_t d0 = smem_u32(dst);
  for (int i = threadIdx.x; i < ROWS * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const bool in = row0 + r < S;
    const bf16* g = src + base + (long)(in ? row0 + r : 0) * D + c * 8;
    cp_async16(d0 + 2 * swz<DH>(r, c), g, in);
  }
}

// ---- fragments ----------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row-major) . b (16 x 8, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand: rows row0 .. row0+15 of the tile, inner dims 16*ks .. 16*ks+15
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile,
                                       int row0, int ks, int lane) {
  const int row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4(a, tile + 2 * swz<DH>(row, 2 * ks + (lane >> 4)));
}
// B operands of two 8-column groups whose columns are the tile's rows
// n0 .. n0+15 and whose inner dimension is DH (dims 16*ks .. 16*ks+15):
// b[0], b[1] for columns n0 .. n0+7, b[2], b[3] for n0+8 .. n0+15
template <int DH>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], uint32_t tile,
                                       int n0, int ks, int lane) {
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  ldsm_x4(b, tile + 2 * swz<DH>(row, 2 * ks + ((lane >> 3) & 1)));
}
// B operands of two 8-column groups whose inner dimension is the tile's rows
// 16*kk .. 16*kk+15 and whose columns are the tile's dims (transposed use):
// b[0], b[1] for dims 16*np .. 16*np+7, b[2], b[3] for 16*np+8 .. 16*np+15
template <int DH>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], uint32_t tile,
                                             int kk, int np, int lane) {
  const int row = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4_trans(b, tile + 2 * swz<DH>(row, 2 * np + (lane >> 4)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two accumulators (columns 0..7 and 8..15 of a 16-wide group) -> A operand
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

template <int DH>
__device__ __forceinline__ void zero_acc(float (&acc)[DH / 8][4]) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
}

// acc (16 x DH) += a (16 x 16) . rows 16*kk .. 16*kk+15 of the tile
template <int DH>
__device__ __forceinline__ void accumulate(float (&acc)[DH / 8][4],
                                           const uint32_t (&a)[4],
                                           uint32_t tile, int kk, int lane) {
#pragma unroll
  for (int np = 0; np < DH / 16; ++np) {
    uint32_t bt[4];
    load_b_trans<DH>(bt, tile, kk, np, lane);
    mma_bf16(acc[2 * np], a, bt[0], bt[1]);
    mma_bf16(acc[2 * np + 1], a, bt[2], bt[3]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// the lane's part of a warp's 16 x DH accumulator -> rows of one head in
// device memory (row_a = the row of c0/c1, row_a + 8 that of c2/c3)
template <int DH>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst, long base,
                                          int D, int row_a, int S, int t,
                                          const float (&acc)[DH / 8][4],
                                          float f_a, float f_b) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row >= S) continue;
    const float f = h ? f_b : f_a;
    bf16* o = dst + base + (long)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * h] * f, acc[n][2 * h + 1] * f);
    }
  }
}

// ---- the tile walk ----------------------------------------------------------------

// first tile at or after `from` that has an allowed pair, or n
__device__ __forceinline__ int next_tile(const signed char* __restrict__ row,
                                         int from, int n) {
  while (from < n && row[from] == 0) ++from;
  return from;
}

// ---- per-column records of a staged tile ------------------------------------

// the keys of a key tile (forward, dQ kernel)
struct KeyMeta {
  int lo[kTileRows];
  unsigned span[kTileRows];
  float bias[kTileRows];
};
__device__ __forceinline__ void key_rule(int key, int S, int T_frames, int mc,
                                         int rc, bool padded, int& lo,
                                         unsigned& span, float& bias) {
  const bool in = key < S;
  lo = in ? key_block(key, T_frames, mc, rc) : -1;      // past S: never allowed
  span = key >= T_frames ? 0u : 0x7fffffffu;
  bias = !in ? -INFINITY : padded ? kNeg : 0.f;
}
// Thread j < 64 of the block keeps key j of a key tile: whether it is padded
// is read one tile ahead, the record is stored once the stage is free.
__device__ __forceinline__ bool key_is_padded(
    const unsigned char* __restrict__ pad, int kt, int S) {
  const int key = kt * kTileRows + threadIdx.x;
  return threadIdx.x < kTileRows && key < S && pad[key] != 0;
}
__device__ __forceinline__ void put_key_meta(KeyMeta& km, int kt, int S,
                                             int T_frames, int mc, int rc,
                                             bool padded) {
  const int j = threadIdx.x;
  key_rule(kt * kTileRows + j, S, T_frames, mc, rc, padded, km.lo[j],
           km.span[j], km.bias[j]);
}
__device__ __forceinline__ bool allowed(int q_blk, int lo, unsigned span) {
  return (unsigned)(q_blk - lo) <= span;
}
// the logit of one pair from its raw product: scale, key bias, layout mask
__device__ __forceinline__ float logit(float s, float scale, float bias,
                                       bool forbidden) {
  float x = s * scale + bias;
  if (forbidden) x += kNeg;
  return x;
}

// ---- attention dropout on a fragment ----------------------------------------

// bit i set <=> word i of the Philox block keeps its element
__device__ __forceinline__ unsigned keep_bits(const Dropout& d, uint4 r) {
  return ((r.x >> 8) >= d.threshold ? 1u : 0u) |
         ((r.y >> 8) >= d.threshold ? 2u : 0u) |
         ((r.z >> 8) >= d.threshold ? 4u : 0u) |
         ((r.w >> 8) >= d.threshold ? 8u : 0u);
}
__device__ __forceinline__ float keep_bit(const Dropout& d, unsigned bits,
                                          int i) {
  return (bits >> i) & 1u ? d.scale : 0.f;
}

// Rows are queries, columns keys.  keep[i] for accumulator c_i of the 16 x 8
// group whose first key is col0 (a multiple of 8): rows row_base[0] (c0, c1)
// and row_base[1] (c2, c3) as flat indices of key 0, keys col0 + 2t + {0, 1}.
// `aligned` (S % 4 == 0, the same for the whole grid): lanes t = 2u, 2u + 1
// share the Philox block of keys col0 + 4u .. + 3 in each row; the even lane
// draws the first row's block, the odd lane the second row's, and they
// exchange the four keep bits.  Every lane of the warp must call this.
__device__ __forceinline__ void keep_rows_frag(
    const Dropout& d, const unsigned long long (&row_base)[2], int col0,
    bool aligned, int t, float (&keep)[4]) {
  if (aligned) {
    const int odd = t & 1;
    const unsigned long long idx =
        (odd ? row_base[1] : row_base[0]) + (unsigned)(col0 + 4 * (t >> 1));
    const unsigned own = keep_bits(d, philox_group(d, idx >> 2));
    const unsigned got = __shfl_xor_sync(kFull, own, 1);
    const unsigned first = odd ? got : own, second = odd ? own : got;
    keep[0] = keep_bit(d, first, 2 * odd);
    keep[1] = keep_bit(d, first, 2 * odd + 1);
    keep[2] = keep_bit(d, second, 2 * odd);
    keep[3] = keep_bit(d, second, 2 * odd + 1);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      keep[i] = keep_at(
          d, row_base[i >> 1] + (unsigned)(col0 + 2 * t + (i & 1)));
    }
  }
}

// Rows are keys, columns queries (the dK/dV kernel).  keep[i] for accumulator
// c_i of the 16 x 8 group whose first query is q0 (a multiple of 8): keys
// key_a = 16-aligned start + g (c0, c1) and key_a + 8 (c2, c3), queries q0 +
// 2t + {0, 1}; bh_rows = (b*H + h) * S.  `aligned`: the four lanes with the
// same t and g / 4 hold the four keys of one Philox block for each of their 4
// (query, key group) pairs; lane g % 4 = j draws the block of pair j (query
// q0 + 2t + (j & 1), key group of key_a + 8 * (j >> 1)) and every lane reads
// bit g % 4 of each of the four.  Every lane of the warp must call this.
__device__ __forceinline__ void keep_cols_frag(const Dropout& d,
                                               unsigned long long bh_rows,
                                               int S, int q0, int key_a,
                                               bool aligned, int lane,
                                               float (&keep)[4]) {
  const int t = lane & 3;
  if (aligned) {
    const int j = (lane >> 2) & 3;
    const unsigned long long query = bh_rows + (unsigned)(q0 + 2 * t + (j & 1));
    const unsigned key4 = (unsigned)((key_a + 8 * (j >> 1)) & ~3);
    const unsigned own = keep_bits(d, philox_group(d, (query * S + key4) >> 2));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned got = __shfl_sync(kFull, own, (lane & 0x13) | (i << 2));
      keep[i] = keep_bit(d, got, j);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned long long query =
          bh_rows + (unsigned)(q0 + 2 * t + (i & 1));
      keep[i] = keep_at(d, query * S + (unsigned)(key_a + 8 * (i >> 1)));
    }
  }
}

}  // namespace tc
}  // namespace w2vs_flash
