// Block-sparse flash attention backward under the wav2vec-S block mask on
// Hopper's tensor cores (sm_90a): the kernels bfloat16 inputs with heads of
// 32, 64 or 128 dims take.  (float32 inputs and other head widths take the
// CUDA-core kernels of flash_attention_bwd.cu; ops/flash_attention.py
// chooses by dtype and head width alone.)
//
// Replaces the Pallas TPU kernel wav2vec_s_tpu/ops/pallas_attention.py
// (_flash_attn_bwd, _bwd_kernel, with _keep_scale).  The function is the one
// flash_attention_bwd.cu states: from q, k, v, the forward's out and row
// stats m, l, and the cotangent do, with x(r, j) the forward's logit,
//   p  = exp(x - m_r) / max(l_r, 1e-20),  keep = 1 or 0 / 1/(1 - rate)
//   dvec_r = do_r . out_r
//   dV = (p keep)^T . do
//   ds = p ((do . v^T) keep - dvec)
//   dQ = (ds . k) dh**-0.5,   dK = (ds^T . q) dh**-0.5
// every sum in f32, p keep and ds rounded to bf16 between the products (they
// are operands of the second products), gradients written as bf16.
//
// Two kernels and no atomics, so two runs of a step give the same bits:
//   - flash_dq_mma_kernel, grid (query tiles of 64, H, B): walks the key
//     tiles of its row of the 64 x 64 tile-kind table, writes dQ and dvec;
//   - flash_dkv_mma_kernel, grid (key tiles of 64, H, B): walks the query
//     tiles of its row of the transposed table and writes dK and dV.  It
//     computes the TRANSPOSED logits k . q^T (rows keys, columns queries), so
//     that their accumulator is the A operand of p^T . do and ds^T . q.
// q.k and do.v run in both kernels: 7 products over the computed tiles.
//
// What bounds it.  At the training call (B 8, S 748, 12 heads of 64) the 7
// products over the computed 64 x 64 tiles are ~26 GFLOP, ~0.03 ms at the
// tensor cores' peak; the 8 packed tensors are 74 MB, 0.02 ms of device
// memory.  As in the forward the elementwise work between the products
// bounds the kernels: per logit a scale-and-mask, an exponent, 3 to 5
// multiplies and two bf16 conversions in each kernel, and with dropout a
// quarter of a Philox block in each (the mask is regenerated twice).
//
// What the design does about it (flash_mma.cuh has the shared pieces):
// - mma.sync m16n8k16 on bf16 for all products; the scale is applied in f32;
// - the row operands are A fragments in registers for the whole block: q
//   and do in the dQ kernel, k in the dK/dV kernel.  That kernel holds two
//   16 x dh accumulators, so its v fragments (one product of four) are read
//   from shared memory each time, which frees the registers that spilled
//   otherwise at no cost in time, and at dh 128 its k fragments too;
// - a tile is worked off in 4 groups of 16 columns: 2 + 2 accumulators of
//   logits and do.v, the elementwise pass, then the group's share of the
//   second products.  p and ds live in 8 registers at a time, and never in
//   shared memory.  In a partial tile a 16 x 16 group without an allowed
//   pair is skipped whole (a warp-uniform vote on the layout rule; a third
//   of the groups of the computed tiles at the training call): K3 is 13%
//   faster for it.  The forward does not do this: there the vote and the
//   branches cost more than the skipped groups saved;
// - one swizzled bf16 copy of every tile, two cp.async stages, skipped tiles
//   never loaded; the per-column stats of the dK/dV kernel (m, 1/l, dvec,
//   block index of each query) are fetched one tile ahead into registers and
//   stored beside the tile;
// - dropout: one Philox block serves 4 keys of a query in both kernels (two
//   lanes of a quad in the dQ kernel, the four lanes that hold 4 consecutive
//   key rows in the dK/dV kernel), exchanged as keep bits by shuffles.
//
// Plain C interface (loaded with ctypes): w2vs_flash_attention_bwd_mma
// returns the first CUDA error of its attribute calls and launches, 0 if
// none, and cudaErrorInvalidValue for inputs these kernels do not take.

#include "flash_mma.cuh"

namespace {

using namespace w2vs_flash;
using namespace w2vs_flash::tc;

// the queries of a query tile (dK/dV kernel)
struct QueryMeta {
  int blk[kTileRows];
  float m[kTileRows];
  float inv_l[kTileRows];
  float dvec[kTileRows];
};

// dQ: q, do [64][DH]; k, v [2][64][DH]; KeyMeta[2]
template <int DH>
constexpr size_t dq_smem_bytes() {
  return (size_t)6 * kTileRows * DH * sizeof(bf16) + 2 * sizeof(KeyMeta);
}
// dK/dV: k, v [64][DH]; q, do [2][64][DH]; QueryMeta[2]
template <int DH>
constexpr size_t dkv_smem_bytes() {
  return (size_t)6 * kTileRows * DH * sizeof(bf16) + 2 * sizeof(QueryMeta);
}

// grid (query tiles of 64, H, B); block 128 threads
template <int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads, DH <= 64 ? 3 : 2)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ out,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const unsigned char* __restrict__ key_pad,
                    const signed char* __restrict__ kinds,
                    bf16* __restrict__ dq, float* __restrict__ dvec_out,
                    int S, int D, int T_frames, int mc, int rc, float scale,
                    Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kTileElems = kTileRows * DH;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kTileElems;
  bf16* k_s = do_s + kTileElems;              // 2 stages
  bf16* v_s = k_s + 2 * kTileElems;           // 2 stages
  KeyMeta* meta = reinterpret_cast<KeyMeta*>(v_s + 2 * kTileElems);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qt * kTileRows;
  const int n_kt = (S + kTileRows - 1) / kTileRows;
  const long base = (long)b * S * D + (long)h * DH;   // row 0 of (b, h)
  const long stat0 = ((long)b * H + h) * S;           // row 0 of m, l, dvec
  const unsigned char* pad = key_pad + (long)b * S;
  const signed char* kind_row = kinds + (long)qt * n_kt;

  auto stage_tile = [&](int st, int kt) {
    load_tile_async<DH>(k_s + st * kTileElems, k, base, kt * kTileRows, S, D);
    load_tile_async<DH>(v_s + st * kTileElems, v, base, kt * kTileRows, S, D);
  };
  auto put_meta = [&](int st, int kt, bool padded) {
    put_key_meta(meta[st], kt, S, T_frames, mc, rc, padded);
  };

  load_tile_async<DH>(q_s, q, base, r0, S, D);
  load_tile_async<DH>(do_s, dout, base, r0, S, D);
  cp_async_commit();
  int kt = next_tile(kind_row, 0, n_kt);
  if (kt < n_kt) {
    stage_tile(0, kt);
    if (tid < kTileRows) put_meta(0, kt, key_is_padded(pad, kt, S));
  }
  cp_async_commit();

  // dvec = do . out for the warp's 16 rows (written out for the dK/dV
  // kernel); the lane keeps its two rows' values
  float dvec[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + 16 * warp + i;
    float part = 0.f;
    if (r < S) {
      const long row = base + (long)r * D;
      for (int d = 2 * lane; d < DH; d += 64) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + row + d));
        const float2 o = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(out + row + d));
        part = fmaf(a.x, o.x, fmaf(a.y, o.y, part));
      }
    }
    const float sum = warp_sum(part);
    if (r < S && lane == 0) dvec_out[stat0 + r] = sum;
    if (i == g) dvec[0] = sum;
    if (i == g + 8) dvec[1] = sum;
  }

  // the lane's two rows.  A row past S gets m = +inf, so its p is
  // exp(-inf) = 0.
  const int row_a = r0 + 16 * warp + g;
  int q_blk[2];
  float m[2], inv_l[2];
  unsigned long long row_base[2];   // flat index of key 0 in [B, H, S, S]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_a + 8 * i;
    q_blk[i] = query_block(r, T_frames, mc, rc);
    row_base[i] = (((unsigned long long)b * drop.heads + h) * S + r) * S;
    m[i] = r < S ? m_in[stat0 + r] : INFINITY;
    inv_l[i] = r < S ? 1.f / fmaxf(l_in[stat0 + r], 1e-20f) : 0.f;
  }

  cp_async_wait<1>();                       // q and do have landed
  __syncthreads();
  uint32_t qf[DH / 16][4], dof[DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    load_a<DH>(qf[ks], smem_u32(q_s), 16 * warp, ks, lane);
    load_a<DH>(dof[ks], smem_u32(do_s), 16 * warp, ks, lane);
  }

  float acc[DH / 8][4];
  zero_acc<DH>(acc);

  int stage = 0;
  while (kt < n_kt) {
    cp_async_wait<0>();                     // tile kt has landed
    __syncthreads();                        // ... and the other stage is free
    const int nxt = next_tile(kind_row, kt + 1, n_kt);
    bool nxt_padded = false;
    if (nxt < n_kt) {
      stage_tile(stage ^ 1, nxt);
      nxt_padded = key_is_padded(pad, nxt, S);   // used after the products
    }
    cp_async_commit();

    const bool partial = kind_row[kt] == 2;
    const int j0 = kt * kTileRows;
    const uint32_t k_tile = smem_u32(k_s + stage * kTileElems);
    const uint32_t v_tile = smem_u32(v_s + stage * kTileElems);
    const KeyMeta& km = meta[stage];

#pragma unroll 1
    for (int j = 0; j < 4; ++j) {           // 16 keys at a time
      // in a partial tile: which of the lane's 8 pairs the layout allows
      // (bit 4n + i); a 16 x 16 group without an allowed pair adds nothing
      unsigned ok = 0xffu;
      if (partial) {
        ok = 0;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int c = 16 * j + 8 * n + 2 * t;
          const int2 lo = *reinterpret_cast<const int2*>(&km.lo[c]);
          const uint2 span = *reinterpret_cast<const uint2*>(&km.span[c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (allowed(q_blk[i >> 1], (i & 1) ? lo.y : lo.x,
                        (i & 1) ? span.y : span.x)) {
              ok |= 1u << (4 * n + i);
            }
          }
        }
        if (!__any_sync(kFull, ok)) continue;
      }
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t bk[4], bv[4];
        load_b<DH>(bk, k_tile, 16 * j, ks, lane);
        load_b<DH>(bv, v_tile, 16 * j, ks, lane);
        mma_bf16(s[0], qf[ks], bk[0], bk[1]);
        mma_bf16(s[1], qf[ks], bk[2], bk[3]);
        mma_bf16(dp[0], dof[ks], bv[0], bv[1]);
        mma_bf16(dp[1], dof[ks], bv[2], bv[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 bias = *reinterpret_cast<const float2*>(
            &km.bias[16 * j + 8 * n + 2 * t]);
        float keep[4];
        if constexpr (kDrop) {
          keep_rows_frag(drop, row_base, j0 + 16 * j + 8 * n, (S & 3) == 0, t,
                         keep);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool second = i & 1;
          const int hh = i >> 1;
          const float x = logit(s[n][i], scale, second ? bias.y : bias.x,
                                !((ok >> (4 * n + i)) & 1));
          const float p = __expf(x - m[hh]) * inv_l[hh];
          const float gr = kDrop ? dp[n][i] * keep[i] : dp[n][i];
          s[n][i] = p * (gr - dvec[hh]);    // ds
        }
      }
      uint32_t dsa[4];
      pack_a(dsa, s[0], s[1]);
      accumulate<DH>(acc, dsa, k_tile, j, lane);          // dq += ds . k
    }

    if (nxt < n_kt && tid < kTileRows) put_meta(stage ^ 1, nxt, nxt_padded);
    kt = nxt;
    stage ^= 1;
  }

  store_acc<DH>(dq, base, D, row_a, S, t, acc, scale, scale);
}

// grid (key tiles of 64, H, B); block 128 threads.  kinds_t is the table of
// the transposed layout: [key tiles][query tiles].
template <int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads, DH <= 64 ? 3 : 2)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const float* __restrict__ dvec_in,
                     const unsigned char* __restrict__ key_pad,
                     const signed char* __restrict__ kinds_t,
                     bf16* __restrict__ dk, bf16* __restrict__ dv_out, int S,
                     int D, int T_frames, int mc, int rc, float scale,
                     Dropout drop) {
  constexpr bool kKeysInRegs = DH <= 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kTileElems = kTileRows * DH;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTileElems;
  bf16* q_s = v_s + kTileElems;               // 2 stages
  bf16* do_s = q_s + 2 * kTileElems;          // 2 stages
  QueryMeta* meta = reinterpret_cast<QueryMeta*>(do_s + 2 * kTileElems);

  const int kt = blockIdx.x;                  // early keys are seen by most
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kTileRows;
  const int n_qt = (S + kTileRows - 1) / kTileRows;
  const long base = (long)b * S * D + (long)h * DH;   // row 0 of (b, h)
  const long stat0 = ((long)b * H + h) * S;           // row 0 of m, l, dvec
  const signed char* kind_row = kinds_t + (long)kt * n_qt;

  auto stage_tile = [&](int st, int qt) {
    load_tile_async<DH>(q_s + st * kTileElems, q, base, qt * kTileRows, S, D);
    load_tile_async<DH>(do_s + st * kTileElems, dout, base, qt * kTileRows, S,
                        D);
  };
  // a query past S gets m = +inf, so its p is exp(-inf) = 0
  struct Stats { float m, l, dvec; };
  auto fetch_stats = [&](int qt) {
    Stats st = {INFINITY, 1.f, 0.f};
    const int r = qt * kTileRows + tid;
    if (tid < kTileRows && r < S) {
      st.m = m_in[stat0 + r];
      st.l = l_in[stat0 + r];
      st.dvec = dvec_in[stat0 + r];
    }
    return st;
  };
  auto put_meta = [&](int st, int qt, const Stats& x) {
    const int r = qt * kTileRows + tid;
    meta[st].blk[tid] = query_block(r, T_frames, mc, rc);
    meta[st].m[tid] = x.m;
    meta[st].inv_l[tid] = r < S ? 1.f / fmaxf(x.l, 1e-20f) : 0.f;
    meta[st].dvec[tid] = x.dvec;
  };

  load_tile_async<DH>(k_s, k, base, k0, S, D);
  load_tile_async<DH>(v_s, v, base, k0, S, D);
  cp_async_commit();
  int qt = next_tile(kind_row, 0, n_qt);
  if (qt < n_qt) {
    stage_tile(0, qt);
    const Stats st = fetch_stats(qt);
    if (tid < kTileRows) put_meta(0, qt, st);
  }
  cp_async_commit();

  // the lane's two key rows: g and g + 8 of the warp's 16
  const int key_a = k0 + 16 * warp + g;
  int lo[2];
  unsigned span[2];
  float bias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_a + 8 * i;
    const bool padded = key < S && key_pad[(long)b * S + key] != 0;
    key_rule(key, S, T_frames, mc, rc, padded, lo[i], span[i], bias[i]);
  }
  const unsigned long long bh_rows =
      ((unsigned long long)b * drop.heads + h) * S;

  cp_async_wait<1>();                       // k and v rows have landed
  __syncthreads();
  const uint32_t k_rows = smem_u32(k_s), v_rows = smem_u32(v_s);
  uint32_t kf[kKeysInRegs ? DH / 16 : 1][4];
  if constexpr (kKeysInRegs) {
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      load_a<DH>(kf[ks], k_rows, 16 * warp, ks, lane);
    }
  }

  float acc_k[DH / 8][4], acc_v[DH / 8][4];
  zero_acc<DH>(acc_k);
  zero_acc<DH>(acc_v);

  int stage = 0;
  while (qt < n_qt) {
    cp_async_wait<0>();                     // tile qt has landed
    __syncthreads();                        // ... and the other stage is free
    const int nxt = next_tile(kind_row, qt + 1, n_qt);
    Stats nxt_stats = {INFINITY, 1.f, 0.f};
    if (nxt < n_qt) {
      stage_tile(stage ^ 1, nxt);
      nxt_stats = fetch_stats(nxt);         // consumed after the products
    }
    cp_async_commit();

    const bool partial = kind_row[qt] == 2;
    const int q0 = qt * kTileRows;
    const uint32_t q_tile = smem_u32(q_s + stage * kTileElems);
    const uint32_t do_tile = smem_u32(do_s + stage * kTileElems);
    const QueryMeta& qm = meta[stage];

#pragma unroll 1
    for (int j = 0; j < 4; ++j) {           // 16 queries at a time
      // in a partial tile: which of the lane's 8 pairs the layout allows
      // (bit 4n + i); a 16 x 16 group without an allowed pair adds nothing
      unsigned ok = 0xffu;
      if (partial) {
        ok = 0;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int2 q_blk = *reinterpret_cast<const int2*>(
              &qm.blk[16 * j + 8 * n + 2 * t]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (allowed((i & 1) ? q_blk.y : q_blk.x, lo[i >> 1],
                        span[i >> 1])) {
              ok |= 1u << (4 * n + i);
            }
          }
        }
        if (!__any_sync(kFull, ok)) continue;
      }
      // st = k . q^T, dpt = v . do^T: rows keys, columns queries
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t bq[4], bd[4];
        load_b<DH>(bq, q_tile, 16 * j, ks, lane);
        load_b<DH>(bd, do_tile, 16 * j, ks, lane);
        uint32_t a[4];
        if constexpr (kKeysInRegs) {
          mma_bf16(st[0], kf[ks], bq[0], bq[1]);
          mma_bf16(st[1], kf[ks], bq[2], bq[3]);
        } else {
          load_a<DH>(a, k_rows, 16 * warp, ks, lane);
          mma_bf16(st[0], a, bq[0], bq[1]);
          mma_bf16(st[1], a, bq[2], bq[3]);
        }
        load_a<DH>(a, v_rows, 16 * warp, ks, lane);
        mma_bf16(dpt[0], a, bd[0], bd[1]);
        mma_bf16(dpt[1], a, bd[2], bd[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = 16 * j + 8 * n + 2 * t;
        const float2 m = *reinterpret_cast<const float2*>(&qm.m[c]);
        const float2 inv_l = *reinterpret_cast<const float2*>(&qm.inv_l[c]);
        const float2 dvec = *reinterpret_cast<const float2*>(&qm.dvec[c]);
        float keep[4];
        if constexpr (kDrop) {
          keep_cols_frag(drop, bh_rows, S, q0 + 16 * j + 8 * n, key_a,
                         (S & 3) == 0, lane, keep);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool second = i & 1;
          const int hh = i >> 1;
          const float x =
              logit(st[n][i], scale, bias[hh], !((ok >> (4 * n + i)) & 1));
          const float p =
              __expf(x - (second ? m.y : m.x)) * (second ? inv_l.y : inv_l.x);
          const float kp = kDrop ? keep[i] : 1.f;
          st[n][i] = p * kp;                                  // (p keep)^T
          dpt[n][i] =
              p * (dpt[n][i] * kp - (second ? dvec.y : dvec.x));   // ds^T
        }
      }
      uint32_t pta[4], dsa[4];
      pack_a(pta, st[0], st[1]);
      pack_a(dsa, dpt[0], dpt[1]);
      accumulate<DH>(acc_v, pta, do_tile, j, lane);     // dv += (p keep)^T . do
      accumulate<DH>(acc_k, dsa, q_tile, j, lane);      // dk += ds^T . q
    }

    if (nxt < n_qt && tid < kTileRows) put_meta(stage ^ 1, nxt, nxt_stats);
    qt = nxt;
    stage ^= 1;
  }

  store_acc<DH>(dk, base, D, key_a, S, t, acc_k, scale, scale);
  store_acc<DH>(dv_out, base, D, key_a, S, t, acc_v, 1.f, 1.f);
}

template <int DH, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* m, const float* l,
           const unsigned char* key_pad, const signed char* kinds,
           const signed char* kinds_t, void* dq, void* dk, void* dv,
           float* dvec, int B, int S, int D, int H, int T_frames, int mc,
           int rc, const Dropout& drop, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)DH));
  const dim3 grid((S + kTileRows - 1) / kTileRows, H, B);

  auto dq_kernel = flash_dq_mma_kernel<DH, kDrop>;
  int err = allow_smem(dq_kernel, dq_smem_bytes<DH>());
  if (err) return err;
  dq_kernel<<<grid, kThreads, dq_smem_bytes<DH>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)out,
      (const bf16*)dout, m, l, key_pad, kinds, (bf16*)dq, dvec, S, D,
      T_frames, mc, rc, scale, drop);
  err = (int)cudaGetLastError();
  if (err) return err;

  auto dkv_kernel = flash_dkv_mma_kernel<DH, kDrop>;
  err = allow_smem(dkv_kernel, dkv_smem_bytes<DH>());
  if (err) return err;
  dkv_kernel<<<grid, kThreads, dkv_smem_bytes<DH>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, m, l,
      dvec, key_pad, kinds_t, (bf16*)dk, (bf16*)dv, S, D, T_frames, mc, rc,
      scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments of w2vs_flash_attention_bwd (flash_attention_bwd.cu), with
// kinds and kinds_t the [ceil(S/64), ceil(S/64)] tables of 64 x 64 tiles of
// the layout and of the transposed layout.  Takes bfloat16 (dtype_code 1)
// with heads of 32, 64 or 128 dims and 16-byte aligned tensors; anything else
// is cudaErrorInvalidValue.
extern "C" int w2vs_flash_attention_bwd_mma(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* m, const void* l, const void* key_pad,
    const void* kinds, const void* kinds_t, void* dq, void* dk, void* dv,
    void* dvec, int B, int S, int D, int H, int T_frames, int mc, int rc,
    int dtype_code, unsigned long long seed, unsigned long long offset,
    unsigned long long base, int heads, unsigned threshold, double keep_scale,
    void* stream) {
  if (dtype_code != 1 || H < 1 || D % H || mc < 1 || rc < 0 ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out |
        (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) &
       15)) {
    return (int)cudaErrorInvalidValue;
  }
  if (heads < H) return (int)cudaErrorInvalidValue;
  const Dropout drop =
      make_dropout(seed, offset, base, heads, threshold, keep_scale);
#define W2VS_BWD(DH, DROP)                                                   \
  launch<DH, DROP>(q, k, v, out, dout, (const float*)m, (const float*)l,    \
                   (const unsigned char*)key_pad, (const signed char*)kinds, \
                   (const signed char*)kinds_t, dq, dk, dv, (float*)dvec, B, \
                   S, D, H, T_frames, mc, rc, drop, (cudaStream_t)stream)
  switch (D / H) {
    case 32: return threshold ? W2VS_BWD(32, true) : W2VS_BWD(32, false);
    case 64: return threshold ? W2VS_BWD(64, true) : W2VS_BWD(64, false);
    case 128: return threshold ? W2VS_BWD(128, true) : W2VS_BWD(128, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef W2VS_BWD
}
