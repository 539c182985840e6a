// Block-sparse flash attention forward under the wav2vec-S block mask on
// Hopper's tensor cores (sm_90a): the kernel bfloat16 inputs with heads of
// 32, 64 or 128 dims take.  (float32 inputs and other head widths take the
// CUDA-core kernel of flash_attention.cu; ops/flash_attention.py chooses by
// dtype and head width alone.)
//
// Replaces the forward of the Pallas TPU kernel
// wav2vec_s_tpu/ops/pallas_attention.py (_flash_attn_impl, _kernel,
// _tile_plan, _keep_scale).  The function is the one flash_attention.cu
// states: for every stream b, head h and query row r of the packed
// [B, S, H*dh] projections
//   s(r, j) = (q_r . k_j) * dh**-0.5 + NEG if the block layout forbids (r, j)
//                                    + NEG if key j is padded
//   out_r   = (softmax_j(s(r, .)) * keep(r, .)) . v
//   m_r = max_j s,  l_r = sum_j exp(s - m_r)        (natural-log units, f32)
// with NEG = -1e9 and keep = 1, or 0 / 1/(1 - rate) under attention dropout
// (flash_common.cuh: a function of the element's coordinates alone).
//
// What bounds it.  At the one-shot encoder's call (B 32, S 728, 12 heads of
// 64) the two products over the computed tiles are ~29 GFLOP: ~0.03 ms at the
// tensor cores' 989 TFLOP/s, against ~0.04 ms for the 143 MB of q, k, v and
// out at 3.35 TB/s.  mma.sync reaches a part of that peak, and the softmax
// between the products (a scale-and-mask, a max, an exponent and a sum per
// logit, a quarter of a Philox block with dropout) runs on the CUDA cores
// beside it: per 64 x 64 tile a warp issues 64 mma and some 250 to 600
// scalar operations, so the kernel is bound by that elementwise work, not
// by the products and not by device memory.
//
// What the design does about it (flash_mma.cuh has the shared pieces):
// - every product is an mma.sync m16n8k16 on bf16 with f32 accumulators; the
//   scale dh**-0.5 is applied to the f32 logits (q stays unrounded bf16);
// - q is loaded once into A fragments that stay in registers; the
//   probabilities are packed from the accumulator of q.k straight into the A
//   operand of p.v, so they never touch shared memory;
// - k and v tiles are staged once each as bf16 by 16-byte cp.async into two
//   swizzled stages: tile i+1 is in flight while tile i is multiplied, and
//   skipped tiles are never loaded (the next computed tile is looked up in
//   the block's row of the tile-kind table, 64 x 64 tiles here);
// - the row maximum needs two shuffles (the 4 lanes of a quad hold a row),
//   the row sum is kept per lane and reduced once at the end;
// - the layout rule costs one subtraction and compare per logit in partial
//   tiles (per-key records built once per tile), nothing in full tiles;
// - with dropout two lanes share one Philox block per row and exchange keep
//   bits by one shuffle; rate 0 is a separate instantiation without Philox;
// - heavy query tiles (late rows see most keys) are scheduled first.
//
// Plain C interface (loaded with ctypes): w2vs_flash_attention_mma returns
// the first CUDA error of its attribute call and launch, 0 if none, and
// cudaErrorInvalidValue for inputs this kernel does not take.

#include "flash_mma.cuh"

namespace {

using namespace w2vs_flash;
using namespace w2vs_flash::tc;

// shared memory: q [64][DH], k and v [2][64][DH] bf16, then KeyMeta[2]
template <int DH>
constexpr size_t fwd_smem_bytes() {
  return (size_t)5 * kTileRows * DH * sizeof(bf16) + 2 * sizeof(KeyMeta);
}

// grid (query tiles of 64, H, B); block 128 threads
template <int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads, DH <= 64 ? 3 : 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const unsigned char* __restrict__ key_pad,
                     const signed char* __restrict__ kinds,
                     bf16* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int S, int D, int T_frames,
                     int mc, int rc, float scale, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kTileElems = kTileRows * DH;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTileElems;               // 2 stages
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
  cp_async_commit();
  int kt = next_tile(kind_row, 0, n_kt);
  if (kt < n_kt) {
    stage_tile(0, kt);
    if (tid < kTileRows) put_meta(0, kt, key_is_padded(pad, kt, S));
  }
  cp_async_commit();

  // the lane's two rows: g and g + 8 of the warp's 16
  const int row_a = r0 + 16 * warp + g;
  int q_blk[2];
  unsigned long long row_base[2];   // flat index of key 0 in [B, H, S, S]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_a + 8 * i;
    q_blk[i] = query_block(r, T_frames, mc, rc);
    row_base[i] = (((unsigned long long)b * drop.heads + h) * S + r) * S;
  }

  cp_async_wait<1>();                       // q has landed
  __syncthreads();
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    load_a<DH>(qf[ks], smem_u32(q_s), 16 * warp, ks, lane);
  }

  float o[DH / 8][4];
  zero_acc<DH>(o);
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};              // the lane's share of the row sum

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

    // s = q . k^T: 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        load_b<DH>(bk, k_tile, 16 * np, ks, lane);
        mma_bf16(s[2 * np], qf[ks], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }
    }

    // scale, key bias, layout mask; the tile's row maxima
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = 8 * n + 2 * t;
      const float2 bias = *reinterpret_cast<const float2*>(&km.bias[c]);
      const int2 lo = *reinterpret_cast<const int2*>(&km.lo[c]);
      const uint2 span = *reinterpret_cast<const uint2*>(&km.span[c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool second = i & 1;
        const bool forbidden =
            partial && !allowed(q_blk[i >> 1], second ? lo.y : lo.x,
                                second ? span.y : span.x);
        s[n][i] = logit(s[n][i], scale, second ? bias.y : bias.x, forbidden);
        tmax[i >> 1] = fmaxf(tmax[i >> 1], s[n][i]);
      }
    }

    // online softmax: every tile has an in-range key, so m_new is finite
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m_run[hh], quad_max(tmax[hh]));
      const float alpha = __expf(m_run[hh] - m_new);   // 0 on the first tile
      m_run[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float p0 = __expf(s[n][2 * hh] - m_new);
        const float p1 = __expf(s[n][2 * hh + 1] - m_new);
        s[n][2 * hh] = p0;
        s[n][2 * hh + 1] = p1;
        sum += p0 + p1;
      }
      l_run[hh] = l_run[hh] * alpha + sum;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[n][2 * hh] *= alpha;
        o[n][2 * hh + 1] *= alpha;
      }
    }

    if constexpr (kDrop) {
      // the value product takes p * keep; l above summed the plain p
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float keep[4];
        keep_rows_frag(drop, row_base, j0 + 8 * n, (S & 3) == 0, t, keep);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] *= keep[i];
      }
    }

    // o += p . v: p goes from the accumulator into the A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
      accumulate<DH>(o, pa, v_tile, kk, lane);
    }

    if (nxt < n_kt && tid < kTileRows) put_meta(stage ^ 1, nxt, nxt_padded);
    kt = nxt;
    stage ^= 1;
  }

  const float l_a = quad_sum(l_run[0]), l_b = quad_sum(l_run[1]);
  store_acc<DH>(out, base, D, row_a, S, t, o, 1.f / fmaxf(l_a, 1e-20f),
                1.f / fmaxf(l_b, 1e-20f));
  if (m_out != nullptr && t == 0) {
    const long stat0 = ((long)b * H + h) * S;
    if (row_a < S) {
      m_out[stat0 + row_a] = m_run[0];
      l_out[stat0 + row_a] = l_a;
    }
    if (row_a + 8 < S) {
      m_out[stat0 + row_a + 8] = m_run[1];
      l_out[stat0 + row_a + 8] = l_b;
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* key_pad, const signed char* kinds, void* out,
           float* m_out, float* l_out, int B, int S, int D, int H,
           int T_frames, int mc, int rc, const Dropout& drop,
           cudaStream_t stream) {
  auto kernel = drop.threshold ? flash_fwd_mma_kernel<DH, true>
                               : flash_fwd_mma_kernel<DH, false>;
  const size_t smem = fwd_smem_bytes<DH>();
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const dim3 grid((S + kTileRows - 1) / kTileRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, key_pad, kinds,
      (bf16*)out, m_out, l_out, S, D, T_frames, mc, rc,
      (float)(1.0 / sqrt((double)DH)), drop);
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments of w2vs_flash_attention (flash_attention.cu), with kinds the
// [ceil(S/64), ceil(S/64)] table of 64 x 64 tiles.  Takes bfloat16
// (dtype_code 1) with heads of 32, 64 or 128 dims and 16-byte aligned
// tensors; anything else is cudaErrorInvalidValue.
extern "C" int w2vs_flash_attention_mma(
    const void* q, const void* k, const void* v, const void* key_pad,
    const void* kinds, void* out, void* m_out, void* l_out, int B, int S,
    int D, int H, int T_frames, int mc, int rc, int dtype_code,
    unsigned long long seed, unsigned long long offset,
    unsigned long long base, int heads, unsigned threshold, double keep_scale,
    void* stream) {
  if (dtype_code != 1 || H < 1 || D % H || mc < 1 || rc < 0 ||
      (m_out == nullptr) != (l_out == nullptr) ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  if (heads < H) return (int)cudaErrorInvalidValue;
  const Dropout drop =
      make_dropout(seed, offset, base, heads, threshold, keep_scale);
#define W2VS_FWD(DH)                                                        \
  launch<DH>(q, k, v, (const unsigned char*)key_pad,                        \
             (const signed char*)kinds, out, (float*)m_out, (float*)l_out,  \
             B, S, D, H, T_frames, mc, rc, drop, (cudaStream_t)stream)
  switch (D / H) {
    case 32: return W2VS_FWD(32);
    case 64: return W2VS_FWD(64);
    case 128: return W2VS_FWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef W2VS_FWD
}
