// Block-sparse flash attention backward under the wav2vec-S block mask, for
// Hopper (sm_90a): the CUDA-core kernels, which float32 inputs and head
// widths other than 32, 64 and 128 take.  bfloat16 inputs at those widths
// (every full-size model) take the tensor-core kernels of
// flash_attention_bwd_mma.cu; ops/flash_attention.py chooses by dtype and
// head width alone.
//
// Replaces the Pallas TPU kernel wav2vec_s_tpu/ops/pallas_attention.py
// (_flash_attn_bwd, _bwd_kernel, with _keep_scale).  From the forward's
// inputs, its output and its saved row stats m, l (flash_attention.cu), for
// every stream b and head h of the packed [B, S, H*dh] tensors, with
// qs = q * dh**-0.5:
//   p(r, j)  = exp(qs_r . k_j + masks - m_r) / max(l_r, 1e-20)
//   keep     = 0 or 1/(1 - rate)         (attention dropout, or 1 without)
//   dvec_r   = sum_d do_r[d] * out_r[d]
//   dV_j     = sum_r p(r, j) keep(r, j) do_r
//   dp(r, j) = (do_r . v_j) keep(r, j)
//   ds(r, j) = p(r, j) (dp(r, j) - dvec_r)
//   dQ_r     = (sum_j ds(r, j) k_j) * dh**-0.5
//   dK_j     = sum_r ds(r, j) qs_r
// masks add NEG = -1e9 for pairs the block layout forbids and for padded
// keys, as in the forward; tiles without an allowed pair are skipped; every
// sum in f32; the gradients are written in the input type.  Neither
// probabilities nor the dropout mask reach device memory: the mask is
// regenerated from the element coordinates (flash_common.cuh).
//
// The TPU kernel walks its query tiles in sequence on one core and adds
// into dK/dV scratch that persists across grid steps.  Blocks here run in
// parallel and in no order, so the work is split into two kernels and no
// atomics (two runs of one step give the same bits):
//   - flash_dq_kernel, grid (query tiles of 32, H, B): loops the key tiles of
//     its row of the tile-kind table (the forward's 32 x 64 table), writes
//     dQ, and writes dvec for the other kernel;
//   - flash_dkv_kernel, grid (key tiles of 32, H, B): loops the query tiles
//     of 64 of its row of the transposed table (32 keys x 64 queries, built
//     by the wrapper from the transposed layout) and writes dK and dV.
// Each recomputes the logits of its tiles (4 of the 5 products run twice in
// all: q.k and do.v in both kernels).
//
// What bounds it: f32 arithmetic on the CUDA cores, chosen for exactness
// (held to 1e-5 of the largest gradient against the twin) and for head
// widths the tensor-core tiles do not divide, not for speed.  At B 8, S 748,
// 12 heads of 64 the allowed pairs are ~35% of S*S: 5 products x 2 x 748^2 x
// 64 x 96 x 0.355 = 12 GFLOP needed (0.18 ms at the 67 TFLOP/s f32 peak)
// against 8 packed tensors of 9.2 MB (0.02 ms of device memory); the two
// kernels compute 7 products over ~50% of S*S with the forward's
// register-blocked FMAs (4 rows x 2 columns per lane).  Operands are widened
// to f32 in shared memory, transposed and row-major as each product reads
// them: 74 KB (dQ) and 98 KB (dK/dV) per block at dh 64, 140 KB and 180 KB
// at dh 128, opted in with cudaFuncSetAttribute, so 2 blocks fit an SM.
//
// Plain C interface (loaded with ctypes): w2vs_flash_attention_bwd returns
// the first CUDA error of its attribute calls and launches, 0 if none.

#include "flash_common.cuh"

namespace {

using namespace w2vs_flash;

constexpr int kPFloats = kWarps * kTile * kRowsPerWarp;   // one p_s array

// dQ kernel, in floats:
//   ds_s [kWarps][kTile][4]   ds, float4 of the warp's rows per key
//   q_t, do_t [dh][kRows]     query rows (scaled) and their cotangents
//   k_t, v_t [dh][kKStride]   key / value tile, transposed
//   k_s [kTile][dv]           key tile, row-major (for ds . k)
__host__ __device__ constexpr int dq_smem_floats(int dh, int dv) {
  return kPFloats + 2 * dh * kRows + 2 * dh * kKStride + kTile * dv;
}
// dK/dV kernel, in floats:
//   pt_s, ds_s [kWarps][kTile][4]   p * keep and ds, float4 of the warp's key
//                                   rows per query
//   k_rt, v_rt [dh][kRows]          key / value rows, transposed
//   q_tt, do_tt [dh][kKStride]      query tile (scaled) and cotangents,
//                                   transposed
//   q_s, do_s [kTile][dv]           the same, row-major (for ds^T . qs and
//                                   pt^T . do)
__host__ __device__ constexpr int dkv_smem_floats(int dh, int dv) {
  return 2 * kPFloats + 2 * dh * kRows + 2 * dh * kKStride + 2 * kTile * dv;
}

// grid (query tiles, H, B); block kWarps * 32 threads
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ out,
                const T* __restrict__ dout, const float* __restrict__ m_in,
                const float* __restrict__ l_in,
                const unsigned char* __restrict__ key_pad,
                const signed char* __restrict__ kinds, T* __restrict__ dq,
                float* __restrict__ dvec_out, int S, int D, int dh,
                int T_frames, int mc, int rc, float scale, Dropout drop) {
  extern __shared__ float4 smem4[];
  const int dv = (dh + 1) & ~1;
  float* ds_s = reinterpret_cast<float*>(smem4);
  float* q_t = ds_s + kPFloats;
  float* do_t = q_t + dh * kRows;
  float* k_t = do_t + dh * kRows;
  float* v_t = k_t + dh * kKStride;
  float* k_s = v_t + dh * kKStride;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = qt * kRows;
  const int n_q = min(kRows, S - r0);
  const int n_kt = (S + kTile - 1) / kTile;
  const long base = (long)b * S * D + (long)h * dh;   // row 0 of (b, h)
  const long stat0 = ((long)b * H + h) * S;           // row 0 of m, l, dvec
  const unsigned char* pad = key_pad + (long)b * S;

  load_rows_t(q_t, q, base, r0, n_q, dh, D, scale);
  load_rows_t(do_t, dout, base, r0, n_q, dh, D, 1.f);

  // the warp's rows: block index, row stats, dvec = do . out (written out for
  // the dK/dV kernel).  A row past S gets m = +inf, so its p is exp(-inf) = 0.
  const int wr = warp * kRowsPerWarp;
  int q_blk[kRowsPerWarp];
  float m[kRowsPerWarp], inv_l[kRowsPerWarp], dvec[kRowsPerWarp];
  unsigned long long row_base[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + wr + i;
    q_blk[i] = query_block(r, T_frames, mc, rc);
    row_base[i] = (((unsigned long long)b * drop.heads + h) * S + r) * S;
    m[i] = INFINITY;
    inv_l[i] = 0.f;
    float part = 0.f;
    if (r < S) {
      m[i] = m_in[stat0 + r];
      inv_l[i] = 1.f / fmaxf(l_in[stat0 + r], 1e-20f);
      const long row = base + (long)r * D;
      for (int d = lane; d < dh; d += 32) {
        part = fmaf(to_float(dout[row + d]), to_float(out[row + d]), part);
      }
    }
    dvec[i] = warp_sum(part);
    if (r < S && lane == 0) dvec_out[stat0 + r] = dvec[i];
  }

  float acc[kRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }

  const signed char* kind_row = kinds + (long)qt * n_kt;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int kind = kind_row[kt];         // the same for the whole block
    if (kind == 0) continue;               // no allowed pair: skipped
    const int j0 = kt * kTile;
    const int n_k = min(kTile, S - j0);    // >= 1
    __syncthreads();                       // the previous tile is consumed
    load_tile(k_t, k_s, k, base, j0, n_k, dh, dv, D, 1.f);
    load_tile<T>(v_t, nullptr, v, base, j0, n_k, dh, dv, D, 1.f);
    __syncthreads();

    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
    tile_scores(q_t, k_t, wr, lane, dh, s);
    tile_scores(do_t, v_t, wr, lane, dh, dp);
    float keep[kRowsPerWarp][2];
    if (kDrop) {
      keep_query_rows(drop, row_base, j0 + 2 * lane, (S & 3) == 0, lane, keep);
    }

    float4* ds4 = reinterpret_cast<float4*>(ds_s) + warp * kTile;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 2 * lane + c;
      const int key = j0 + j;
      const bool in = j < n_k;
      const float key_bias = (in && pad[key]) ? kNeg : 0.f;
      const bool copy = key >= T_frames;
      const int k_blk = in ? key_block(key, T_frames, mc, rc) : 0;
      float ds[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        float x = s[i][c] + key_bias;
        if (kind == 2 && !pair_allowed(q_blk[i], k_blk, copy)) x += kNeg;
        const float p = in ? expf(x - m[i]) * inv_l[i] : 0.f;
        const float g = kDrop ? dp[i][c] * keep[i][c] : dp[i][c];
        ds[i] = in ? p * (g - dvec[i]) : 0.f;
      }
      ds4[j] = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();
    tile_accumulate(ds4, k_s, n_k, lane, dh, dv, acc);     // dq += ds . k
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = wr + i;
    if (r < n_q) {
      store_row(dq + base + (long)(r0 + r) * D, acc[i], scale, lane, dh);
    }
  }
}

// grid (key tiles of kRows, H, B); block kWarps * 32 threads.  kinds_t is the
// table of the transposed layout: [key tiles of 32][query tiles of 64].
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ m_in,
                 const float* __restrict__ l_in,
                 const float* __restrict__ dvec_in,
                 const unsigned char* __restrict__ key_pad,
                 const signed char* __restrict__ kinds_t,
                 T* __restrict__ dk, T* __restrict__ dv_out, int S, int D,
                 int dh, int T_frames, int mc, int rc, float scale,
                 Dropout drop) {
  extern __shared__ float4 smem4[];
  const int dv = (dh + 1) & ~1;
  float* pt_s = reinterpret_cast<float*>(smem4);
  float* ds_s = pt_s + kPFloats;
  float* k_rt = ds_s + kPFloats;
  float* v_rt = k_rt + dh * kRows;
  float* q_tt = v_rt + dh * kRows;
  float* do_tt = q_tt + dh * kKStride;
  float* q_s = do_tt + dh * kKStride;
  float* do_s = q_s + kTile * dv;

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = kt * kRows;
  const int n_k = min(kRows, S - k0);
  const int n_qt = (S + kTile - 1) / kTile;
  const long base = (long)b * S * D + (long)h * dh;   // row 0 of (b, h)
  const long stat0 = ((long)b * H + h) * S;           // row 0 of m, l, dvec
  const unsigned char* pad = key_pad + (long)b * S;

  load_rows_t(k_rt, k, base, k0, n_k, dh, D, 1.f);
  load_rows_t(v_rt, v, base, k0, n_k, dh, D, 1.f);

  // the warp's key rows
  const int wr = warp * kRowsPerWarp;
  float key_bias[kRowsPerWarp];
  int k_blk[kRowsPerWarp];
  bool copy[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int key = k0 + wr + i;
    const bool in = key < S;
    key_bias[i] = (in && pad[key]) ? kNeg : 0.f;
    copy[i] = key >= T_frames;
    k_blk[i] = in ? key_block(key, T_frames, mc, rc) : 0;
  }

  float acc_k[kRowsPerWarp][4], acc_v[kRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;
  }

  const signed char* kind_row = kinds_t + (long)kt * n_qt;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int kind = kind_row[qt];         // the same for the whole block
    if (kind == 0) continue;               // no allowed pair: skipped
    const int q0 = qt * kTile;
    const int n_q = min(kTile, S - q0);    // >= 1
    __syncthreads();                       // the previous tile is consumed
    load_tile(q_tt, q_s, q, base, q0, n_q, dh, dv, D, scale);
    load_tile(do_tt, do_s, dout, base, q0, n_q, dh, dv, D, 1.f);
    __syncthreads();

    // the lane's two queries
    float m[2], inv_l[2], dvec[2];
    int q_blk[2];
    bool in[2];
    unsigned long long query_base[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = q0 + 2 * lane + c;
      in[c] = 2 * lane + c < n_q;
      m[c] = in[c] ? m_in[stat0 + r] : INFINITY;
      inv_l[c] = in[c] ? 1.f / fmaxf(l_in[stat0 + r], 1e-20f) : 0.f;
      dvec[c] = in[c] ? dvec_in[stat0 + r] : 0.f;
      q_blk[c] = query_block(r, T_frames, mc, rc);
      query_base[c] = (((unsigned long long)b * drop.heads + h) * S + r) * S;
    }

    // s[i][c] = k_(wr+i) . qs_(2*lane+c), dp[i][c] = v_(wr+i) . do_(2*lane+c)
    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
    tile_scores(k_rt, q_tt, wr, lane, dh, s);
    tile_scores(v_rt, do_tt, wr, lane, dh, dp);
    float keep[kRowsPerWarp][2];
    if (kDrop) keep_key_rows(drop, query_base, k0 + wr, (S & 3) == 0, keep);

    float4* pt4 = reinterpret_cast<float4*>(pt_s) + warp * kTile;
    float4* ds4 = reinterpret_cast<float4*>(ds_s) + warp * kTile;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float pt[kRowsPerWarp], ds[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        float x = s[i][c] + key_bias[i];
        if (kind == 2 && !pair_allowed(q_blk[c], k_blk[i], copy[i])) x += kNeg;
        const float p = in[c] ? expf(x - m[c]) * inv_l[c] : 0.f;
        const float kp = kDrop ? keep[i][c] : 1.f;
        pt[i] = p * kp;
        ds[i] = in[c] ? p * (dp[i][c] * kp - dvec[c]) : 0.f;
      }
      pt4[2 * lane + c] = make_float4(pt[0], pt[1], pt[2], pt[3]);
      ds4[2 * lane + c] = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();
    tile_accumulate(pt4, do_s, n_q, lane, dh, dv, acc_v);  // dv += pt^T . do
    tile_accumulate(ds4, q_s, n_q, lane, dh, dv, acc_k);   // dk += ds^T . qs
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = wr + i;
    if (r < n_k) {
      const long row = base + (long)(k0 + r) * D;
      store_row(dk + row, acc_k[i], 1.f, lane, dh);
      store_row(dv_out + row, acc_v[i], 1.f, lane, dh);
    }
  }
}

template <typename T, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* m, const float* l,
           const unsigned char* key_pad, const signed char* kinds,
           const signed char* kinds_t, void* dq, void* dk, void* dv,
           float* dvec, int B, int S, int D, int H, int T_frames, int mc,
           int rc, const Dropout& drop, cudaStream_t stream) {
  const int dh = D / H;
  const int dvw = (dh + 1) & ~1;
  const float scale = (float)(1.0 / sqrt((double)dh));
  const dim3 grid((S + kRows - 1) / kRows, H, B);

  auto dq_kernel = flash_dq_kernel<T, kDrop>;
  const size_t dq_smem = dq_smem_floats(dh, dvw) * sizeof(float);
  int err = allow_smem(dq_kernel, dq_smem);
  if (err) return err;
  dq_kernel<<<grid, kWarps * 32, dq_smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)out, (const T*)dout, m,
      l, key_pad, kinds, (T*)dq, dvec, S, D, dh, T_frames, mc, rc, scale,
      drop);
  err = (int)cudaGetLastError();
  if (err) return err;

  auto dkv_kernel = flash_dkv_kernel<T, kDrop>;
  const size_t dkv_smem = dkv_smem_floats(dh, dvw) * sizeof(float);
  err = allow_smem(dkv_kernel, dkv_smem);
  if (err) return err;
  dkv_kernel<<<grid, kWarps * 32, dkv_smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, l, dvec,
      key_pad, kinds_t, (T*)dk, (T*)dv, S, D, dh, T_frames, mc, rc, scale,
      drop);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv: [B, S, D] packed (head h at columns h*dh);
// m, l, dvec: [B, H, S] f32 (dvec is scratch the call fills); key_pad:
// [B, S] bool (1 = padded key); kinds: [ceil(S/32), ceil(S/64)] int8 tile
// kinds of the layout (query tiles x key tiles), kinds_t the same table of
// the transposed layout (key tiles x query tiles); all contiguous, on the
// current device.  dtype_code 0 is float32, 1 is bfloat16.  Attention
// dropout as in w2vs_flash_attention: threshold 0 means none.
extern "C" int w2vs_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* m, const void* l, const void* key_pad,
    const void* kinds, const void* kinds_t, void* dq, void* dk, void* dv,
    void* dvec, int B, int S, int D, int H, int T_frames, int mc, int rc,
    int dtype_code, unsigned long long seed, unsigned long long offset,
    unsigned long long base, int heads, unsigned threshold, double keep_scale,
    void* stream) {
  if (H < 1 || D % H || D / H > kMaxDh || mc < 1 || rc < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (heads < H) return (int)cudaErrorInvalidValue;
  const Dropout drop =
      make_dropout(seed, offset, base, heads, threshold, keep_scale);
#define W2VS_BWD(T, DROP)                                                     \
  launch<T, DROP>(q, k, v, out, dout, (const float*)m, (const float*)l,      \
                  (const unsigned char*)key_pad, (const signed char*)kinds,  \
                  (const signed char*)kinds_t, dq, dk, dv, (float*)dvec, B,  \
                  S, D, H, T_frames, mc, rc, drop, s)
  if (dtype_code == 1) {
    return threshold ? W2VS_BWD(__nv_bfloat16, true)
                     : W2VS_BWD(__nv_bfloat16, false);
  }
  return threshold ? W2VS_BWD(float, true) : W2VS_BWD(float, false);
#undef W2VS_BWD
}
