// Block-sparse flash attention forward under the wav2vec-S block mask, for
// Hopper (sm_90a): the CUDA-core kernel, which float32 inputs and head
// widths other than 32, 64 and 128 take.  bfloat16 inputs at those widths
// (every full-size model) take the tensor-core kernel of
// flash_attention_mma.cu; ops/flash_attention.py chooses by dtype and head
// width alone.
//
// Replaces the forward of the Pallas TPU kernel
// wav2vec_s_tpu/ops/pallas_attention.py (_flash_attn_impl, _kernel,
// _tile_plan).  For every stream b, head h and query row r of the packed
// [B, S, H*dh] projections (S = T frames + the rc look-ahead copies):
//   s(r, j) = (q_r * dh**-0.5) . k_j  + NEG if (r, j) is not allowed by the
//                                           block layout
//                                     + NEG if key j is padded
//   out_r   = softmax_j(s(r, .)) . v,  m_r = max_j s,  l_r = sum_j exp(s - m_r)
// with NEG = -1e9, an online softmax and every sum in f32; out is cast to the
// input type, m and l (the backward's row stats) are written as f32 when their
// pointers are not null.  Neither logits nor probabilities reach device
// memory.
//
// Attention dropout (training; the TPU kernel's _keep_scale) acts on the
// normalised probabilities: l sums the plain p, the value product takes
// p * keep with keep 0 or 1/(1 - rate), so m and l are the same with and
// without it.  The mask is a function of the element's coordinates
// (flash_common.cuh), which the backward kernels regenerate.  The kernel is
// compiled twice: without dropout (threshold 0) it is the inference kernel,
// instruction for instruction.
//
// The layout rule (wav2vec_s_tpu/ops/block_mask.py:40-80): index i < T is
// frame i of block i / mc; index i >= T is an rc copy of block (i - T) / rc.
// A query of (effective) block qb may attend frame key j iff qb >= j / mc,
// and copy key j iff qb == (j - T) / rc.
//
// What bounds it: f32 arithmetic on the CUDA cores.  It exists for exactness
// (every product and sum in f32, held to 1e-4 against the twin) and for the
// head widths the tensor-core tiles do not divide (the tiny parity models
// run heads of 6 and 8), not for speed: at B 32, S 728, 12 heads of 64 the
// allowed pairs are 35.5% of S*S, 18.5 GFLOP for q.k plus p.v, ~0.28 ms at
// the 67 TFLOP/s f32 peak against ~0.04 ms of device-memory traffic, and
// register-blocked FMAs reach about a quarter of that peak.
//
// What the design does about it:
// - tiles the card can skip are skipped: the wrapper builds, once per layout,
//   a table of the 32-row x 64-key tiles (skip, full or partial; 143 of the
//   276 tiles at that call are skipped, the computed pairs fall to ~50% of
//   S*S from the 128x128 TPU tiling's 69%);
// - the packed layout is read directly (head h at column h*dh): no per-head
//   relayout copies;
// - in partial tiles the mask comes from the layout rule above (integer
//   compares on block indices), not from a bias buffer;
// - the products are register-blocked as in chunk_attention.cu: each lane
//   scores 2 keys against its warp's 4 rows and accumulates 4 rows x 2
//   output dims per (broadcast p, 8-byte v) pair; inputs are widened to f32
//   in shared memory, so bfloat16 at an odd head width runs here too.
//
// Plain C interface (loaded with ctypes): w2vs_flash_attention returns the
// cudaGetLastError() code of its launch.

#include "flash_common.cuh"

namespace {

using namespace w2vs_flash;

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

// grid (query tiles, H, B); block kWarps * 32 threads
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const unsigned char* __restrict__ key_pad,
                       const signed char* __restrict__ kinds,
                       T* __restrict__ out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int S, int D, int dh,
                       int T_frames, int mc, int rc, float scale,
                       Dropout drop) {
  extern __shared__ float4 smem4[];
  const int dv = (dh + 1) & ~1;
  float* p_s = reinterpret_cast<float*>(smem4);
  float* q_t = p_s + kWarps * kTile * kRowsPerWarp;
  float* k_t = q_t + dh * kRows;
  float* v_s = k_t + dh * kKStride;

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
  const unsigned char* pad = key_pad + (long)b * S;

  // query rows, transposed and pre-scaled; rows past S are zero (scored,
  // never stored)
  for (int i = threadIdx.x; i < kRows * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh;
    q_t[d * kRows + r] =
        r < n_q ? to_float(q[base + (long)(r0 + r) * D + d]) * scale : 0.f;
  }

  // effective block of the warp's rows (a copy row counts in its block)
  const int wr = warp * kRowsPerWarp;      // the warp's first row in the tile
  int q_blk[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + wr + i;
    q_blk[i] = query_block(r, T_frames, mc, rc);
  }
  // flat index of key 0 of each row in the [B, H, S, S] probabilities
  unsigned long long row_base[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    row_base[i] =
        (((unsigned long long)b * drop.heads + h) * S + (r0 + wr + i)) * S;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
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
    for (int i = threadIdx.x; i < n_k * dh; i += blockDim.x) {
      const int j = i / dh, d = i - j * dh;
      const long src = base + (long)(j0 + j) * D + d;
      k_t[d * kKStride + j] = to_float(k[src]);
      v_s[j * dv + d] = to_float(v[src]);
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

    // masks: key padding always, the layout rule in partial tiles; keys
    // past S are no keys at all (exp(-inf - m) == 0)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 2 * lane + c;
      const int key = j0 + j;
      const bool in = j < n_k;
      const float key_bias = (in && pad[key]) ? kNeg : 0.f;
      const bool copy = key >= T_frames;
      const int k_blk = in ? key_block(key, T_frames, mc, rc) : 0;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        float x = -INFINITY;
        if (in) {
          x = s[i][c] + key_bias;
          if (kind == 2 && !pair_allowed(q_blk[i], k_blk, copy)) x += kNeg;
        }
        s[i][c] = x;
      }
    }

    float4* p4 = reinterpret_cast<float4*>(p_s) + warp * kTile;
    float p[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);   // 0 on the first tile
      p[i][0] = expf(s[i][0] - m_new);
      p[i][1] = expf(s[i][1] - m_new);
      l[i] = l[i] * alpha + warp_sum(p[i][0] + p[i][1]);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
    }
    if (kDrop) {
      // the value product takes p * keep; l above summed the plain p
      float keep[kRowsPerWarp][2];
      keep_query_rows(drop, row_base, j0 + 2 * lane, (S & 3) == 0, lane, keep);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        p[i][0] *= keep[i][0];
        p[i][1] *= keep[i][1];
      }
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
      T* o = out + base + (long)(r0 + r) * D;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 2 * lane + (e & 1) + 64 * (e >> 1);
        if (d < dh) store(o + d, acc[i][e] * inv);
      }
      if (lane == 0 && m_out != nullptr) {
        const long row = ((long)b * H + h) * S + r0 + r;
        m_out[row] = m[i];
        l_out[row] = l[i];
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* key_pad, const signed char* kinds, void* out,
           float* m_out, float* l_out, int B, int S, int D, int H,
           int T_frames, int mc, int rc, const Dropout& drop,
           cudaStream_t stream) {
  const int dh = D / H;
  if (dh > kMaxDh || dh < 1 || mc < 1 || rc < 0 ||
      (m_out == nullptr) != (l_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_floats(dh, (dh + 1) & ~1) * sizeof(float);
  auto kernel = drop.threshold ? flash_attention_kernel<T, true>
                               : flash_attention_kernel<T, false>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, key_pad, kinds, (T*)out, m_out,
      l_out, S, D, dh, T_frames, mc, rc, (float)(1.0 / sqrt((double)dh)),
      drop);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, S, D] packed (head h at columns h*dh); key_pad: [B, S]
// bool (1 = padded key); kinds: [ceil(S/32), ceil(S/64)] int8 tile kinds;
// m_out, l_out: [B, H, S] f32, both null or both set; all contiguous, on the
// current device.  dtype_code 0 is float32, 1 is bfloat16.  Attention dropout:
// threshold = ceil(rate * 2^24) (0: none), keep_scale = 1 / (1 - rate), under
// the step seed and the site offset; heads: the whole probabilities' head
// count (H unsharded; at least H); base: the flat index of element
// (0, 0, 0, 0) in the probabilities of the whole batch ((b0 * heads + h0) *
// S * S for a shard whose first row is row b0 and first head head h0; 0
// unsharded).
extern "C" int w2vs_flash_attention(const void* q, const void* k,
                                    const void* v, const void* key_pad,
                                    const void* kinds, void* out, void* m_out,
                                    void* l_out, int B, int S, int D, int H,
                                    int T_frames, int mc, int rc,
                                    int dtype_code, unsigned long long seed,
                                    unsigned long long offset,
                                    unsigned long long base, int heads,
                                    unsigned threshold, double keep_scale,
                                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* pad = (const unsigned char*)key_pad;
  const auto* kd = (const signed char*)kinds;
  if (heads < H) return (int)cudaErrorInvalidValue;
  const Dropout drop =
      make_dropout(seed, offset, base, heads, threshold, keep_scale);
  if (dtype_code == 1) {
    return launch<__nv_bfloat16>(q, k, v, pad, kd, out, (float*)m_out,
                                 (float*)l_out, B, S, D, H, T_frames, mc, rc,
                                 drop, s);
  }
  return launch<float>(q, k, v, pad, kd, out, (float*)m_out, (float*)l_out,
                       B, S, D, H, T_frames, mc, rc, drop, s);
}
