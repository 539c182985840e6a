// One-query attention over a time-major K/V cache, for Hopper (sm_90a), on
// the CUDA cores: the attention of the greedy emission loop (the jointer's
// encoder attention and the LM's self-attention, stream/caat_step.py).
//
// Replaces no TPU kernel: the JAX package left these attentions to XLA
// (wav2vec_s_tpu/stream/caat_step.py, jointer_step, _attend_slots,
// _attend_one), and the port ran them as plain torch, which cast the whole
// cache to f32 on every call and read every row of it, masked or not.  For
// every stream n and head h (Dh = D / H, any Dh <= 128):
//   rows   = lo[n] <= t < hi[n]                     (only these are loaded)
//   logit  = (q[n, h] . k[t, n, h]) * Dh**-0.5      (f32 sums of products)
//            + (plane[n, t] ? 0 : mask_value)       (where a plane is given)
//   p      = softmax over the rows, in f32, rounded to the input dtype
//   out    = sum_t p[t] * v[t, n, h]                (f32 sums), in the dtype
// A stream with no row loaded, or none the plane shows, gets zeros.  Rows
// outside [lo, hi) would add exp(mask_value + l - m) == 0 in f32, so leaving
// them out changes nothing.  A row the plane hides adds exp(mask_value + l -
// m) == 0 as well, whatever its l, so its logit is mask_value alone and
// neither its K nor its V is read; rows whose rounded p is 0 add exactly 0
// to P.V, so their V is not read either.
//
// What bounds it: memory.  Each visible (key, value) row of a head is 4*Dh
// bytes in bf16 and serves 2*Dh multiply-adds: about 1 flop a byte, so the
// bound is the rows loaded and visible x D x 2 bytes x 2 (K and V), plus a
// byte of the plane for each row of the range, over 3.35 TB/s.
//
// What the design does about it:
// - one block per (stream, group of heads): the group's slice of a row is
//   contiguous (4 heads of 64 bf16 = 512 bytes), one warp reads one row,
//   16 bytes a lane, so every load is a full coalesced row;
// - each warp keeps 4 rows of loads in flight before it uses them (8 warps:
//   16 KB a block), and a block of a full serving step lives beside ~5
//   others on its SM, which keeps ~100 KB a SM in flight, more than the
//   card's bandwidth-latency product needs; no TMA or cp.async ring is
//   needed for that;
// - where a plane is given, the block first reads its bytes for the row
//   range into shared memory (one coalesced pass), so that no K load waits
//   on a plane byte and a stream that sees nothing returns at once;
// - the whole row range stays in the block: phase 1 streams K into f32
//   logits in shared memory (1024 rows x 4 heads = 16 KB), the softmax is
//   exact and two-phase (max, then sum, then the normalised p rounded to the
//   input dtype, as the plain version rounds it), phase 2 streams V and
//   accumulates P.V in f32 registers; no split of the rows, no second pass
//   over device memory;
// - lanes of one head sum their partial dot products by warp shuffles;
//   the warps' P.V partial sums meet once in shared memory at the end.
// Row bounds and the plane are read on the device, so a CUDA graph of the
// emission loop replays the kernel with whatever bounds the step left.
//
// Plain C interface (loaded with ctypes): w2vs_decode_attention returns the
// cudaGetLastError() code of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kUnroll = 4;         // rows in flight per warp
constexpr int kMaxDh = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// a lane's EPL elements of one row: one 16-byte load (kVec) or EPL scalar
// loads, the last ones cut at the head's edge
template <typename T, int EPL, bool kVec>
struct Chunk {
  static_assert(!kVec || EPL * sizeof(T) == 16, "vector chunks are 16 bytes");
  float x[EPL];

  __device__ __forceinline__ void load(const T* p, bool ok, int n_valid) {
    if (kVec) {
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (ok) raw = __ldg(reinterpret_cast<const uint4*>(p));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < EPL; ++i) x[i] = to_float(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        x[i] = (ok && i < n_valid) ? to_float(p[i]) : 0.f;
      }
    }
  }
};

// A lane's place in a block's head group: LPH lanes per head, G heads per
// warp-wide row; lane covers elements [j * EPL, j * EPL + EPL) of head
// g * G + hg.
struct Lanes {
  int hg, j, head, col, n_valid;
  bool active;
};

template <int EPL>
__device__ __forceinline__ Lanes lanes_of(int lane, int g, int G, int LPH,
                                          int H, int Dh) {
  Lanes l;
  l.hg = lane / LPH;
  l.j = lane % LPH;
  l.head = g * G + l.hg;
  l.n_valid = min(EPL, Dh - l.j * EPL);
  l.active = l.hg < G && l.head < H && l.n_valid > 0;
  l.col = l.head * Dh + l.j * EPL;
  return l;
}

template <typename T, int EPL, bool kVec>
__global__ void __launch_bounds__(kWarps * 32) decode_attention_kernel(
    const T* __restrict__ q, long long q_stride, const T* __restrict__ k,
    const T* __restrict__ v, const int64_t* __restrict__ lo, int lo_stride,
    const int64_t* __restrict__ hi, int hi_stride,
    const unsigned char* __restrict__ plane, long long plane_n,
    long long plane_t, float mask_value, T* __restrict__ out, int T_rows,
    int N, int D, int H, int Dh, int G, int LPH, int groups, float scale) {
  extern __shared__ float smem[];
  float* logit = smem;                          // [G][T_rows]
  float* red = smem + (size_t)G * T_rows;       // [kWarps][32 * EPL]
  unsigned char* shown = reinterpret_cast<unsigned char*>(
      red + kWarps * 32 * EPL);                 // [T_rows], with a plane

  const int n = blockIdx.x / groups, g = blockIdx.x % groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Lanes me = lanes_of<EPL>(lane, g, G, LPH, H, Dh);

  long long r_lo = lo ? lo[(long long)n * lo_stride] : 0;
  long long r_hi = hi ? hi[(long long)n * hi_stride] : T_rows;
  r_lo = r_lo < 0 ? 0 : r_lo;
  r_hi = r_hi > T_rows ? T_rows : r_hi;
  const int rows = r_hi > r_lo ? (int)(r_hi - r_lo) : 0;
  T* o = out + (long long)n * D;

  // the plane's bytes of the range, once: 1 where the row is visible
  int any_seen = rows > 0;
  if (plane) {
    int seen = 0;
    for (int r = threadIdx.x; r < rows; r += kWarps * 32) {
      const unsigned char s =
          plane[(long long)n * plane_n + (r_lo + r) * plane_t] != 0;
      shown[r] = s;
      seen |= s;
    }
    any_seen = __syncthreads_or(seen);
  }
  if (!any_seen) {                              // nothing to attend: zeros
    for (int i = threadIdx.x; i < G * Dh; i += kWarps * 32) {
      const int h = g * G + i / Dh;
      if (h < H) store(o + h * Dh + i % Dh, 0.f);
    }
    return;
  }

  // phase 1: the visible rows' K -> logits in shared memory; a hidden row's
  // logit is mask_value, its K not read
  {
    Chunk<T, EPL, kVec> qc;
    qc.load(q + (long long)n * q_stride + me.col, me.active, me.n_valid);
    const long long row_stride = (long long)N * D;
    const T* kb = k + (r_lo * N + n) * (long long)D + me.col;
    for (int r0 = warp * kUnroll; r0 < rows; r0 += kWarps * kUnroll) {
      Chunk<T, EPL, kVec> kc[kUnroll];
      bool vis[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u;
        vis[u] = r < rows && (plane == nullptr || shown[r]);
        kc[u].load(kb + r * row_stride, me.active && vis[u], me.n_valid);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) s = fmaf(qc.x[i], kc[u].x[i], s);
        for (int off = LPH >> 1; off > 0; off >>= 1) {
          s += __shfl_xor_sync(kFull, s, off);
        }
        const int r = r0 + u;
        if (me.active && me.j == 0 && r < rows) {
          logit[me.hg * T_rows + r] = vis[u] ? s * scale : mask_value;
        }
      }
    }
  }
  __syncthreads();

  // softmax of each head's row of logits, one warp a head: max, the sum of
  // exp(l - max), then p = exp(l - max) / sum rounded to the input dtype
  for (int hh = warp; hh < G; hh += kWarps) {
    if (g * G + hh >= H) break;
    float* L = logit + hh * T_rows;
    float m = -INFINITY;
    for (int r = lane; r < rows; r += 32) m = fmaxf(m, L[r]);
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    }
    float sum = 0.f;
    for (int r = lane; r < rows; r += 32) {
      const float e = expf(L[r] - m);
      L[r] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
    }
    for (int r = lane; r < rows; r += 32) {
      L[r] = round_to(L[r] / sum, (T*)nullptr);
    }
  }
  __syncthreads();

  // phase 2: V, weighted by p, summed in f32; a row whose p is 0 for every
  // head of the warp adds exactly 0 and is not read
  float acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;
  const T* vb = v + (r_lo * N + n) * (long long)D + me.col;
  const long long row_stride = (long long)N * D;
  for (int r0 = warp * kUnroll; r0 < rows; r0 += kWarps * kUnroll) {
    Chunk<T, EPL, kVec> vc[kUnroll];
    float p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u;
      p[u] = (me.active && r < rows) ? logit[me.hg * T_rows + r] : 0.f;
      const bool need = __any_sync(kFull, p[u] != 0.f);
      vc[u].load(vb + r * row_stride, need && me.active && r < rows,
                 me.n_valid);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[i] = fmaf(p[u], vc[u].x[i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) red[(warp * 32 + lane) * EPL + i] = acc[i];
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * EPL; i += kWarps * 32) {
    const Lanes at = lanes_of<EPL>(i / EPL, g, G, LPH, H, Dh);
    const int e = i % EPL;
    if (!at.active || e >= at.n_valid) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * 32 * EPL + i];
    store(o + at.col + e, s);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <typename T, int EPL, bool kVec>
int launch_as(const void* q, long long q_stride, const void* k, const void* v,
              const int64_t* lo, int lo_stride, const int64_t* hi,
              int hi_stride, const unsigned char* plane, long long plane_n,
              long long plane_t, float mask_value, float scale, void* out,
              int T_rows, int N, int D, int H, int LPH, cudaStream_t stream) {
  const int Dh = D / H;
  const int G = min(H, 32 / LPH);
  const int groups = (H + G - 1) / G;
  const size_t smem =
      ((size_t)G * T_rows + (size_t)kWarps * 32 * EPL) * sizeof(float) +
      (plane ? (size_t)T_rows : 0);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = decode_attention_kernel<T, EPL, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<N * groups, kWarps * 32, smem, stream>>>(
      (const T*)q, q_stride, (const T*)k, (const T*)v, lo, lo_stride, hi,
      hi_stride, plane, plane_n, plane_t, mask_value, (T*)out, T_rows, N, D,
      H, Dh, G, LPH, groups, scale);
  return (int)cudaGetLastError();
}

// 16-byte loads where the head width splits into a power of two of 16-byte
// chunks and every row starts on a 16-byte boundary; else 4 elements a lane,
// one at a time (the tiny models' heads of 6)
template <typename T>
int launch(const void* q, long long q_stride, const void* k, const void* v,
           const int64_t* lo, int lo_stride, const int64_t* hi, int hi_stride,
           const unsigned char* plane, long long plane_n, long long plane_t,
           float mask_value, float scale, void* out, int T_rows, int N, int D,
           int H, cudaStream_t stream) {
  constexpr int kVecElems = 16 / sizeof(T);
  const int Dh = D / H;
  if (Dh > kMaxDh || Dh * H != D || N <= 0 || T_rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int lph = Dh / kVecElems;
  const bool vec = Dh % kVecElems == 0 && next_pow2(lph) == lph &&
                   lph <= 32 && D % kVecElems == 0 &&
                   q_stride % kVecElems == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v);
  if (vec) {
    return launch_as<T, kVecElems, true>(q, q_stride, k, v, lo, lo_stride, hi,
                                         hi_stride, plane, plane_n, plane_t,
                                         mask_value, scale, out, T_rows, N, D,
                                         H, lph, stream);
  }
  return launch_as<T, 4, false>(q, q_stride, k, v, lo, lo_stride, hi,
                                hi_stride, plane, plane_n, plane_t, mask_value,
                                scale, out, T_rows, N, D, H,
                                next_pow2((Dh + 3) / 4), stream);
}

}  // namespace

// q: [N, D] rows q_stride elements apart; k, v: [T_rows, N, D] contiguous;
// lo, hi: int64 row bounds, element n at n * stride (stride 0: one bound for
// every stream; lo null: 0; hi null: T_rows); plane: bool [N, T_rows] at
// (plane_n, plane_t) element strides, or null; out: [N, D] contiguous; all on
// the current device; scale: Dh**-0.5 as the caller rounds it to f32.
// dtype_code 0 is float32, 1 is bfloat16 (q, k, v and out alike).
extern "C" int w2vs_decode_attention(const void* q, long long q_stride,
                                     const void* k, const void* v,
                                     const void* lo, int lo_stride,
                                     const void* hi, int hi_stride,
                                     const void* plane, long long plane_n,
                                     long long plane_t, float mask_value,
                                     float scale, void* out, int T_rows,
                                     int N, int D, int H, int dtype_code,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t* lo_p = (const int64_t*)lo;
  const int64_t* hi_p = (const int64_t*)hi;
  const unsigned char* pl = (const unsigned char*)plane;
  if (dtype_code == 1) {
    return launch<__nv_bfloat16>(q, q_stride, k, v, lo_p, lo_stride, hi_p,
                                 hi_stride, pl, plane_n, plane_t, mask_value,
                                 scale, out, T_rows, N, D, H, s);
  }
  return launch<float>(q, q_stride, k, v, lo_p, lo_stride, hi_p, hi_stride,
                       pl, plane_n, plane_t, mask_value, scale, out, T_rows, N,
                       D, H, s);
}
