// Incremental-chunk attention over a time-major K/V cache on Hopper's tensor
// cores (sm_90a): the kernel bfloat16 inputs with heads of 32, 64 or 128 dims
// take.  (float32 inputs and other head widths take the CUDA-core kernel of
// chunk_attention.cu; ops/chunk_attention.py chooses by dtype and head width
// alone.)
//
// Replaces the Pallas TPU kernel wav2vec_s_tpu/ops/chunk_attention.py
// (chunk_cache_attention, _kernel).  The function is the one
// chunk_attention.cu states: for every stream b, head h and each of the R
// query rows of a chunk (q pre-scaled by dh**-0.5)
//   logits = [ q . k_cache[t]           for the committed rows t < t0 ;
//              q . k_new[j] + bias[r,j]  for the chunk's own R rows      ]
//   out    = softmax(logits) . [v_cache[:t0] ; v_new]
// with one running max over both parts and a 1 / max(l, 1e-20)
// normalisation in f32; neither the logits nor the probabilities reach device
// memory.  The probabilities are rounded to bf16 unnormalised (the twin
// rounds the normalised ones), the sums run in f32.
//
// What bounds it: device memory.  A mean call of the main path (128 streams,
// R 48, 12 heads of 64, t0 224) reads 126 MB (0.038 ms at 3.35 TB/s) for 4.8
// GFLOP (0.005 ms at the tensor cores' 989 TFLOP/s): about R operations per
// byte of cache, far below the ~295 at which the card stops being bound by
// its memory.  The cache is TIME-MAJOR [kv_cap, B, D]: the row of (t, b, h)
// is dh contiguous elements (128 bytes at dh 64) at a stride of B*D elements
// per time step, so a 64-row tile of one (b, h) is 64 separate 128-byte
// pieces.
//
// What the design does about it (flash_mma.cuh has the shared pieces):
// - both products are mma.sync m16n8k16 on bf16 with f32 accumulators; the
//   query rows are loaded once into A fragments that stay in registers for
//   the whole walk; the probabilities are packed from the accumulator of q.k
//   straight into the A operand of p.v;
// - K and V tiles of 64 rows are staged as bf16 by 16-byte cp.async.cg into a
//   ring of kStages XOR-swizzled stages, the same layout and ldmatrix /
//   ldmatrix.trans reads as the flash kernels, with the cache's row stride
//   B*D and row limit t0 (rows >= t0 are zero-filled and never read); tiles
//   i+1 .. i+kStages-1 are in flight while tile i is multiplied.  All index
//   arithmetic on the cache is in long: kv_cap*B*D passes 2^31 at large B;
// - row tiles fit R: a block is W warps of 16 query rows, W = ceil(n16 /
//   ceil(n16 / 4)) with n16 = ceil(R / 16).  R 48 (ds2): 3 warps cover the
//   chunk exactly in one block per (b, h), each cache tile staged once.
//   R 24 (ds1): 2 warps, 8 of 32 rows idle.  R 240 (ds10): 4 row tiles of 4
//   warps, 16 of 256 rows idle (6.25 %), each cache tile staged 4 times (from
//   L2 after the first);
// - the chunk's own tiles go first (their loads and the bias reads are in
//   flight while the query fragments are built), then the cache tiles.  The
//   bias is read per accumulator pair from global memory into the
//   accumulator that q.k then adds to (R*R*4 bytes: 9 KB at R 48 but 230 KB
//   at R 240, more than shared memory holds);
// - masks are additive: columns of the last cache tile at or past t0 and
//   chunk columns at or past R get -inf on zero-filled rows, so p is exactly
//   0 and 0 * 0 is added; a row whose maximum is still -inf subtracts 0.
//   t0 = 0 walks no cache tile at all;
// - the grid is B x H x row tiles, flattened into blockIdx.x with the head
//   fastest, so that blocks that run together read neighbouring 128-byte
//   pieces of the same cache rows: 1536 blocks at the main path.
//
// Occupancy (ptxas of CUDA 12 for sm_90a; the build prints it): at dh 64 the
// kernel takes 168 registers a thread, no spills, and 6 KB (q, 3 warps) + 3
// stages x 16 KB = 54 KB of shared memory: 4 blocks of 3 warps per SM, by
// registers (4 x 96 x 168 = 64,512 of 65,536) and by shared memory alike.
// Tried and not kept (variant builds timed beside this one on an H100 at 700
// W, the main-path call): held to 128 registers for 5 blocks per SM it spills
// 32 bytes and takes 0.0551 ms against 0.0532, and a ring of 2 stages takes
// 0.0625.  dh 32: 128 registers, 27 KB; dh 128: 226 registers, 108 KB (2
// blocks per SM).  Small B: one block per (b, h) walks
// the whole cache range, so B 1 is 12 blocks on 132 SMs and B 8 is 96, and
// the time is the latency of one serial walk (0.008 ms, whatever B <= 11);
// splitting the cache range over blocks, with a merge of the partial sums,
// is what would fill the card there, and is not done.
//
// Plain C interface (loaded with ctypes): w2vs_chunk_attention_mma returns
// the first CUDA error of its attribute call and launch, 0 if none, and
// cudaErrorInvalidValue for inputs this kernel does not take.

#include <limits.h>

#include "flash_mma.cuh"

namespace {

using namespace w2vs_flash;
using namespace w2vs_flash::tc;

constexpr int kStages = 3;                    // K/V tiles in the ring
constexpr int kKeys = kTileRows;              // key rows per tile (64)
constexpr int kMaxWarps = 4;                  // 64 query rows per block
static_assert(kStages >= 2, "one tile is multiplied while another loads");

// shared memory: q [16 W][DH], then k and v [kStages][64][DH], bf16
template <int DH, int W>
constexpr size_t smem_bytes() {
  return (size_t)(16 * W + 2 * kStages * kKeys) * DH * sizeof(bf16);
}

// grid B * H * row tiles (row tile fastest, then head); block 32 W threads
template <int DH, int W>
__global__ void __launch_bounds__(32 * W)
chunk_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k_cache,
                           const bf16* __restrict__ v_cache,
                           const bf16* __restrict__ k_new,
                           const bf16* __restrict__ v_new,
                           const float* __restrict__ bias,
                           bf16* __restrict__ out, int B, int R, int D, int H,
                           int t0, int row_tiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kBlockRows = 16 * W, kBlockThreads = 32 * W;
  constexpr int kTileElems = kKeys * DH;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBlockRows * DH;          // kStages stages
  bf16* v_s = k_s + kStages * kTileElems;     // kStages stages

  const int rt = blockIdx.x % row_tiles;
  const int h = (blockIdx.x / row_tiles) % H;
  const int b = blockIdx.x / (row_tiles * H);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = rt * kBlockRows;
  const long chunk_base = (long)b * R * D + (long)h * DH;  // row 0 of (b, h)
  const long cache_base = (long)b * D + (long)h * DH;      // time step 0
  const long cache_stride = (long)B * D;                   // one time step
  const int n_intra = (R + kKeys - 1) / kKeys;
  const int n_tiles = n_intra + (t0 + kKeys - 1) / kKeys;

  // tile i of the walk: the chunk's own keys first, then the cache's
  auto stage_tile = [&](int i) {
    if (i >= n_tiles) return;
    bf16* k_dst = k_s + (i % kStages) * kTileElems;
    bf16* v_dst = v_s + (i % kStages) * kTileElems;
    if (i < n_intra) {
      load_tile_async<DH, kKeys, kBlockThreads>(k_dst, k_new, chunk_base,
                                                i * kKeys, R, D);
      load_tile_async<DH, kKeys, kBlockThreads>(v_dst, v_new, chunk_base,
                                                i * kKeys, R, D);
    } else {
      const int j0 = (i - n_intra) * kKeys;
      load_tile_async<DH, kKeys, kBlockThreads>(k_dst, k_cache, cache_base,
                                                j0, t0, cache_stride);
      load_tile_async<DH, kKeys, kBlockThreads>(v_dst, v_cache, cache_base,
                                                j0, t0, cache_stride);
    }
  };

  // group 0: q and tile 0; groups 1 .. kStages-2: tiles 1 .. kStages-2
  load_tile_async<DH, kBlockRows, kBlockThreads>(q_s, q, chunk_base, r0, R, D);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    stage_tile(i);
    cp_async_commit();
  }

  // the lane's two rows: g and g + 8 of the warp's 16
  const int row_a = r0 + 16 * warp + g;

  cp_async_wait<kStages - 2>();               // q (and tile 0) have landed
  __syncthreads();
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    load_a<DH>(qf[ks], smem_u32(q_s), 16 * warp, ks, lane);
  }

  float o[DH / 8][4];
  zero_acc<DH>(o);
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};                // the lane's share of the row sum

  for (int i = 0; i < n_tiles; ++i) {
    const bool intra = i < n_intra;
    const int j0 = (intra ? i : i - n_intra) * kKeys;
    const int n_valid = min(kKeys, (intra ? R : t0) - j0);     // >= 1

    // the accumulator of q.k starts at the additive bias (chunk tiles) or 0;
    // the bias reads are in flight while the tile lands
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
    if (intra) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_a + 8 * (e >> 1);
          const int col = j0 + 8 * n + 2 * t + (e & 1);
          if (row < R && col < R) s[n][e] = __ldg(bias + (long)row * R + col);
        }
      }
    }

    cp_async_wait<kStages - 2>();             // tile i has landed
    __syncthreads();                          // ... and tile i-1's stage is free
    stage_tile(i + kStages - 1);
    cp_async_commit();

    const uint32_t k_tile = smem_u32(k_s + (i % kStages) * kTileElems);
    const uint32_t v_tile = smem_u32(v_s + (i % kStages) * kTileElems);

    // s += q . k^T: 16 rows x 64 keys per warp
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

    // columns past the part's last row: no key
    if (n_valid < kKeys) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (8 * n + 2 * t + (e & 1) >= n_valid) s[n][e] = -INFINITY;
        }
      }
    }

    // online softmax on the fragment: the 4 lanes of a quad hold a row
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tmax = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        tmax = fmaxf(tmax, fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
      }
      const float m_new = fmaxf(m_run[hh], quad_max(tmax));
      const float m_sub = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = __expf(m_run[hh] - m_sub);   // 0 on the first tile
      m_run[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float p0 = __expf(s[n][2 * hh] - m_sub);
        const float p1 = __expf(s[n][2 * hh + 1] - m_sub);
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

    // o += p . v: p goes from the accumulator into the A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
      accumulate<DH>(o, pa, v_tile, kk, lane);
    }
  }

  const float l_a = quad_sum(l_run[0]), l_b = quad_sum(l_run[1]);
  store_acc<DH>(out, chunk_base, D, row_a, R, t, o, 1.f / fmaxf(l_a, 1e-20f),
                1.f / fmaxf(l_b, 1e-20f));
}

template <int DH, int W>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_new, const void* v_new, const float* bias, void* out,
           int B, int R, int D, int H, int t0, cudaStream_t stream) {
  auto kernel = chunk_attention_mma_kernel<DH, W>;
  const size_t smem = smem_bytes<DH, W>();
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const int row_tiles = (R + 16 * W - 1) / (16 * W);
  const long blocks = (long)B * H * row_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * W, smem, stream>>>(
      (const bf16*)q, (const bf16*)k_cache, (const bf16*)v_cache,
      (const bf16*)k_new, (const bf16*)v_new, bias, (bf16*)out, B, R, D, H,
      t0, row_tiles);
  return (int)cudaGetLastError();
}

// warps per block: the 16-row groups of R spread evenly over the fewest
// blocks of at most kMaxWarps
template <int DH>
int launch_for_rows(const void* q, const void* k_cache, const void* v_cache,
                    const void* k_new, const void* v_new, const float* bias,
                    void* out, int B, int R, int D, int H, int t0,
                    cudaStream_t stream) {
  const int n16 = (R + 15) / 16;
  const int row_tiles = (n16 + kMaxWarps - 1) / kMaxWarps;
#define W2VS_CHUNK(W)                                                       \
  launch<DH, W>(q, k_cache, v_cache, k_new, v_new, bias, out, B, R, D, H,   \
                t0, stream)
  switch ((n16 + row_tiles - 1) / row_tiles) {
    case 1: return W2VS_CHUNK(1);
    case 2: return W2VS_CHUNK(2);
    case 3: return W2VS_CHUNK(3);
    default: return W2VS_CHUNK(4);
  }
#undef W2VS_CHUNK
}

}  // namespace

// The arguments of w2vs_chunk_attention (chunk_attention.cu) and kv_cap, the
// rows of the caches.  Takes bfloat16 (dtype_code 1) with heads of 32, 64 or
// 128 dims, any R >= 1, B >= 1 and 0 <= t0 <= kv_cap, 16-byte aligned
// tensors (the float32 bias 4-byte aligned); anything else is
// cudaErrorInvalidValue.
extern "C" int w2vs_chunk_attention_mma(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_new, const void* v_new, const float* bias, void* out, int B,
    int R, int D, int H, int t0, int kv_cap, int dtype_code, void* stream) {
  if (dtype_code != 1 || B < 1 || R < 1 || H < 1 || D % H || t0 < 0 ||
      t0 > kv_cap ||
      (((uintptr_t)q | (uintptr_t)k_cache | (uintptr_t)v_cache |
        (uintptr_t)k_new | (uintptr_t)v_new | (uintptr_t)out) & 15) ||
      ((uintptr_t)bias & 3)) {
    return (int)cudaErrorInvalidValue;
  }
#define W2VS_CHUNK_DH(DH)                                                   \
  launch_for_rows<DH>(q, k_cache, v_cache, k_new, v_new, bias, out, B, R,   \
                      D, H, t0, (cudaStream_t)stream)
  switch (D / H) {
    case 32: return W2VS_CHUNK_DH(32);
    case 64: return W2VS_CHUNK_DH(64);
    case 128: return W2VS_CHUNK_DH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef W2VS_CHUNK_DH
}
