// Transducer lattice walks for Hopper (sm_90a), one warp per lattice: the
// warp set of the lattice kernels, for lattices of at most kMaxU = 256 label
// cells.  Wider lattices run the block set of csrc/transducer.cu (the
// chooser is ops/transducer/kernels.py:lattice_path).
//
// Replaces the Pallas TPU kernels of
// wav2vec_s_tpu/ops/transducer/pallas_kernel.py, one template mode each:
//   kAlphas       <- pallas_alphas (_alphas_kernel), K5a;
//   kBetas        <- pallas_betas (the alphas kernel on the flipped,
//                    lane-rolled lattice), K5b;
//   kAffineFwd,
//   kAffineRev    <- pallas_affine_rows (_affine_rows_kernel), K6;
//   kAlphasDelay  <- pallas_alphas followed by pallas_expected_delay (K5a
//                    and the forward K6 with the transition probabilities
//                    between them), fused into one walk;
//   kBetasDelay   <- pallas_betas followed by pallas_expected_delay_bwd (K5b
//                    and the reverse K6), fused into one walk.
// The recursions and the virtually extended beta lattice are those of
// csrc/transducer.cu (its header has them).  The fused walks add, at cell
// (t, u) of the forward walk,
//   pe = exp(min(alpha(t,u-1) + emit(t,u-1) - alpha(t,u), 0))  (0 at u = 0,
//        1 on row 0)
//   pb = exp(min(alpha(t-1,u) + blank(t-1,u) - alpha(t,u), 0)) (0 at t = 0)
//   ad(t,u) = pe ad(t,u-1) + pb ad(t-1,u) + pe dv(t,u)
// (ops/transducer/lattice.py:expected_delay), and of the reverse walk
//   pb' = exp(min(beta(t+1,u) + blank'(t,u) - beta(t,u), 0))
//   pe' = exp(min(beta(t,u+1) + emit(t,u) - beta(t,u), 0)) where the emit is
//         allowed (u < U_b, t < T_b), else 0
//   bd(t,u) = pe' (bd(t,u+1) + dv(t,u+1)) + pb' bd(t+1,u)
// (lattice.py:expected_delay_bwd).  Both log-add-exp arguments of a cell are
// the arguments of its transition probabilities, so the affine chain needs
// nothing the alpha (beta) chain has not computed, and never feeds it back.
//
// What bounds it: latency.  A lattice is T + U - 1 dependent steps along its
// anti-diagonals; a step of the log-space walks is one precise expf/log1pf
// chain (~80 ns on the H100), of the affine rows one multiply-add pair.
// The bytes (8-20 per cell) and the operations are small next to that.
//
// What the design does about it:
// - One warp walks one lattice (kWarps lattices share a block, one per
//   warp).  Lane l holds the newest value of the columns u = l PER ..
//   l PER + PER - 1 in registers, PER = ceil(U / 32) a template argument.
//   The head next to a lane's first column comes by one __shfl_up_sync in
//   the forward walks (one __shfl_down_sync in the reverse ones); a lane
//   updates its columns as straight-line code, each from its neighbour's
//   value of the step before.  No block barrier.
// - The inputs of a cell do not depend on the recursion, so each lane
//   copies the inputs of its cells kAhead diagonals ahead (cp.async) into a
//   ring in shared memory, and reads a step's inputs one step before it
//   walks it: no step waits on device memory once the first diagonals are
//   in.  (Loads into a ring of registers ran ~1.4x slower on an H100:
//   ptxas put their wait inside the step.)
// - The fused walks run the affine chain beside the log-space chain in the
//   same step (a second shuffle), so the expected delay costs no launch, no
//   pass over the lattice and none of the ~15 elementwise kernels that
//   built its coefficients.
// - The log-add-exp (csrc/lattice_math.cuh) is written stage by stage over
//   the lane's columns, with log1pf's arithmetic minus its special-case
//   branch, so the columns' chains overlap: the same precise expf/log1pf
//   values, bit for bit, as csrc/transducer.cu (alphas and betas equal the
//   block set's).
//
// Plain C interface (loaded with ctypes): each w2vs_lattice_warp_* returns
// the cudaGetLastError() code of its launch, or -1 for U > kMaxU or a
// lattice of 2^31 cells or more.

#include <cuda_runtime.h>
#include <math.h>

#include "lattice_math.cuh"

namespace {

using w2vs_lattice::lae;

constexpr float kBlock = -1e9f;   // analytic.BLOCK: survives sums in f32
constexpr int kWarps = 2;         // lattices per block, one per warp
constexpr int kAhead = 6;         // diagonals the input copies run ahead
constexpr int kMaxPer = 8;        // columns per lane
constexpr int kMaxU = 32 * kMaxPer;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kAhead % 2 == 0, "steps alternate two input buffers");

enum Mode { kAlphas, kBetas, kAffineFwd, kAffineRev, kAlphasDelay,
            kBetasDelay };

struct WalkParams {
  const float* in0;        // lp_blank | a
  const float* in1;        // lp_emit | pb
  const float* in2;        // delay values | c
  long long sb;            // strides of in2 (delay values may broadcast)
  int st, su;
  const void* act_lens;    // [B] int32 or int64 (act64), the beta walks
  const void* label_lens;
  int act64, label64;
  float* out0;             // alpha | beta | x
  float* out1;             // ad | bd
  int B, T, U;
};

__device__ __forceinline__ int length_at(const void* p, int is64, int b) {
  return is64 ? (int)static_cast<const long long*>(p)[b]
              : static_cast<const int*>(p)[b];
}

template <int MODE>
struct Walk {
  static constexpr bool kReverse =
      MODE == kBetas || MODE == kAffineRev || MODE == kBetasDelay;
  static constexpr bool kDelay = MODE == kAlphasDelay || MODE == kBetasDelay;
  static constexpr bool kAffine = MODE == kAffineFwd || MODE == kAffineRev;
  static constexpr int kInputs = (MODE == kAlphas || MODE == kBetas) ? 2 : 3;
};

// What a lane keeps of its columns u = u0 + e: cell (d - u, u) of diagonal
// d lies at d * U + off[e] in the lattice and at d * st + dvo[e] in the
// delay values (the column u + 1 in the reverse walk).
template <int PER>
struct Columns {
  int off[PER], dvo[PER];
};

// cp.async of src[i] into shared memory, or of nothing (the slot is
// zero-filled and src[0] named, never read) when `on` is false.  The index
// is unsigned: its select and widening take one instruction each.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      unsigned i, bool on) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src + (on ? i : 0u)), "r"(on ? 4 : 0));
}

// The copies and their commits keep their order (volatile) but not the
// plain loads and stores around them, which touch other memory: only the
// wait, after which a slot is read, is a barrier to the compiler.
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A lane's ring slot: input j of column e at slot[(j * PER + e) * 32]
// (the lanes' elements side by side, so no two lanes share a bank).
template <int PER>
__device__ __forceinline__ int at(int j, int e) {
  return (j * PER + e) * 32;
}

// Copies the inputs of the lane's cells on diagonal d into its ring slot
// (0 for a cell off the lattice or an input its step does not read).
// Nothing here waits on the lengths: the beta walks apply them when they
// step.
template <int MODE, int PER>
__device__ __forceinline__ void fetch(int T, int U, int st,
                                      const float* __restrict__ in0,
                                      const float* __restrict__ in1,
                                      const float* __restrict__ in2, int u0,
                                      const Columns<PER>& c, int d,
                                      float* slot) {
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int u = u0 + e, t = d - u;
    const bool on = u < U && (unsigned)t < (unsigned)T;
    const int i = d * U + c.off[e];
    if constexpr (MODE == kAlphas || MODE == kAlphasDelay) {
      copy4(slot + at<PER>(0, e), in0, i - U, on && t > 0);  // blank(t-1,u)
      copy4(slot + at<PER>(1, e), in1, i - 1, on && u > 0);  // emit(t,u-1)
    } else {
      copy4(slot + at<PER>(0, e), in0, i, on);
      copy4(slot + at<PER>(1, e), in1, i, on);
    }
    if constexpr (MODE == kAlphasDelay) {                   // dv(t,u)
      copy4(slot + at<PER>(2, e), in2, d * st + c.dvo[e], on);
    } else if constexpr (MODE == kBetasDelay) {            // dv(t,u+1)
      copy4(slot + at<PER>(2, e), in2, d * st + c.dvo[e], on && u + 1 < U);
    } else if constexpr (Walk<MODE>::kAffine) {
      copy4(slot + at<PER>(2, e), in2, i, on);
    }
  }
  copy_commit();
}

// The inputs of a step from the lane's ring slot.
template <int MODE, int PER>
__device__ __forceinline__ void take(const float* slot,
                                     float (&r)[Walk<MODE>::kInputs][PER]) {
#pragma unroll
  for (int j = 0; j < Walk<MODE>::kInputs; ++j) {
#pragma unroll
    for (int e = 0; e < PER; ++e) r[j][e] = slot[at<PER>(j, e)];
  }
}

// One step on diagonal d: every cell of the lane on it, from the heads of
// the step before (v: the log-space walk or the affine rows; x: the
// expected delay of the fused walks).  Straight-line code, stage by stage
// across the columns: each value is computed for every cell and kept by a
// select, so no lane branches (the edge cells go through lae with -inf for
// the missing neighbour, which gives the other argument exactly).
// The neighbour's heads of the step before, (v, x): the next lane down
// (forward) or up (reverse); lane 0's and lane 31's own value is never
// selected.
template <int MODE, int PER>
__device__ __forceinline__ float2 neighbour(const float (&v)[PER],
                                            const float (&x)[PER]) {
  constexpr bool kRev = Walk<MODE>::kReverse;
  float2 n;
  n.x = kRev ? __shfl_down_sync(kFull, v[0], 1)
             : __shfl_up_sync(kFull, v[PER - 1], 1);
  n.y = 0.f;
  if constexpr (Walk<MODE>::kDelay) {
    n.y = kRev ? __shfl_down_sync(kFull, x[0], 1)
               : __shfl_up_sync(kFull, x[PER - 1], 1);
  }
  return n;
}

template <int MODE, int PER>
__device__ __forceinline__ void step(int T, int U, float* out0, float* out1,
                                     int u0, const Columns<PER>& c, int d,
                                     int Tb, int Ub, float2 heads,
                                     const float (&r)[Walk<MODE>::kInputs][PER],
                                     float (&v)[PER], float (&x)[PER]) {
  using W = Walk<MODE>;
  constexpr bool kRev = W::kReverse;
  const float vn = heads.x, xn = heads.y;
  bool on[PER], edge[PER], first[PER];   // edge: the row neighbour exists
  float side[PER], xs[PER], nv[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int u = u0 + e, t = d - u;
    on[e] = u < U && (unsigned)t < (unsigned)T;
    edge[e] = kRev ? u + 1 < U : u > 0;
    first[e] = kRev ? t >= Tb : t == 0;   // beta: past T_b; alpha: row 0
    const float sv = kRev ? (e < PER - 1 ? v[e + 1] : vn)
                          : (e > 0 ? v[e - 1] : vn);
    side[e] = edge[e] ? sv : 0.f;         // (t, u-/+1), 0 off the lattice
    if constexpr (W::kDelay) {
      const float sx = kRev ? (e < PER - 1 ? x[e + 1] : xn)
                            : (e > 0 ? x[e - 1] : xn);
      xs[e] = edge[e] ? sx : 0.f;
    }
  }
  if constexpr (W::kAffine) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      nv[e] = r[0][e] * side[e] + r[1][e] * v[e] + r[2][e];
    }
  } else {
    float arg_b[PER], arg_e[PER], la[PER], lb[PER];
    bool emit_ok[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int u = u0 + e;
      if constexpr (!kRev) {
        arg_b[e] = v[e] + r[0][e];                           // via blank
        arg_e[e] = side[e] + r[1][e];                        // via emit
        // (0, 0) -> lae(-inf, 0) = 0: no select after the lae, which the
        // compiler would turn into a branch around it
        la[e] = first[e] ? -INFINITY : arg_b[e];
        lb[e] = edge[e] ? arg_e[e] : first[e] ? 0.f : -INFINITY;
      } else {
        const bool row_ok = !first[e];
        emit_ok[e] = row_ok && u < Ub && edge[e];
        arg_b[e] = v[e] + (row_ok ? r[0][e] : 0.f);
        arg_e[e] = side[e] + (emit_ok[e] ? r[1][e] : kBlock);
        la[e] = arg_b[e];
        lb[e] = edge[e] ? arg_e[e] : -INFINITY;
      }
    }
    lae(la, lb, nv);
    if constexpr (W::kDelay) {
      float qe[PER], qb[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) qe[e] = expf(fminf(arg_e[e] - nv[e], 0.f));
#pragma unroll
      for (int e = 0; e < PER; ++e) qb[e] = expf(fminf(arg_b[e] - nv[e], 0.f));
      float nx[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        // forward: pe 0 at u = 0 and 1 on row 0, pb 0 on row 0; reverse:
        // pe' only where the emit is allowed
        const float pe = kRev ? (emit_ok[e] ? qe[e] : 0.f)
                              : (!edge[e] ? 0.f : first[e] ? 1.f : qe[e]);
        const float pb = !kRev && first[e] ? 0.f : qb[e];
        nx[e] = pe * xs[e] + pb * x[e] + pe * r[2][e];
      }
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        if (on[e]) {
          x[e] = nx[e];
          out1[d * U + c.off[e]] = nx[e];
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    if (on[e]) {
      v[e] = nv[e];
      out0[d * U + c.off[e]] = nv[e];
    }
  }
}

template <int MODE, int PER>
__global__ void __launch_bounds__(32 * kWarps)
    lattice_walk_kernel(const WalkParams p) {
  using W = Walk<MODE>;
  const int b = blockIdx.x * kWarps + threadIdx.x / 32;
  if (b >= p.B) return;                  // a whole warp: no shuffle misses it
  const int u0 = (threadIdx.x % 32) * PER;
  const int T = p.T, U = p.U, st = p.st;
  const long long base = (long long)b * T * U;
  const float* __restrict__ in0 = p.in0 + base;
  const float* __restrict__ in1 = p.in1 + base;
  const float* __restrict__ in2 =
      W::kAffine ? p.in2 + base : W::kDelay ? p.in2 + b * p.sb : nullptr;
  float* out0 = p.out0 + base;
  float* out1 = W::kDelay ? p.out1 + base : nullptr;
  Columns<PER> c;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int u = u0 + e;
    c.off[e] = u - u * U;                             // (d - u) U + u
    c.dvo[e] = (W::kReverse ? u + 1 : u) * p.su - u * st;
  }
  // the lane's ring of kAhead slots; its first diagonals' copies go out
  // before anything waits
  __shared__ float ring[kWarps][kAhead][W::kInputs * PER * 32];
  float* slots = &ring[threadIdx.x / 32][0][threadIdx.x % 32];
  constexpr int kSlot = W::kInputs * PER * 32;
  const int n = T + U - 1;
  auto diag = [n](int s) { return W::kReverse ? n - 1 - s : s; };
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    fetch<MODE, PER>(T, U, st, in0, in1, in2, u0, c, diag(k),
                     slots + k * kSlot);
  }
  int Tb = T, Ub = U;
  if constexpr (MODE == kBetas || MODE == kBetasDelay) {
    Tb = length_at(p.act_lens, p.act64, b);
    Ub = length_at(p.label_lens, p.label64, b);
  }
  float v[PER], x[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    // the beta walks start from the virtual row t = T; the others from
    // zero (the alpha walk never reads a head before its row 0)
    v[e] = (MODE == kBetas || MODE == kBetasDelay)
               ? (u0 + e == Ub ? 0.f : kBlock)
               : 0.f;
    x[e] = 0.f;
  }
  float r[2][W::kInputs][PER];          // this step's inputs and the next's
  copy_wait<kAhead - 1>();
  take<MODE, PER>(slots, r[0]);
  // Whole rounds of kAhead steps, each one block of straight-line code.
  // Step s takes the inputs of step s + 1 out of the ring (its copies are
  // in: every group but the newest kAhead - 2 is), shuffles the heads,
  // refills the slot that step s's inputs came from with the diagonal
  // kAhead steps on (off the lattice past the last one: the slot is
  // zero-filled), then walks its diagonal.  The copies keep their place
  // among the shuffles (both are side effects to the compiler), so they go
  // after them, where their address arithmetic can fill the walk's stalls
  // instead of delaying its start.
  int s = 0;
  for (; s + kAhead <= n; s += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      copy_wait<kAhead - 2>();
      take<MODE, PER>(slots + (k + 1) % kAhead * kSlot, r[(k + 1) % 2]);
      const float2 heads = neighbour<MODE, PER>(v, x);
      fetch<MODE, PER>(T, U, st, in0, in1, in2, u0, c, diag(s + k + kAhead),
                       slots + k * kSlot);
      step<MODE, PER>(T, U, out0, out1, u0, c, diag(s + k), Tb, Ub, heads,
                      r[k % 2], v, x);
    }
  }
#pragma unroll
  for (int k = 0; k < kAhead - 1; ++k) {                    // the rest
    if (s + k < n) {
      copy_wait<kAhead - 2>();
      take<MODE, PER>(slots + (k + 1) % kAhead * kSlot, r[(k + 1) % 2]);
      const float2 heads = neighbour<MODE, PER>(v, x);
      fetch<MODE, PER>(T, U, st, in0, in1, in2, u0, c, diag(s + k + kAhead),
                       slots + k * kSlot);
      step<MODE, PER>(T, U, out0, out1, u0, c, diag(s + k), Tb, Ub, heads,
                      r[k % 2], v, x);
    }
  }
  copy_wait<0>();      // no copy may land in the block's memory after it
}

template <int MODE>
int launch(const WalkParams& p, void* stream) {
  // one lattice's cells (and delay values) are indexed in 32 bits
  if ((long long)p.T * p.U >= (1LL << 31)
      || (long long)p.T * p.st >= (1LL << 31)) {
    return -1;
  }
  const int warps = p.B < kWarps ? p.B : kWarps;
  const dim3 grid((p.B + kWarps - 1) / kWarps), block(32 * warps);
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((p.U + 31) / 32) {
    case 1: lattice_walk_kernel<MODE, 1><<<grid, block, 0, st>>>(p); break;
    case 2: lattice_walk_kernel<MODE, 2><<<grid, block, 0, st>>>(p); break;
    case 3: lattice_walk_kernel<MODE, 3><<<grid, block, 0, st>>>(p); break;
    case 4: lattice_walk_kernel<MODE, 4><<<grid, block, 0, st>>>(p); break;
    case 5: lattice_walk_kernel<MODE, 5><<<grid, block, 0, st>>>(p); break;
    case 6: lattice_walk_kernel<MODE, 6><<<grid, block, 0, st>>>(p); break;
    case 7: lattice_walk_kernel<MODE, 7><<<grid, block, 0, st>>>(p); break;
    case 8: lattice_walk_kernel<MODE, 8><<<grid, block, 0, st>>>(p); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

WalkParams params(const float* in0, const float* in1, const float* in2,
                  float* out0, float* out1, int B, int T, int U) {
  WalkParams p = {};
  p.in0 = in0;
  p.in1 = in1;
  p.in2 = in2;
  p.out0 = out0;
  p.out1 = out1;
  p.B = B;
  p.T = T;
  p.U = U;
  return p;
}

}  // namespace

// lp_blank, lp_emit, alpha: [B, T, U] float32, contiguous.
extern "C" int w2vs_lattice_warp_alphas(const float* lp_blank,
                                        const float* lp_emit, float* alpha,
                                        int B, int T, int U, void* stream) {
  return launch<kAlphas>(
      params(lp_blank, lp_emit, nullptr, alpha, nullptr, B, T, U), stream);
}

// act_lens, label_lens: [B] int32 or int64 (act64 / label64 not 0), on the
// device: T_b frames, U_b labels, the final cell is (T_b - 1, U_b).
extern "C" int w2vs_lattice_warp_betas(const float* lp_blank,
                                       const float* lp_emit,
                                       const void* act_lens, int act64,
                                       const void* label_lens, int label64,
                                       float* beta, int B, int T, int U,
                                       void* stream) {
  WalkParams p = params(lp_blank, lp_emit, nullptr, beta, nullptr, B, T, U);
  p.act_lens = act_lens;
  p.label_lens = label_lens;
  p.act64 = act64;
  p.label64 = label64;
  return launch<kBetas>(p, stream);
}

// a, pb, c, x: [B, T, U] float32, contiguous; reverse 0 runs t and u
// upwards, 1 downwards.
extern "C" int w2vs_lattice_warp_affine_rows(const float* a, const float* pb,
                                             const float* c, float* x, int B,
                                             int T, int U, int reverse,
                                             void* stream) {
  const WalkParams p = params(a, pb, c, x, nullptr, B, T, U);
  return reverse ? launch<kAffineRev>(p, stream)
                 : launch<kAffineFwd>(p, stream);
}

// The forward fused walk: alpha and the expected delay ad, [B, T, U]
// float32 contiguous; delay_values [B, T, U] float32 at element strides
// (sb, st, su).
extern "C" int w2vs_lattice_warp_alphas_delay(
    const float* lp_blank, const float* lp_emit, const float* delay_values,
    long long sb, long long st, long long su, float* alpha, float* ad, int B,
    int T, int U, void* stream) {
  WalkParams p = params(lp_blank, lp_emit, delay_values, alpha, ad, B, T, U);
  p.sb = sb;
  p.st = (int)st;
  p.su = (int)su;
  return launch<kAlphasDelay>(p, stream);
}

// The reverse fused walk: beta and the expected remaining delay bd.
extern "C" int w2vs_lattice_warp_betas_delay(
    const float* lp_blank, const float* lp_emit, const void* act_lens,
    int act64, const void* label_lens, int label64,
    const float* delay_values, long long sb, long long st, long long su,
    float* beta, float* bd, int B, int T, int U, void* stream) {
  WalkParams p = params(lp_blank, lp_emit, delay_values, beta, bd, B, T, U);
  p.act_lens = act_lens;
  p.label_lens = label_lens;
  p.act64 = act64;
  p.label64 = label64;
  p.sb = sb;
  p.st = (int)st;
  p.su = (int)su;
  return launch<kBetasDelay>(p, stream);
}
