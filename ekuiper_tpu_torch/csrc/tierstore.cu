// Kernels of the tiered key state, for Hopper (sm_90a).
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes), like
// csrc/groupby.cu. Every entry point launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// of its launches.
//
// State layout (the reference's, ekuiper_tpu/ops/groupby.py): each
// component is float32 (P, C, K[, W]), act is float32 (P, C), and the
// touch column is uint32 (C,). A packed row (ops/tierstore.py TierStore)
// holds one slot's per-pane partials: each component's (P, w) block
// flattened in C order, w = K (* W) floats per slot and pane, the
// components in sorted order, then act's (P,) block. The layout must equal
// the reference's column for column: the cold tier's rows cross both
// packages in checkpoints.
//
// tier_demote replaces TierStore._demote_impl
//   (ekuiper_tpu/ops/tierstore.py:263): gather D slots' rows into a fresh
//   (D, Wp) float32 block, then reset the n real slots of every component
//   (and their touch counters) to the fold identity. The reference reads
//   the old state for every gathered row before any reset, and its pad
//   rows [n, D) repeat slots[0] (ops/tierstore.py _slots). Bound on an
//   H100: reading n·Wp floats of state, writing the block and n·Wp floats
//   of identity, a few KB to a few MB (2,048 rows of G1's 4 floats: 32 KB
//   of block; of the percentile plan's 1,026: 8.4 MB), under a microsecond
//   to a few of memory time, so launch-bound at the narrow shapes.
//   Design: one launch, no thread waiting on another. Its blocks fall in
//   classes (tier_demote_plan), found from the block index by a scan of
//   at most 32 class starts: per component, the runs of w floats a (row,
//   pane) of rows [1, n) (rows [0, n) without pads), a group of 1-32
//   lanes a run (about a float4 a lane), each element read once, written
//   to its packed column and set to the identity by the same thread,
//   float4 where the state run and the packed run share a 16-byte phase
//   (a scalar head and tail, as multirule_reset_pane's), four loads in
//   flight a thread otherwise; and, where pads exist, row 0's runs in
//   pieces of up to 32 floats, a block a piece: every thread reads the
//   piece's element it copies, writes it to a share of the pad rows (row
//   0 by the first group), and only after the block's barrier does the
//   first group write the identity, so no pad reads a reset value and
//   2,047 pads of one real row spread over the card. The thread that owns
//   column 0 of a row (component 0, pane 0, element 0) clears its touch
//   counter.
//
// tier_promote replaces TierStore._promote_impl (tierstore.py:278): the
//   n real rows of a packed block merged into their slots, add for n, s1,
//   s2, hist, hh and act, min for mn, max for mx and hll (the absorb's
//   algebra). The reference pads the block to D rows of the combine
//   identity on slots[0]; here only the real rows come up, and where n <
//   D row 0 merges the identity once more, which is all those pads change
//   (a -0.0 sum becomes +0.0, an hll register below +0.0 rises to it).
//   Bound: reading the n rows of the block and reading and writing n·Wp
//   floats of state; at G2's narrow rows (Wp 60, every (row, pane,
//   component) a different 32-byte sector) the sectors set it. Design: a
//   thread a (row, column), a float atomic a column. Measured against a
//   load, merge and store (the merge needs the old value: one dependent
//   read more) and against the demote's runs with float4 stores or float4
//   atomics (promote_routes.cu / .py, PERF.md §6): at G2 the atomics win,
//   the runs lose to the parent's kernel.

#include "groupby_common.cuh"

#define MAX_TIER_COMPS 16  // ekuiper_tpu_torch/ops/kernels.py MAX_PARTS

enum { TOP_ADD = 0, TOP_MIN = 1, TOP_MAX = 2 };

struct TierTab {  // the packed row's blocks, in packed order (act last)
  int n;
  float* p[MAX_TIER_COMPS];       // (P, C, w) state
  long long w[MAX_TIER_COMPS];    // floats per slot and pane
  long long off[MAX_TIER_COMPS];  // first packed column of the block
  float init[MAX_TIER_COMPS];     // fold identity
  int op[MAX_TIER_COMPS];         // promote's merge
};

#define DEMOTE_THREADS 256
#define DEMOTE_CLASSES (2 * MAX_TIER_COMPS)
enum { DEMOTE_RUNS = 0, DEMOTE_PADS = 1 };

// The demote's blocks in classes: class k holds blocks [first[k],
// first[k + 1]) of component comp[k] in role role[k]. DEMOTE_RUNS: 1 <<
// lg[k] lanes a (row, pane) run of rows [row0, n); DEMOTE_PADS: row 0's
// runs cut in `pieces` pieces of 1 << lg[k] floats, a block a piece.
// 32-bit: the entry point refuses a plan past 2^31 threads.
struct DemotePlan {
  int ncls;
  int row0;  // 1 where pad rows exist (row 0 is then the pad blocks'), else 0
  int P;
  int first[DEMOTE_CLASSES + 1];
  int comp[DEMOTE_CLASSES];
  int role[DEMOTE_CLASSES];
  int lg[DEMOTE_CLASSES];
  int pieces[DEMOTE_CLASSES];
};

// One (row, pane) run of w floats by lane g of a group of G: read from
// the state run src, written to the packed run dst, src set to init.
// float4 over the part where src and dst share a 16-byte phase, scalars
// for the head and tail around it (everything where the phases differ);
// a lane issues four loads before their stores.
__device__ __forceinline__ void demote_run(float* __restrict__ src,
                                           float* __restrict__ dst, int w,
                                           float init, int g, int G) {
  int head = 0, body = 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if (((a ^ reinterpret_cast<uintptr_t>(dst)) & 15u) == 0) {
    head = (int)((4u - ((a >> 2) & 3u)) & 3u);
    head = head < w ? head : w;
    body = (w - head) >> 2;
  }
  const float4 i4 = make_float4(init, init, init, init);
  float4* s4 = reinterpret_cast<float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int e = g; e < body; e += 4 * G) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e + u * G < body) v[u] = s4[e + u * G];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e + u * G < body) {
        d4[e + u * G] = v[u];
        s4[e + u * G] = i4;
      }
  }
  const int tail = head + 4 * body;
  const int ns = head + (w - tail);  // the scalars: [0, head), [tail, w)
  for (int x = g; x < ns; x += 4 * G) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int y = x + u * G;
      if (y < ns) v[u] = src[y < head ? y : tail + (y - head)];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int y = x + u * G;
      if (y < ns) {
        const int e = y < head ? y : tail + (y - head);
        dst[e] = v[u];
        src[e] = init;
      }
    }
  }
}

// The demote in one launch (the classes of DemotePlan). A slot outside
// [0, C) gathers the identity and resets nothing (never reached:
// ops/tierstore.py checks).
__global__ void __launch_bounds__(DEMOTE_THREADS)
tier_demote_kernel(TierTab t, DemotePlan dp,
                   const int32_t* __restrict__ slots, int D, int n, int C,
                   int Wp, float* __restrict__ packed,
                   unsigned int* __restrict__ touch) {
  const int blk = (int)blockIdx.x;
  int k = 0;
  while (k + 1 < dp.ncls && blk >= dp.first[k + 1]) ++k;
  const int b = dp.comp[k];
  const int w = (int)t.w[b];
  const float init = t.init[b];
  const int local = blk - dp.first[k];
  if (dp.role[k] == DEMOTE_PADS) {
    const int p = local / dp.pieces[k];
    const int e = (local - p * dp.pieces[k]) * (1 << dp.lg[k]) +
                  (int)(threadIdx.x & ((1u << dp.lg[k]) - 1u));
    const int j = (int)(threadIdx.x >> dp.lg[k]);
    const int groups = DEMOTE_THREADS >> dp.lg[k];
    const int slot = slots[0];
    const bool ok = slot >= 0 && slot < C;
    const bool in = e < w;
    float* src = t.p[b] + ((long long)p * C + (ok ? slot : 0)) * w + e;
    const float v = in && ok ? *src : init;
    const long long col = t.off[b] + (long long)p * w + e;
    if (in) {
      if (j == 0) packed[col] = v;
      for (int r = n + j; r < D; r += groups)
        packed[(long long)r * Wp + col] = v;
    }
    __syncthreads();  // every read of the piece before its reset
    if (in && ok && j == 0) {
      *src = init;
      if (b == 0 && p == 0 && e == 0 && touch != nullptr) touch[slot] = 0u;
    }
    return;
  }
  const int G = 1 << dp.lg[k];
  const int tid = local * DEMOTE_THREADS + (int)threadIdx.x;
  const int u = tid >> dp.lg[k];
  const int g = tid & (G - 1);
  const int dr = u / dp.P;
  const int d = dp.row0 + dr;
  if (d >= n) return;
  const int p = u - dr * dp.P;
  const int slot = slots[d];
  float* dst = packed + (long long)d * Wp + t.off[b] + (long long)p * w;
  if (slot < 0 || slot >= C) {
    for (int e = g; e < w; e += G) dst[e] = init;
    return;
  }
  demote_run(t.p[b] + ((long long)p * C + slot) * w, dst, w, init, g, G);
  if (b == 0 && p == 0 && g == 0 && touch != nullptr) touch[slot] = 0u;
}

// One thread a (real row, packed column): the row's slot and the packed
// value loaded together, the column's block found by a scan of at most
// MAX_TIER_COMPS offsets, then one float atomic add / min / max (the
// sign-split min / max of csrc/groupby_common.cuh). Its result is unused,
// so it is a reduction done at L2 with no round trip to the thread; the
// real slots are distinct (ops/tierstore.py _slots), so no two atomics
// meet. On a padded block (pads) row 0 takes a second atomic of the
// identity, as the reference's pad rows on slots[0]. A slot outside [0,
// C) merges nothing (never reached: ops/tierstore.py checks). 32-bit
// indices: the entry point refuses n·Wp past 2^31.
__global__ void __launch_bounds__(DEMOTE_THREADS)
tier_promote_kernel(TierTab t, const int32_t* __restrict__ slots, int n,
                    int C, int Wp, bool pads,
                    const float* __restrict__ packed) {
  const int i = (int)blockIdx.x * DEMOTE_THREADS + (int)threadIdx.x;
  if (i >= n * Wp) return;
  const int d = i / Wp;
  const int j = i - d * Wp;
  const float v = packed[i];
  const int slot = slots[d];
  if (slot < 0 || slot >= C) return;
  int b = 0;
  while (b + 1 < t.n && j >= (int)t.off[b + 1]) ++b;
  const int w = (int)t.w[b];
  const int local = j - (int)t.off[b];
  const int p = local / w;
  float* dst = t.p[b] + ((long long)p * C + slot) * w + (local - p * w);
  const bool pad = pads && d == 0;
  switch (t.op[b]) {
    case TOP_MIN:
      atomic_min_f32(dst, v);
      if (pad) atomic_min_f32(dst, t.init[b]);
      break;
    case TOP_MAX:
      atomic_max_f32(dst, v);
      if (pad) atomic_max_f32(dst, t.init[b]);
      break;
    default:
      atomicAdd(dst, v);
      if (pad) atomicAdd(dst, t.init[b]);
  }
}

// ptrs / ws / inits / ops: host arrays of ncomps blocks in packed order
// (device pointer, floats per slot and pane, identity, merge). False if
// the table is too long or a width is not positive; *Wp is the row width.
static inline bool make_tiertab(float* const* ptrs, const long long* ws,
                                const float* inits, const int32_t* ops,
                                int ncomps, int P, TierTab* t,
                                long long* Wp) {
  if (ncomps < 1 || ncomps > MAX_TIER_COMPS || P < 1) return false;
  t->n = ncomps;
  long long col = 0;
  for (int k = 0; k < ncomps; ++k) {
    if (ws[k] < 1) return false;
    t->p[k] = ptrs[k];
    t->w[k] = ws[k];
    t->off[k] = col;
    t->init[k] = inits[k];
    t->op[k] = ops[k];
    col += (long long)P * ws[k];
  }
  *Wp = col;
  return true;
}

static inline int log2_up(long long x) {
  int lg = 0;
  while ((1LL << lg) < x) ++lg;
  return lg;
}

// The classes of tier_demote_kernel's blocks for n real rows of D (n >=
// 1): where pads exist, row 0's pieces first (a class a component), then
// a class a component for the runs of the other real rows. False where
// the grid passes 32 bits.
static bool tier_demote_plan(const TierTab& t, int P, int D, int n,
                             DemotePlan* dp) {
  dp->ncls = 0;
  dp->row0 = D > n ? 1 : 0;
  dp->P = P;
  long long blocks = 0;
  for (int role = dp->row0 ? DEMOTE_PADS : DEMOTE_RUNS; role >= DEMOTE_RUNS;
       --role) {
    for (int b = 0; b < t.n; ++b) {
      const int k = dp->ncls++;
      dp->first[k] = (int)blocks;
      dp->comp[k] = b;
      dp->role[k] = role;
      if (role == DEMOTE_PADS) {  // pieces of up to 32 floats
        dp->lg[k] = log2_up(t.w[b] < 32 ? t.w[b] : 32);
        dp->pieces[k] = (int)((t.w[b] + (1LL << dp->lg[k]) - 1) >> dp->lg[k]);
        blocks += (long long)P * dp->pieces[k];
      } else {  // about a float4 a lane, up to a warp a run
        const long long f4 = (t.w[b] + 3) / 4;
        dp->lg[k] = log2_up(f4 < 32 ? f4 : 32);
        dp->pieces[k] = 0;
        const long long threads =
            ((long long)(n - dp->row0) * P) << dp->lg[k];
        if (threads > 0x7fffffffLL) return false;
        blocks += (threads + DEMOTE_THREADS - 1) / DEMOTE_THREADS;
      }
      if (blocks > 0x7fffffffLL) return false;
    }
  }
  dp->first[dp->ncls] = (int)blocks;
  return true;
}

extern "C" {

// slots: device int32 (D,), rows [n, D) repeating slots[0] (the pads; n
// >= 1 where D > 0); packed: device float32 (D, Wp), written whole;
// touch: device uint32 (C,) or null.
int tier_demote(float* const* ptrs, const long long* ws, const float* inits,
                const int32_t* ops, int ncomps, int P, int C,
                const int32_t* slots, int D, int n, float* packed,
                unsigned int* touch, void* stream) {
  TierTab t;
  long long Wp = 0;
  if (!make_tiertab(ptrs, ws, inits, ops, ncomps, P, &t, &Wp) || D < 0 ||
      n < 0 || n > D || (D > 0 && n == 0) || C < 0 || Wp > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (D == 0) return (int)cudaSuccess;
  DemotePlan dp;  // a block at least: n >= 1
  if (!tier_demote_plan(t, P, D, n, &dp)) return (int)cudaErrorInvalidValue;
  tier_demote_kernel<<<dp.first[dp.ncls], DEMOTE_THREADS, 0,
                       (cudaStream_t)stream>>>(t, dp, slots, D, n, C,
                                               (int)Wp, packed, touch);
  return (int)cudaGetLastError();
}

// packed: device float32 (at least n rows of Wp); slots: device int32 (at
// least n, the first n distinct); D: the reference's block length (n < D:
// row 0 also merges the identity, as the pads would).
int tier_promote(float* const* ptrs, const long long* ws, const float* inits,
                 const int32_t* ops, int ncomps, int P, int C,
                 const int32_t* slots, int n, int D, const float* packed,
                 void* stream) {
  TierTab t;
  long long Wp = 0;
  if (!make_tiertab(ptrs, ws, inits, ops, ncomps, P, &t, &Wp) || n < 0 ||
      n > D || C < 0 || Wp > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if ((long long)n * Wp > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int total = n * (int)Wp;
  tier_promote_kernel<<<(total + DEMOTE_THREADS - 1) / DEMOTE_THREADS,
                        DEMOTE_THREADS, 0, (cudaStream_t)stream>>>(
      t, slots, n, C, (int)Wp, n < D, packed);
  return (int)cudaGetLastError();
}

}  // extern "C"
