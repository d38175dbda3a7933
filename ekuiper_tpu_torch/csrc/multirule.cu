// The rule group's kernels, for Hopper (sm_90a): N homogeneous rules on a
// leading rule axis, each wrapper ONE call for every rule of the group.
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes). Every entry point
// launches on the caller's stream, allocates nothing (the wrapper passes
// the scratch), does not synchronise, and returns cudaGetLastError() of
// its launches.
//
// State layout (the reference's BatchedGroupBy,
// ekuiper_tpu/parallel/multirule.py): rule r's block of every component is
// one rule's state of csrc/groupby_common.cuh, laid end to end:
//   comp[c] : float32 (NR, P, C, K_c)   act : float32 (NR, P, C)
// so rule r's component c starts r * P * C * K_c floats in.
//
// multirule_fold_order replaces no TPU program: it orders a chunk's rows by
//                      their flat key pane * C + slot (stable), for both
//                      folds, and gives each key its segment of the order
// multirule_fold       replaces BatchedGroupBy._batched_fold_impl
//                      (ekuiper_tpu/parallel/multirule.py:196), the vmap of
//                      _fold_impl over the rule axis with each rule's WHERE
//                      parameters bound: act and the scalar components,
//                      into one pane or each row into its own (the uint8
//                      pane vector the vmap shares across rules,
//                      ekuiper_tpu/ops/groupby.py:334-338)
// multirule_fold_wide  replaces the same vmap's hll / hist branches
//                      (ekuiper_tpu/ops/groupby.py:421-432): the wide
//                      components, after multirule_fold
// multirule_finalize   replaces _batched_finalize_impl (210) and the key
//                      cut of finalize_begin (230-241): act and the scalar
//                      final values
// multirule_finalize_wide replaces the hll and percentile_approx final
//                      values of the same vmap (_final_value,
//                      groupby.py:510-519), into multirule_finalize's result
// multirule_reset_pane replaces _batched_reset_impl (256), any component
//
// The per-row and per-slot arithmetic is csrc/groupby_common.cuh's and
// csrc/sketch_common.cuh's, the same code the single-rule kernels run, so
// the two round alike (and a register, a rho, a bin come out bit-equal).
//
// The fold, at the 256-rule group (65,536-row batches, 16,384 slots, 67 MB
// of state, ~2.6 rows a key per rule past its WHERE). Bound: its inputs
// read once (17.7 MB) and the touched (rule, pane, slot) state read and
// written once. One atomic per (rule, passing row, column), the TPU
// program's scatter carried over, issued 26.5M atomics into state past L2
// (0.61 ms). Design: the order first (a stable radix sort of the key, the
// relational tier's, csrc/radix_sort.cuh: a histogram and two passes of
// 8-bit digits at 16,384 slots, the places above the key's width never
// launched; dropped rows sort last), and each rule's WHERE bits packed
// into (n, ceil(R / 32)) words by one coalesced pass; then the packed
// words, the spec values and the masks put in the order (one gather), so
// that a segment's inputs are contiguous and neighbouring segments
// neighbours. Then one thread per (key, block of 32 rules) folds a key's
// segment of at most FOLD_SHORT rows: it reads each row's inputs once
// per column for the whole block, sums (or takes the min / max of) each
// rule's rows in
// registers, and writes each touched (rule, pane, slot) once with a plain
// read-modify-write; neighbouring threads take neighbouring keys, so a
// rule's stores coalesce. A longer segment goes to a warp per piece of at
// most FOLD_PIECE rows (lanes over rows, a reduce-scatter of the 32 rule
// sums across the lanes, lane q writing rule q): a segment of one piece
// is written once; the pieces of a longer one (a key holding most rows)
// add with one atomic per (piece, rule, column). Every piece starts in a
// 32-row tile of the order whose first or last row is of its segment, so
// a warp per tile finds its at most two pieces without a scan.
//
// The wide fold, at a 63-rule sketch group (16,384 slots): 1.06 GB an hll
// pane and 4.2 GB a percentile pane, far past L2, and an update touches
// one register or bin of it. One thread a row in the order (neighbouring
// lanes on a few keys), a block of 32 rules in y: the register's or bin's
// hash and log computed once for the row, then for each rule of the block
// whose WHERE bit holds (the packed word, one load) an atomic max of rho
// or an add of 1, the block's rules taken in the same order by every lane
// so that a warp's updates land in a few keys' runs of one rule. max is
// order-free and the counts stay below 2^24, so the result does not
// depend on the order of the atomics.
//
// The finalize reads the state (67 MB) and writes the (NR, S+1, K) result
// (50 MB), 0.035 ms; rule in blockIdx.y, slots in x. The wide finalize is
// bytes-bound: it reads each live (rule, pane, key) register or bin run
// once; a warp per (rule, key) on a persistent grid, float4 loads, warp
// shuffles and no barrier (csrc/sketch_common.cuh finalize_wide_warps,
// which #3's single-rule kernel runs too).
//
// The reset writes one pane of the state (67 MB at the 256-rule group,
// 0.020 ms; 1.06 / 4.2 GB a sketch pane): one launch over every
// (component, rule) pane run, 16-byte stores in a grid-stride loop of
// three instructions a store (a scalar head up to the first 16-byte
// boundary and a scalar tail where a run is not a multiple of 4 floats),
// a float4 a thread up to RESET_BLOCKS blocks a rule, past that four a
// thread. Measured on the H100 (PERF.md, section 6, #17): one card-sized
// wave of threads that each walked every run's float4s with their own
// (rule, float4) bookkeeping reached 86 % of the bound on the 4.2 GB
// pane, one float4 a thread (a million blocks) 43 %, 16 a thread 97.1 %,
// four a thread 98.2 % (fill_ 97.6 %); on the 1.06 GB hll pane four a
// thread 97.0 %, one a thread 90.8 %.

#include "radix_sort.cuh"
#include "sketch_common.cuh"

#define MAX_RULES 65535     // rules a group holds (the order's words in y)
#define RULES_PER_BLOCK 32  // rules of one thread's block (bits of a word)
#define FOLD_SHORT 32       // the longest segment one thread folds alone
#define FOLD_PIECE 512      // rows of one warp's piece of a longer segment
#define FOLD_THREADS 256
#define KEY_PLACE 4         // the key's lowest digit place (its low word)
#define RESET_BLOCKS 1024   // the reset's blocks a run at a float4 a thread

// Rule `rule`'s component pointers: each component's block of P * C * K
// floats, rule after rule (absent components stay null).
__device__ __forceinline__ Comps rule_comps(const Comps& cp, int rule,
                                            int64_t pcs) {
  Comps rc;
  for (int j = 0; j < N_COMPS; ++j) {
    rc.p[j] = cp.p[j] != nullptr ? cp.p[j] + rule * pcs * cp.k[j] : nullptr;
    rc.k[j] = cp.k[j];
  }
  return rc;
}

// ------------------------------------------------------------- the order
// A row's sort key: its flat (pane, slot) index, or a pad (a slot outside
// [0, C) or a pane outside [0, P): the row is dropped, as the TPU
// program's out-of-range scatter drops it).
struct FoldSrc {
  const int32_t* slots;
  const uint8_t* pane_vec;
  int pane, P, C;
  __device__ __forceinline__ void row(long long i, bool* pad, uint32_t* s,
                                      uint32_t* vb) const {
    const int slot = slots[i];
    const int p = pane_vec != nullptr ? (int)pane_vec[i] : pane;
    const bool ok = slot >= 0 && slot < C && p < P;
    *pad = !ok;
    *s = ok ? (uint32_t)p * (uint32_t)C + (uint32_t)slot : 0u;
    *vb = 0u;
  }
};

// The sorted payloads as row indices (dropped rows last), and each key's
// first position among the real rows: offsets[k] = the count of real rows
// whose key is below k (a binary search of the sorted keys), so key k's
// segment is [offsets[k], offsets[k + 1]) and offsets[K] the real rows.
__global__ void fold_order_finish_kernel(const SortBufs sb, int n,
                                         const SortPlan* __restrict__ sp,
                                         int K, int32_t* __restrict__ rows,
                                         int32_t* __restrict__ offsets) {
  const unsigned long long* keys;
  const uint32_t* pays;
  sorted_by(sb, __popc(sp->plan[0]), &keys, &pays);
  const int n_real = (int)sp->n_real;
  const long long end = n > K + 1 ? n : (long long)K + 1;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < end; i += (long long)gridDim.x * blockDim.x) {
    if (i < n) rows[i] = (int32_t)(pays[i] & ~PAD_BIT);
    if (i <= K) {
      int lo = 0, hi = n_real;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((uint32_t)(keys[mid] >> 32) < (uint32_t)i)
          lo = mid + 1;
        else
          hi = mid;
      }
      offsets[i] = lo;
    }
  }
}

// Each rule's WHERE bit of a row packed: bits[r * nw + w] bit q is
// base[32 w + q, r]. A thread takes four rows of one word (base read four
// bytes a lane, coalesced over rows; `vec` where every quad is 4-byte
// aligned).
__global__ void pack_rule_bits_kernel(const uint8_t* __restrict__ base, int n,
                                      int n_rules, int nw, int vec,
                                      uint32_t* __restrict__ bits) {
  const int w = blockIdx.y;
  const int rule0 = w * RULES_PER_BLOCK;
  const int nr = min(RULES_PER_BLOCK, n_rules - rule0);
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q * 4 < n; q += (long long)gridDim.x * blockDim.x) {
    const long long r0 = q * 4;
    uint32_t word[4] = {0u, 0u, 0u, 0u};
    if (vec && r0 + 4 <= n) {
      for (int i = 0; i < nr; ++i) {
        const uint32_t b =
            *(const uint32_t*)(base + (long long)(rule0 + i) * n + r0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word[j] |= (uint32_t)(((b >> (8 * j)) & 0xffu) != 0) << i;
      }
    } else {
      for (int i = 0; i < nr; ++i)
        for (int j = 0; j < 4 && r0 + j < n; ++j)
          word[j] |= (uint32_t)(base[(long long)(rule0 + i) * n + r0 + j] != 0)
                     << i;
    }
    for (int j = 0; j < 4 && r0 + j < n; ++j)
      bits[(r0 + j) * nw + w] = word[j];
  }
}

// The fold's inputs put in the order (FoldArgs): position i < the kept
// rows takes row rows[i]'s packed words (one 32-byte sector read while
// nw <= 8) and its spec values and masks; the outputs are written
// coalesced, the words word-major.
__global__ void fold_gather_kernel(const int32_t* __restrict__ rows,
                                   const int32_t* __restrict__ n_kept,
                                   int n, int S, const float* __restrict__ V,
                                   const uint8_t* __restrict__ M,
                                   const uint32_t* __restrict__ bits, int nw,
                                   float* __restrict__ Vs,
                                   uint8_t* __restrict__ Ms,
                                   uint32_t* __restrict__ bits_s) {
  const int kept = *n_kept;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < kept;
       i += gridDim.x * blockDim.x) {
    const int64_t r = rows[i];
    for (int w = 0; w < nw; ++w)
      bits_s[(int64_t)w * n + i] = bits[r * nw + w];
    for (int s = 0; s < S; ++s) {
      Vs[(int64_t)s * n + i] = V[(int64_t)s * n + r];
      Ms[(int64_t)s * n + i] = M[(int64_t)s * n + r];
    }
  }
}

// -------------------------------------------------------------- the fold
// What a fold pass adds up: act (every row whose WHERE bit holds), or one
// state column over the rows whose spec mask also holds.
enum { OP_ACT = 0, OP_N, OP_S1, OP_S2, OP_MN, OP_MX };

// A float's bits, mapped so that unsigned order is the order the sign-split
// atomics of csrc/groupby_common.cuh keep (-0 below +0, the infinities at
// the ends): a register min / max picks the value those atomics would.
__device__ __forceinline__ uint32_t f32_order(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <int OP>
__device__ __forceinline__ float op_ident() {
  return OP == OP_MN ? f32_inf() : (OP == OP_MX ? -f32_inf() : 0.0f);
}

template <int OP>
__device__ __forceinline__ float op_combine(float a, float b) {
  if (OP == OP_MN) return f32_order(b) < f32_order(a) ? b : a;
  if (OP == OP_MX) return f32_order(b) > f32_order(a) ? b : a;
  return __fadd_rn(a, b);
}

// *d combined with v: a plain read-modify-write (the only writer of d) or
// an atomic (one piece of a segment others also write).
template <int OP>
__device__ __forceinline__ void op_store(float* d, float v, bool atomic) {
  if (!atomic) {
    *d = op_combine<OP>(*d, v);
  } else if (OP == OP_MN) {
    atomic_min_f32(d, v);
  } else if (OP == OP_MX) {
    atomic_max_f32(d, v);
  } else {
    atomicAdd(d, v);
  }
}

// The fold's inputs in the order: position i holds the values of row
// rows[i], so a segment's rows are contiguous and neighbouring threads'
// segments neighbours (fold_gather_kernel writes them).
struct FoldArgs {
  const uint32_t* bits;  // (nw, n) packed WHERE bits, word-major
  int nw;
  const float* V;        // (S, n)
  const uint8_t* M;      // (S, n)
  int n;
  const int32_t* slots;
  const uint8_t* pane_vec;
  int pane, P, C;
  const int32_t* rows;     // the order
  const int32_t* offsets;  // (P * C + 1,)
  int n_rules;
  ColMap cm;
  Comps cp;
  float* act;
};

// acc[q] combined with the value of each row of the order's positions lo,
// lo + step, ... below hi that rule q of block rb keeps (OP_ACT: its WHERE
// bit; a column: its WHERE bit and the spec's mask); the rules' bits of the
// rows taken. A row's bits, mask and value are loaded together, with no
// branch between them, so that their latencies overlap.
template <int OP>
__device__ __forceinline__ uint32_t gather_rules(const FoldArgs& a, int rb,
                                                 int spec, int lo, int hi,
                                                 int step, float acc[32]) {
  uint32_t hit = 0u;
#pragma unroll 4
  for (int i = lo; i < hi; i += step) {
    const int64_t at = (int64_t)spec * a.n + i;
    uint32_t w = a.bits[(int64_t)rb * a.n + i];
    float x = 1.0f;
    if (OP != OP_ACT) {
      const bool m = a.M[at] != 0;
      if (OP != OP_N) x = a.V[at];
      if (OP == OP_S2) x = __fmul_rn(x, x);
      w = m ? w : 0u;
    }
    hit |= w;
#pragma unroll
    for (int q = 0; q < 32; ++q)
      if ((w >> q) & 1u) acc[q] = op_combine<OP>(acc[q], x);
  }
  return hit;
}

// One pass of a thread over its key's short segment [lo, hi): the rules'
// values in registers, then each touched rule's slot written once. dst0:
// the block's first rule's element of this (key, column); stride: floats
// between two rules.
template <int OP>
__device__ __forceinline__ void thread_pass(const FoldArgs& a, int rb,
                                            int nr, int spec, int lo, int hi,
                                            float* dst0, int64_t stride) {
  float acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = op_ident<OP>();
  const uint32_t hit = gather_rules<OP>(a, rb, spec, lo, hi, 1, acc) &
                       (nr < 32 ? (1u << nr) - 1u : ~0u);
  // every touched rule's old value loaded before any store, so that the
  // loads (one a rule, from device memory) are in flight together
  float old[32];
#pragma unroll
  for (int q = 0; q < 32; ++q)
    old[q] = ((hit >> q) & 1u) ? dst0[q * stride] : 0.0f;
#pragma unroll
  for (int q = 0; q < 32; ++q)
    if ((hit >> q) & 1u) dst0[q * stride] = op_combine<OP>(old[q], acc[q]);
}

// The 32 lanes' acc[32] reduced and scattered: lane q returns the
// combination over the warp of acc[q] (recursive halving, 31 shuffles; a
// fixed order, so the sums do not depend on the run).
template <int OP>
__device__ __forceinline__ float reduce_scatter(float acc[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int j = 0; j < o; ++j) {
      const float send = up ? acc[j] : acc[j + o];
      const float keep = up ? acc[j + o] : acc[j];
      acc[j] = op_combine<OP>(keep, __shfl_xor_sync(FULL_MASK, send, o));
    }
  }
  return acc[0];
}

// One pass of a warp over a piece [lo, hi) of a long segment (every lane
// calls it): lanes over rows, then lane q writes rule q once, atomically
// where other pieces share the segment.
template <int OP>
__device__ __forceinline__ void warp_pass(const FoldArgs& a, int rb, int nr,
                                          int spec, int lo, int hi,
                                          float* dst0, int64_t stride,
                                          bool atomic) {
  const int lane = threadIdx.x & 31;
  float acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = op_ident<OP>();
  const uint32_t hit = __reduce_or_sync(
      FULL_MASK, gather_rules<OP>(a, rb, spec, lo + lane, hi, 32, acc));
  if (hit == 0u) return;
  const float total = reduce_scatter<OP>(acc);
  if (lane < nr && ((hit >> lane) & 1u))
    op_store<OP>(dst0 + lane * stride, total, atomic);
}

// Every pass over the rows [lo, hi) of key `key` for the block rb: act,
// then each state column. WARP: a warp's piece (atomic where `atomic`),
// else one thread's short segment.
template <bool WARP>
__device__ __forceinline__ void fold_segment(const FoldArgs& a, int rb,
                                             int64_t key, int lo, int hi,
                                             bool atomic) {
  const int rule0 = rb * RULES_PER_BLOCK;
  const int nr = min(RULES_PER_BLOCK, a.n_rules - rule0);
  const int64_t pcs = (int64_t)a.P * a.C;
  float* act0 = a.act + rule0 * pcs + key;
  if (WARP)
    warp_pass<OP_ACT>(a, rb, nr, 0, lo, hi, act0, pcs, atomic);
  else
    thread_pass<OP_ACT>(a, rb, nr, 0, lo, hi, act0, pcs);
  for (int j = 0; j < a.cm.n; ++j) {
    const int comp = a.cm.comp[j], spec = a.cm.spec[j];
    const int64_t K = a.cp.k[comp];
    float* d0 = a.cp.p[comp] + rule0 * pcs * K + key * K + a.cm.k[j];
    const int64_t st = pcs * K;
#define FOLD_PASS(OPC)                                                   \
  if (WARP)                                                              \
    warp_pass<OPC>(a, rb, nr, spec, lo, hi, d0, st, atomic);             \
  else                                                                   \
    thread_pass<OPC>(a, rb, nr, spec, lo, hi, d0, st)
    switch (comp) {
      case C_N: FOLD_PASS(OP_N); break;
      case C_S1: FOLD_PASS(OP_S1); break;
      case C_S2: FOLD_PASS(OP_S2); break;
      case C_MN: FOLD_PASS(OP_MN); break;
      default: FOLD_PASS(OP_MX); break;
    }
#undef FOLD_PASS
  }
}

// Keys in x (grid-stride), a block of 32 rules in y: each key whose
// segment holds 1..FOLD_SHORT rows, by one thread.
__global__ void __launch_bounds__(FOLD_THREADS)
    multirule_fold_keys_kernel(const FoldArgs a) {
  const int64_t pcs = (int64_t)a.P * a.C;
  for (int64_t key = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       key < pcs; key += (int64_t)gridDim.x * blockDim.x) {
    const int lo = a.offsets[key], hi = a.offsets[key + 1];
    if (lo == hi || hi - lo > FOLD_SHORT) continue;
    fold_segment<false>(a, blockIdx.y, key, lo, hi, false);
  }
}

__device__ __forceinline__ int64_t key_of(const FoldArgs& a, int r) {
  const int p = a.pane_vec != nullptr ? (int)a.pane_vec[r] : a.pane;
  return (int64_t)p * a.C + a.slots[r];
}

// A warp per 32-row tile of the order, a block of 32 rules in y: the
// pieces of segments longer than FOLD_SHORT that start in the tile. Such
// a segment holds the tile's first or last row, so lane 0 looks at the
// first row's segment and lane 1 at the last row's; a segment has at
// most one piece start in a tile (pieces start FOLD_PIECE rows apart).
__global__ void __launch_bounds__(FOLD_THREADS)
    multirule_fold_pieces_kernel(const FoldArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t tile =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_real = a.offsets[(int64_t)a.P * a.C];
  const int64_t first = tile * 32;
  bool have = false, many = false;
  int lo = 0, hi = 0;
  int64_t key = 0;
  if (first < n_real && lane < 2) {
    const int last = (int)min(first + 31, (int64_t)n_real - 1);
    key = key_of(a, a.rows[lane == 0 ? (int)first : last]);
    const int s = a.offsets[key], e = a.offsets[key + 1];
    // lane 1's segment also holds the first row: lane 0's
    const bool dup = lane == 1 && s <= first;
    if (!dup && e - s > FOLD_SHORT) {
      const int j = first > s ? (int)((first - s + FOLD_PIECE - 1) /
                                      FOLD_PIECE) : 0;
      const int p0 = s + j * FOLD_PIECE;
      if (p0 <= last && p0 < e) {
        have = true;
        lo = p0;
        hi = min(p0 + FOLD_PIECE, e);
        many = e - s > FOLD_PIECE;
      }
    }
  }
  for (uint32_t todo = __ballot_sync(FULL_MASK, have); todo != 0u;
       todo &= todo - 1u) {
    const int src = __ffs(todo) - 1;
    const int plo = __shfl_sync(FULL_MASK, lo, src);
    const int phi = __shfl_sync(FULL_MASK, hi, src);
    const int64_t pkey = __shfl_sync(FULL_MASK, (long long)key, src);
    const bool pmany = __shfl_sync(FULL_MASK, (int)many, src) != 0;
    fold_segment<true>(a, blockIdx.y, pkey, plo, phi, pmany);
  }
}

// Rows of the order in x, a block of up to RULES_PER_BLOCK rules in y.
// A thread reads its row's packed bits for the block's rules and skips a
// row no rule of the block keeps; then, for each wide column whose spec
// mask M[s] is set, it computes hll's register and rho, or the histogram
// bin, once, and applies it to the state of every rule whose bit is set,
// rule by rule in the same order in every lane: an atomic max of rho, or
// an add of 1. The order holds only rows inside the state (slot in
// [0, C), pane in [0, P)); the row's pane is `pane`, or pane_vec[r]. Only
// hll and hist columns (the entry point refuses hh).
__global__ void multirule_fold_wide_kernel(const uint32_t* __restrict__ bits,
                                           int nw,
                                           const float* __restrict__ V,
                                           const uint8_t* __restrict__ M,
                                           const int32_t* __restrict__ slots,
                                           int n_rows, int n_rules, int pane,
                                           const uint8_t* __restrict__ pane_vec,
                                           int P, int C,
                                           const int32_t* __restrict__ rows,
                                           const int32_t* __restrict__ offsets,
                                           WideCols wc, Wide w,
                                           HistConsts hc) {
  const int rule0 = blockIdx.y * RULES_PER_BLOCK;
  const int nr = min(RULES_PER_BLOCK, n_rules - rule0);
  const int n_real = offsets[(int64_t)P * C];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_real;
       i += gridDim.x * blockDim.x) {
    const int r = rows[i];
    const uint32_t b = bits[(int64_t)r * nw + blockIdx.y];
    if (b == 0u) continue;
    const int slot = slots[r];
    const int p = pane_vec != nullptr ? (int)pane_vec[r] : pane;
    for (int j = 0; j < wc.n; ++j) {
      const int64_t at = (int64_t)wc.spec[j] * n_rows + r;
      if (!M[at]) continue;
      const int comp = wc.comp[j];
      const int64_t K = w.k[comp], W = kWideW[comp];
      const int64_t rule_len = (int64_t)P * C * K * W;
      const float v = V[at];
      int idx;
      float rho = 0.0f;
      if (comp == W_HLL) {
        idx = hll_reg_rho(v, &rho);
        if (!(rho > 0.0f)) continue;
      } else {
        idx = hist_bin(v, hc);
      }
      float* dst = w.p[comp] + rule0 * rule_len +
                   (((int64_t)p * C + slot) * K + wc.k[j]) * W + idx;
      for (int q = 0; q < nr; ++q) {
        if (!((b >> q) & 1u)) continue;
        float* d = dst + (int64_t)q * rule_len;
        if (comp == W_HLL)
          atomic_max_f32(d, rho);
        else
          atomicAdd(d, 1.0f);
      }
    }
  }
}

// Slots [0, K) in x, the rule in y: each rule's panes under the mask pm,
// its final values and act into out[rule] (rows, K). Only the K columns
// the host takes are written (K <= C).
__global__ void multirule_finalize_kernel(Comps cp,
                                          const float* __restrict__ act,
                                          const uint8_t* __restrict__ pm,
                                          int P, int C, int K, SpecTab st,
                                          int rows, float* __restrict__ out) {
  const int rule = blockIdx.y;
  const int64_t pcs = (int64_t)P * C;
  const Comps rc = rule_comps(cp, rule, pcs);
  const float* ract = act + rule * pcs;
  float* rout = out + (int64_t)rule * rows * K;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < K;
       c += gridDim.x * blockDim.x)
    finalize_slot(rc, ract, pm, P, C, st, rows, c, rout, K);
}

// Every rule's keys [0, K): a warp a (rule, key) on a persistent grid
// computes the key's hll and percentile_approx final values from the
// rule's panes under the mask pm (csrc/sketch_common.cuh
// finalize_wide_warps) into their rows of out[rule] (rows, K).
__global__ void __launch_bounds__(FIN_THREADS)
multirule_finalize_wide_kernel(Wide w, const uint8_t* __restrict__ pm, int P,
                               int C, int K, int n_rules, WideSpecs ws,
                               HistConsts hc, float hll_num, int rows,
                               float* __restrict__ out) {
  finalize_wide_warps(w, pm, P, C, K, n_rules, ws, hc, hll_num,
                      (long long)rows * K, out);
}

// Pane `pane` of every rule and every component back to its identity:
// rule r's pane of component j is one contiguous run of len floats at
// (r * P + pane) * len. The rule is blockIdx.y; threads in x store the
// run's float4s from its first 16-byte boundary (its body) grid-stride,
// neighbouring threads on neighbouring float4s, and the first thread the
// scalar head and tail (the floats before that boundary and after the
// body's last float4).
__global__ void __launch_bounds__(FOLD_THREADS)
    multirule_reset_kernel(ResetTab rt, int P, int pane) {
  const int64_t rp = (int64_t)blockIdx.y * P + pane;
  const int64_t c0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int j = 0; j < rt.n; ++j) {
    const int64_t len = rt.len[j];
    float* run = rt.p[j] + rp * len;
    const int64_t mis = (int64_t)(((uintptr_t)run >> 2) & 3u);
    const int64_t head = min((4 - mis) & 3, len);
    const int64_t body = (len - head) / 4;
    const float init = rt.init[j];
    const float4 v4 = make_float4(init, init, init, init);
    float4* run4 = reinterpret_cast<float4*>(run + head);
    for (int64_t c = c0; c < body; c += stride) run4[c] = v4;
    if (c0 == 0) {
      for (int64_t e = 0; e < head; ++e) run[e] = init;
      for (int64_t e = head + 4 * body; e < len; ++e) run[e] = init;
    }
  }
}

// ------------------------------------------------------------------ host
static inline size_t up16(size_t x) { return (x + 15) & ~(size_t)15; }

// The order's scratch over n rows: three key and payload buffers, then the
// zeroed part (the plan, the passes' look-back words, one status slot a
// digit place of the 32-bit key).
struct OrderLayout {
  size_t k[3], p[3], plan, status, zero_bytes, total;
  int tiles;
};

static OrderLayout order_layout(int n) {
  OrderLayout L;
  L.tiles = blocks_of(n > 0 ? n : 1, RADIX_TILE);
  size_t off = 0;
  for (int i = 0; i < 3; ++i) {
    L.k[i] = off;
    off += (size_t)n * sizeof(unsigned long long);
  }
  for (int i = 0; i < 3; ++i) {
    L.p[i] = off;
    off += (size_t)n * sizeof(uint32_t);
  }
  L.plan = up16(off);
  L.status = up16(L.plan + sizeof(SortPlan));
  L.total = up16(L.status + (size_t)4 * L.tiles * BINS * sizeof(uint32_t));
  L.zero_bytes = L.total - L.plan;
  return L;
}

// The digit places the key's real values use: its bytes below K.
static inline int key_places(long long K) {
  int b = 1;
  while (b < 4 && (K - 1) >> (8 * b)) ++b;
  return b;
}

// base packed into bits (n, nw) words, nw = ceil(n_rules / 32).
static void pack_bits(const uint8_t* base, int n, int n_rules, int nw,
                      uint32_t* bits, cudaStream_t st) {
  const int vec = (n % 4 == 0) && (((uintptr_t)base & 3u) == 0);
  const dim3 grid(grid_for((n + 3) / 4, 256), nw);
  pack_rule_bits_kernel<<<grid, 256, 0, st>>>(base, n, n_rules, nw, vec,
                                              bits);
}

static inline bool group_ok(int n_rows, int n_rules, int pane, int P, int C) {
  return n_rows >= 0 && n_rows <= MAX_B && n_rules >= 0 &&
         n_rules <= MAX_RULES && P >= 1 && C >= 1 &&
         (long long)P * C < 0x7fffffffLL && pane >= 0 && pane < P;
}

extern "C" {

// Bytes of scratch multirule_fold_order takes over n rows; -1 for an n it
// refuses.
long long multirule_order_scratch_bytes(int n) {
  if (n < 0 || n > MAX_B) return -1;
  return (long long)order_layout(n).total;
}

// slots: device int32 (n,); pane_vec: device uint8 (n,) or null (then
// every row's pane is `pane`); scratch: multirule_order_scratch_bytes(n)
// device bytes. rows: device int32 (n,), the row indices stably ordered
// by pane * C + slot, the dropped rows (slot outside [0, C), pane outside
// [0, P)) last; offsets: device int32 (P * C + 1,), key k's segment of
// rows is [offsets[k], offsets[k + 1]). base: device uint8 (n_rules, n)
// or null; where given, bits (device uint32 (n, nw), nw = ceil(n_rules /
// 32)) takes its packed words, which both folds then read as they are.
int multirule_fold_order(const int32_t* slots, int n, int pane,
                         const uint8_t* pane_vec, int P, int C,
                         const uint8_t* base, int n_rules, uint32_t* bits,
                         void* scratch, int32_t* rows, int32_t* offsets,
                         void* stream) {
  if (!group_ok(n, base ? n_rules : 1, pane, P, C))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int K = P * C;
  if (base && n > 0 && n_rules > 0)
    pack_bits(base, n, n_rules, (n_rules + RULES_PER_BLOCK - 1) /
              RULES_PER_BLOCK, bits, st);
  if (n == 0)
    return (int)cudaMemsetAsync(offsets, 0, (size_t)(K + 1) * sizeof(int32_t),
                                st);
  const OrderLayout L = order_layout(n);
  char* s = (char*)scratch;
  cudaError_t err = cudaMemsetAsync(s + L.plan, 0, L.zero_bytes, st);
  if (err != cudaSuccess) return (int)err;
  SortBufs sb;
  sb.k0 = (const unsigned long long*)(s + L.k[0]);
  sb.p0 = (const uint32_t*)(s + L.p[0]);
  for (int i = 0; i < 2; ++i) {
    sb.k[i] = (unsigned long long*)(s + L.k[i + 1]);
    sb.p[i] = (uint32_t*)(s + L.p[i + 1]);
  }
  SortPlan* sp = (SortPlan*)(s + L.plan);
  radix_hist_kernel<false><<<hist_blocks(n), SEG_THREADS, 0, st>>>(
      FoldSrc{slots, pane_vec, pane, P, C}, n,
      (unsigned long long*)(s + L.k[0]), (uint32_t*)(s + L.p[0]), sp,
      nullptr);
  radix_passes(sb, n, sp, (uint32_t*)(s + L.status), L.tiles, 0, KEY_PLACE,
               KEY_PLACE + key_places(K), 0, st);
  const long long end = n > K + 1 ? n : (long long)K + 1;
  fold_order_finish_kernel<<<grid_for(end, 256), 256, 0, st>>>(
      sb, n, sp, K, rows, offsets);
  return (int)cudaGetLastError();
}

// base: device uint8 (n_rules, n_rows), or null where bits already holds
// its packed words (multirule_fold_order's); V: float32 (S, n_rows); M:
// uint8 (S, n_rows); slots: int32 (n_rows,). pane_vec: device uint8 (n_rows,)
// per-row panes that replace `pane`, or null. colmap: host int32 (ncols,
// 3) = (comp, k, spec). comp_ptrs / comp_k: host arrays of N_COMPS device
// pointers to rule 0's block (null = absent) and widths; act: float32
// (n_rules, P, C). rows / offsets: multirule_fold_order's of these slots
// and panes. Device scratch: bits and bits_s uint32 (n_rows, nw) and (nw,
// n_rows), nw = ceil(n_rules / 32); Vs float32 and Ms uint8 (n_specs,
// n_rows), n_specs = V's rows.
int multirule_fold(const uint8_t* base, const float* V, const uint8_t* M,
                   const int32_t* slots, int n_rows, int n_rules, int pane,
                   const uint8_t* pane_vec, int P, int C,
                   const int32_t* colmap, int ncols, float* const* comp_ptrs,
                   const int32_t* comp_k, float* act, const int32_t* rows,
                   const int32_t* offsets, int n_specs, uint32_t* bits,
                   uint32_t* bits_s, float* Vs, uint8_t* Ms, void* stream) {
  ColMap cm;
  if (!make_colmap(colmap, ncols, &cm) ||
      !group_ok(n_rows, n_rules, pane, P, C) || n_specs < 0)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < ncols; ++j)
    if (cm.spec[j] < 0 || cm.spec[j] >= n_specs)
      return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || n_rules == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int nw = (n_rules + RULES_PER_BLOCK - 1) / RULES_PER_BLOCK;
  if (base) pack_bits(base, n_rows, n_rules, nw, bits, st);
  const int32_t* kept = offsets + (int64_t)P * C;
  fold_gather_kernel<<<grid_for(n_rows, 256), 256, 0, st>>>(
      rows, kept, n_rows, n_specs, V, M, bits, nw, Vs, Ms, bits_s);
  FoldArgs a;
  a.bits = bits_s;
  a.nw = nw;
  a.V = Vs;
  a.M = Ms;
  a.n = n_rows;
  a.slots = slots;
  a.pane_vec = pane_vec;
  a.pane = pane;
  a.P = P;
  a.C = C;
  a.rows = rows;
  a.offsets = offsets;
  a.n_rules = n_rules;
  a.cm = cm;
  a.cp = make_comps(comp_ptrs, comp_k);
  a.act = act;
  const dim3 keys(grid_for((long long)P * C, FOLD_THREADS), nw);
  multirule_fold_keys_kernel<<<keys, FOLD_THREADS, 0, st>>>(a);
  const long long tiles = (n_rows + 31) / 32;
  const dim3 pieces(blocks_of(tiles * 32, FOLD_THREADS), nw);
  multirule_fold_pieces_kernel<<<pieces, FOLD_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// spectab: host int32 (nspecs, 2 + N_COMPS), as groupby_finalize_scalar's;
// pane_mask: device uint8 (P,); out: device float32 (n_rules, rows, K),
// act in each rule's last row.
int multirule_finalize(float* const* comp_ptrs, const int32_t* comp_k,
                       const float* act, const uint8_t* pane_mask,
                       int n_rules, int P, int C, int K,
                       const int32_t* spectab, int nspecs, int rows,
                       float* out, void* stream) {
  SpecTab st;
  if (!make_spectab(spectab, nspecs, rows, &st) || n_rules < 0 ||
      n_rules > MAX_RULES || K < 0 || K > C)
    return (int)cudaErrorInvalidValue;
  if (K == 0 || n_rules == 0) return (int)cudaSuccess;
  const int threads = 256;
  const dim3 grid(grid_for(K, threads), n_rules);
  multirule_finalize_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      make_comps(comp_ptrs, comp_k), act, pane_mask, P, C, K, st, rows, out);
  return (int)cudaGetLastError();
}

// base, V, M, slots, pane, pane_vec, rows, offsets, bits: as
// multirule_fold. colmap: host int32 (ncols, 3) = (wide comp W_HLL or
// W_HIST, k, spec). wide_ptrs / wide_k: host arrays of N_WIDE device
// pointers to rule 0's block (null = absent) and widths; hist_consts: as
// csrc/groupby.cu groupby_fold's.
int multirule_fold_wide(const uint8_t* base, const float* V, const uint8_t* M,
                        const int32_t* slots, int n_rows, int n_rules,
                        int pane, const uint8_t* pane_vec, int P, int C,
                        const int32_t* colmap, int ncols,
                        float* const* wide_ptrs, const int32_t* wide_k,
                        const float* hist_consts, const int32_t* rows,
                        const int32_t* offsets, uint32_t* bits,
                        void* stream) {
  WideCols wc;
  if (!make_widecols(colmap, ncols, &wc) ||
      !group_ok(n_rows, n_rules, pane, P, C))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < ncols; ++j)
    if (wc.comp[j] != W_HLL && wc.comp[j] != W_HIST)
      return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || n_rules == 0 || ncols == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int nw = (n_rules + RULES_PER_BLOCK - 1) / RULES_PER_BLOCK;
  if (base) pack_bits(base, n_rows, n_rules, nw, bits, st);
  const int threads = 256;
  const dim3 grid(grid_for(n_rows, threads), nw);
  multirule_fold_wide_kernel<<<grid, threads, 0, st>>>(
      bits, nw, V, M, slots, n_rows, n_rules, pane, pane_vec, P, C, rows,
      offsets, wc, make_wide(wide_ptrs, wide_k), make_hc(hist_consts));
  return (int)cudaGetLastError();
}

// wide_ptrs / wide_k: as multirule_fold_wide's; spectab: host int32
// (nspecs, 3) = (kind WK_*, k, output row); fracs: host float32 (nspecs,);
// hll_num: float32(alpha·m·m); out: device float32 (n_rules, rows, K), from
// multirule_finalize, of which this kernel writes the specs' rows. The
// spec's state must be 16-byte aligned, P at most FIN_MAX_PANES.
int multirule_finalize_wide(float* const* wide_ptrs, const int32_t* wide_k,
                            const uint8_t* pane_mask, int n_rules, int P,
                            int C, int K, const int32_t* spectab,
                            const float* fracs, int nspecs,
                            const float* hist_consts, float hll_num, int rows,
                            float* out, void* stream) {
  WideSpecs ws;
  if (!make_widespecs(spectab, fracs, nspecs, &ws) || n_rules < 0 ||
      n_rules > MAX_RULES || K < 0 || K > C)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < nspecs; ++s)
    if (ws.row[s] < 0 || ws.row[s] >= rows - 1)
      return (int)cudaErrorInvalidValue;
  const Wide w = make_wide(wide_ptrs, wide_k);
  const long long items = (long long)n_rules * K;
  const cudaError_t bad = fin_check(w, ws, P, items);
  if (bad != cudaSuccess) return (int)bad;
  if (items == 0 || nspecs == 0) return (int)cudaSuccess;
  const int blocks =
      fin_blocks((const void*)multirule_finalize_wide_kernel, items);
  if (blocks < 0) return (int)cudaGetLastError();
  multirule_finalize_wide_kernel<<<blocks, FIN_THREADS, 0,
                                   (cudaStream_t)stream>>>(
      w, pane_mask, P, C, K, n_rules, ws, make_hc(hist_consts), hll_num,
      rows, out);
  return (int)cudaGetLastError();
}

// ptrs / lens / inits: host arrays of n components (device pointer to the
// state, floats in one pane of one rule, identity).
int multirule_reset_pane(float* const* ptrs, const long long* lens,
                         const float* inits, int n, int n_rules, int P,
                         int pane, void* stream) {
  ResetTab rt;
  const long long most = make_resettab(ptrs, lens, inits, n, &rt);
  if (most < 0 || n_rules < 0 || n_rules > MAX_RULES || pane < 0 ||
      pane >= P)
    return (int)cudaErrorInvalidValue;
  if (most == 0 || n_rules == 0) return (int)cudaSuccess;
  // a float4 a thread up to RESET_BLOCKS blocks a run, four past it
  const long long units = most / 4 > 0 ? most / 4 : 1;
  const long long one = (units + FOLD_THREADS - 1) / FOLD_THREADS;
  const long long four = (units + 4 * FOLD_THREADS - 1) / (4 * FOLD_THREADS);
  const long long blocks =
      one < RESET_BLOCKS ? one : (four > RESET_BLOCKS ? four : RESET_BLOCKS);
  const dim3 grid((unsigned)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL),
                  n_rules);
  multirule_reset_kernel<<<grid, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      rt, P, pane);
  return (int)cudaGetLastError();
}

}  // extern "C"
