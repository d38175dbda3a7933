// The one-launch fold of a micro-batch chunk, shared by csrc/groupby.cu
// (#1, DeviceGroupBy._fold_core, ekuiper_tpu/ops/groupby.py:348-441, and
// #2, _fold_masked_impl, 353-354: _fold_core under the refold's row mask
// over a refold's cached segments concatenated) and
// csrc/sharded.cu (#23 / #24, ShardedGroupBy's local_fold,
// ekuiper_tpu/parallel/sharded.py:221-331, 371-474): act, the scalar
// columns, the touch count and the hll / hist / hh columns of one chunk in
// ONE kernel launch, its blocks split into roles by index range:
//
//   [0, nb_s)              the scalar role: a thread a row, one global
//                          atomic a row into act, touch and each scalar
//                          column (fold_row_columns), but the count
//                          columns as vector atomics (add_count_run)
//   [nb_s, nb_s + nb_w)    the wide role: hll / hist, a thread a row
//   [nb_s + nb_w, nb)      the hh role: a thread a (row, depth), the
//                          float4 cell adds of fold_hh_cell
//
// The launch's parameters (FoldChunk, about 2.9 KB, __grid_constant__)
// carry the column maps by value, read in place from the parameter bank.
// A packed table of one word a column in a device array, copied into
// shared memory by each block, timed level with them (fold_routes.py)
// and was removed. Taking two or four rows a thread made the scalar role
// slower: its atomics bound it, and more threads keep more of them in
// flight.
//
// Owner routes, measured by fold_routes.py and not kept (PERF.md's
// findings): CTAs that each own a range of slots in shared memory and
// scan the batch for its rows, alone or as a thread-block cluster adding
// through distributed shared memory. At the main path's shape each took
// 4-25 times this route's body as it was then (one atomic a column,
// 0.0097 ms): gathering its rows' masks and values and adding
// them into shared memory took 16-21 µs a CTA, while a thread a row here
// keeps 65,536 rows' loads and atomics in flight at once.
//
// Semantics are the single kernels': a row past `base` whose slot lies
// outside [0, C) (or whose row shard lies past R_sh) is dropped; its touch
// still counts where only its pane lies outside [0, P'); touch wraps
// modulo 2^32; n, act, mn, mx, hll, hist and hh come out bit-equal to the
// plain version in any order of the adds (counts below 2^24; min / max
// order-free, -0 below +0); s1 / s2 round in another order (rtol 1e-5).
#pragma once

#include "groupby_common.cuh"
#include "sketch_common.cuh"

#define FOLD_THREADS 256

struct FoldChunk {
  // rows: base (N,), V / M (S, N), slots (N,), pane_vec (N,) or null
  const uint8_t* base;
  const float* V;
  const uint8_t* M;
  const void* slots;
  const uint8_t* pane_vec;
  int N;       // rows of the chunk
  int m;       // rows a row shard holds (N for a single-chip fold)
  int R_sh;    // row shards (1 for a single-chip fold)
  int pane;    // the scalar pane (0 for the mesh's P' = 1 partials)
  int Pp;      // panes a row shard's block holds
  int C;       // slots
  ColMap sc;   // the scalar columns but the counts (n)
  // the count columns: count_spec[k] is the spec of n's column k, -1
  // where the rule has none; n_count = the n state's width K_n when
  // the counts go as runs (0 < K_n <= 64), else 0 and they are in sc
  int n_count;
  int count_spec[MAX_COLS];
  WideCols wc; // the hll / hist columns
  WideCols hh; // the hh columns (none on the mesh)
  Comps cp;
  float* act;
  unsigned int* touch;  // (R_sh, C) counts, or null
  Wide w;
  HistConsts hc;
  // roles
  int nb_s, nb_w, nb_h;
};

// The pane of row i inside its row shard's block, or -1 where it lies
// outside [0, P').
__device__ __forceinline__ int row_pane(const FoldChunk& a, int i) {
  const int p = a.pane_vec != nullptr ? (int)a.pane_vec[i] : a.pane;
  return (p < 0 || p >= a.Pp) ? -1 : p;
}

// A row's count columns: 1.0 into column k of the run of K floats at `run`
// (n's columns of one slot) for each bit k of `bits`, a float4 atomic a
// 16-byte aligned group of 4 and a float2 one an 8-byte aligned pair,
// scalar atomics at the ends; 0.0 in a group's unset lanes (x + 0.0 keeps
// a count's bits: counts are never -0.0). Fewer atomic transactions than
// one a column: the fold's atomics at L2 bound it.
__device__ __forceinline__ void add_count_run(float* run, int K,
                                              uint64_t bits) {
  const int a = (int)((reinterpret_cast<uintptr_t>(run) >> 2) & 3u);
  for (int k = 0; k < K;) {
    const unsigned m = (unsigned)(bits >> k);
    if (((a + k) & 3) == 0 && k + 4 <= K) {
      if (m & 0xfu)
        atomicAdd(reinterpret_cast<float4*>(run + k),
                  make_float4((float)(m & 1u), (float)((m >> 1) & 1u),
                              (float)((m >> 2) & 1u),
                              (float)((m >> 3) & 1u)));
      k += 4;
    } else if (((a + k) & 1) == 0 && k + 2 <= K) {
      if (m & 3u)
        atomicAdd(reinterpret_cast<float2*>(run + k),
                  make_float2((float)(m & 1u), (float)((m >> 1) & 1u)));
      k += 2;
    } else {
      if (m & 1u) atomicAdd(run + k, 1.0f);
      k += 1;
    }
  }
}

// The one-launch fold's body (each library wraps it in a __global__ of its
// own name, its FoldChunk a __grid_constant__ parameter).
template <typename SlotT>
__device__ void fold_body(const FoldChunk& a) {
  const SlotT* slots = static_cast<const SlotT*>(a.slots);
  const int b = blockIdx.x;
  if (b < a.nb_s) {
    for (int i = b * FOLD_THREADS + threadIdx.x; i < a.N;
         i += a.nb_s * FOLD_THREADS) {
      if (!a.base[i]) continue;
      const int r = i / a.m;
      const int slot = (int)slots[i];
      if (r >= a.R_sh || slot < 0 || slot >= a.C) continue;
      if (a.touch != nullptr)
        atomicAdd(a.touch + (int64_t)r * a.C + slot, 1u);
      const int p = row_pane(a, i);
      if (p < 0) continue;
      const int64_t pc = ((int64_t)r * a.Pp + p) * a.C + slot;
      atomicAdd(a.act + pc, 1.0f);
      if (a.n_count > 0) {
        uint64_t bits = 0;
        for (int k = 0; k < a.n_count; ++k) {
          const int s = a.count_spec[k];
          if (s >= 0 && a.M[(int64_t)s * a.N + i]) bits |= 1ull << k;
        }
        add_count_run(a.cp.p[C_N] + pc * a.n_count, a.n_count, bits);
      }
      fold_row_columns(a.sc, a.cp, a.V, a.M, a.N, i, pc);
    }
    return;
  }
  if (b < a.nb_s + a.nb_w) {
    const int first = (b - a.nb_s) * FOLD_THREADS + threadIdx.x;
    for (int i = first; i < a.N; i += a.nb_w * FOLD_THREADS) {
      const int r = i / a.m;
      const int slot = (int)slots[i];
      const int p = row_pane(a, i);
      if (r >= a.R_sh || slot < 0 || slot >= a.C || p < 0) continue;
      fold_wide_columns(a.V, a.M, a.N, i,
                        ((int64_t)r * a.Pp + p) * a.C + slot, a.wc, a.w,
                        a.hc);
    }
    return;
  }
  // the hh role: a thread a (row, depth); the mesh has no hh columns
  const unsigned n = 2u * (unsigned)a.N;
  const unsigned first = (unsigned)(b - a.nb_s - a.nb_w) * FOLD_THREADS +
                         threadIdx.x;
  for (unsigned q = first; q < n; q += (unsigned)a.nb_h * FOLD_THREADS) {
    const int i = (int)(q >> 1), d = (int)(q & 1u);
    const int slot = (int)slots[i];
    const int p = row_pane(a, i);
    if (slot < 0 || slot >= a.C || p < 0) continue;
    const long long key = (long long)p * a.C + slot;
    for (int j = 0; j < a.hh.n; ++j) {
      const int64_t at = (int64_t)a.hh.spec[j] * a.N + i;
      if (!a.M[at]) continue;
      fold_hh_cell(a.w.p[W_HH], key, a.w.k[W_HH], a.hh.k[j], d,
                   (uint32_t)(long long)a.V[at]);
    }
  }
}

// The fold's column maps from the host's: colmap int32 (ncols, 3) of
// (COMP_IDS comp, k, spec), its count columns split into the count table
// where the n state's width k_n allows (a column k past it, or a second
// one for the same k, stays in a->sc); widemap int32 (nwide, 3) of
// (WIDE_IDS comp, k, spec), its hh columns split into a->hh in their
// order. False if a map holds more than MAX_COLS columns.
static inline bool fold_cols(const int32_t* colmap, int ncols,
                             const int32_t* widemap, int nwide, int k_n,
                             FoldChunk* a) {
  if (ncols < 0 || ncols > MAX_COLS || nwide < 0 || nwide > MAX_COLS)
    return false;
  a->n_count = k_n > 0 && k_n <= MAX_COLS ? k_n : 0;
  for (int k = 0; k < MAX_COLS; ++k) a->count_spec[k] = -1;
  a->sc.n = 0;
  for (int j = 0; j < ncols; ++j) {
    const int comp = colmap[3 * j], k = colmap[3 * j + 1];
    const int spec = colmap[3 * j + 2];
    if (comp == C_N && k >= 0 && k < a->n_count && a->count_spec[k] < 0) {
      a->count_spec[k] = spec;
      continue;
    }
    a->sc.comp[a->sc.n] = comp;
    a->sc.k[a->sc.n] = k;
    a->sc.spec[a->sc.n] = spec;
    ++a->sc.n;
  }
  a->wc.n = a->hh.n = 0;
  for (int j = 0; j < nwide; ++j) {
    WideCols& w = widemap[3 * j] == W_HH ? a->hh : a->wc;
    w.comp[w.n] = widemap[3 * j];
    w.k[w.n] = widemap[3 * j + 1];
    w.spec[w.n] = widemap[3 * j + 2];
    ++w.n;
  }
  return true;
}

// Sets the roles and launches `kern` (the library's __global__ around
// fold_body<SlotT>) on `st`: a thread a row for the scalar and wide roles
// and a (row, depth) for the hh role, each at most 65,535 blocks
// (grid-stride past that).
static cudaError_t launch_fold(void (*kern)(FoldChunk), FoldChunk a,
                               cudaStream_t st) {
  const long long rows = (a.N + FOLD_THREADS - 1) / FOLD_THREADS;
  a.nb_s = (int)(rows < 65535 ? rows : 65535);
  a.nb_w = a.wc.n > 0 ? a.nb_s : 0;
  a.nb_h = a.hh.n > 0 ? (int)(2 * rows < 65535 ? 2 * rows : 65535) : 0;
  kern<<<a.nb_s + a.nb_w + a.nb_h, FOLD_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}
