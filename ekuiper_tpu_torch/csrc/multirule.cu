// The rule group's kernels, for Hopper (sm_90a): N homogeneous rules on a
// leading rule axis, each kernel ONE launch for every rule of the group.
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes). Every entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launch.
//
// State layout (the reference's BatchedGroupBy,
// ekuiper_tpu/parallel/multirule.py): rule r's block of every component is
// one rule's state of csrc/groupby_common.cuh, laid end to end:
//   comp[c] : float32 (NR, P, C, K_c)   act : float32 (NR, P, C)
// so rule r's component c starts r * P * C * K_c floats in.
//
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
// What bounds them on an H100, at the 256-rule group (65,536-row batches,
// 16,384 slots, 67 MB of state): the fold reads its inputs once (17.6 MB:
// the shared values and masks, the per-rule row masks, the slots), 5.3 us
// at 3.35 TB/s, but issues one atomic per (rule, passing row, state
// column) into 67 MB, more than L2 holds: tens of millions of scattered
// atomics, which set its time. The finalize reads the state (67 MB) and
// writes the (NR, S+1, K) result (50 MB), 0.035 ms; the reset writes one
// pane of the state, 0.020 ms. Design: the rule is blockIdx.y, so a block
// works inside one rule's state and the rule offset costs no division;
// threads run over rows (fold) or slots (finalize, reset) in x, coalesced
// on the row masks, the shared values and the output. The shared values
// and spec masks are read once per rule from L2. Parameters go by value,
// so no host-to-device copy precedes a launch.
//
// The wide kernels, at a 63-rule sketch group (16,384 slots): the state is
// 1.06 GB an hll pane and 4.2 GB a percentile pane, far past L2, and an
// update touches one register or bin of it. The wide fold reads its inputs
// once (the (R, n) row masks, the shared values and masks, the slots) and
// issues one atomic per (rule, passing row, sketch column): a register's
// or bin's hash and log are the costly per-row work, so a thread computes
// them ONCE for its row and applies them to each rule of a block of 32
// whose row-mask bit is set (blockIdx.y is that block of rules; the row
// masks of the block are read coalesced over rows). The wide finalize is
// bytes-bound: it reads each live (rule, pane, key) register or bin run
// once. One block of 256 threads per (rule, key), as the single-rule
// finalize's one block per key: the run is contiguous, so the reads
// coalesce, and the estimate's sums and the histogram's scan run in
// registers and shared memory.

#include "sketch_common.cuh"

#define MAX_RULES 65535  // gridDim.y
#define RULES_PER_BLOCK 32  // rules of one wide-fold block (bits of a mask)

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

// Rows of the batch in x, the rule in y. base[rule, r] is rule `rule`'s
// row mask after its WHERE; M[s] is spec s's mask (column validity AND
// not-NaN AND its FILTER, the same for every rule: only WHERE carries the
// rules' parameters), V[s] its float32 argument. A row folds into pane
// `pane` of its rule, or into pane_vec[r] when pane_vec is given (an
// event-time batch across bucket edges: the row's own bucket pane, the
// same for every rule), as fold_scalar_kernel folds it; a slot outside
// [0, C) or a pane outside [0, P) is dropped.
__global__ void multirule_fold_kernel(const uint8_t* __restrict__ base,
                                      const float* __restrict__ V,
                                      const uint8_t* __restrict__ M,
                                      const int32_t* __restrict__ slots,
                                      int n_rows, int pane,
                                      const uint8_t* __restrict__ pane_vec,
                                      int P, int C, ColMap cm, Comps cp,
                                      float* __restrict__ act) {
  const int rule = blockIdx.y;
  const int64_t pcs = (int64_t)P * C;
  const Comps rc = rule_comps(cp, rule, pcs);
  float* ract = act + rule * pcs;
  const uint8_t* rb = base + (int64_t)rule * n_rows;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += gridDim.x * blockDim.x) {
    if (!rb[r]) continue;
    const int slot = slots[r];
    if (slot < 0 || slot >= C) continue;
    const int p = pane_vec != nullptr ? (int)pane_vec[r] : pane;
    if (p >= P) continue;
    const int64_t pc = (int64_t)p * C + slot;
    atomicAdd(ract + pc, 1.0f);
    fold_row_columns(cm, rc, V, M, n_rows, r, pc);
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

// Rows of the batch in x, a block of up to RULES_PER_BLOCK rules in y.
// A thread reads its row's bits of base for the block's rules (coalesced
// over rows) and skips a row no rule of the block keeps; then, for each
// wide column whose spec mask M[s] is set, it computes hll's register and
// rho, or the histogram bin, once, and applies it to the state of every
// rule whose bit is set: an atomic max of rho, or an add of 1. max is
// order-free and the counts stay below 2^24, so the result does not depend
// on the order of the atomics. The row's pane is `pane`, or pane_vec[r]
// when pane_vec is given (multirule_fold_kernel's), read once with its
// slot. Only hll and hist columns (the entry point refuses hh); a slot
// outside [0, C) or a pane outside [0, P) is dropped.
__global__ void multirule_fold_wide_kernel(const uint8_t* __restrict__ base,
                                           const float* __restrict__ V,
                                           const uint8_t* __restrict__ M,
                                           const int32_t* __restrict__ slots,
                                           int n_rows, int n_rules, int pane,
                                           const uint8_t* __restrict__ pane_vec,
                                           int P, int C, WideCols wc, Wide w,
                                           HistConsts hc) {
  const int rule0 = blockIdx.y * RULES_PER_BLOCK;
  const int nr = min(RULES_PER_BLOCK, n_rules - rule0);
  const uint8_t* rb = base + (int64_t)rule0 * n_rows;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += gridDim.x * blockDim.x) {
    const int slot = slots[r];
    if (slot < 0 || slot >= C) continue;
    const int p = pane_vec != nullptr ? (int)pane_vec[r] : pane;
    if (p >= P) continue;
    uint32_t bits = 0;
    for (int i = 0; i < nr; ++i)
      bits |= (uint32_t)(rb[(int64_t)i * n_rows + r] != 0) << i;
    if (bits == 0) continue;
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
      for (uint32_t b = bits; b != 0; b &= b - 1) {
        float* d = dst + (int64_t)(__ffs(b) - 1) * rule_len;
        if (comp == W_HLL)
          atomic_max_f32(d, rho);
        else
          atomicAdd(d, 1.0f);
      }
    }
  }
}

// Keys [0, K) in x (grid-stride), the rule in y: one block of FIN_THREADS
// threads per (rule, key) computes the key's hll and percentile_approx
// final values from the rule's panes under the mask pm
// (csrc/sketch_common.cuh finalize_wide_slot) into their rows of
// out[rule] (rows, K).
__global__ void __launch_bounds__(FIN_THREADS)
multirule_finalize_wide_kernel(Wide w, const uint8_t* __restrict__ pm, int P,
                               int C, int K, WideSpecs ws, HistConsts hc,
                               float hll_num, int rows,
                               float* __restrict__ out) {
  __shared__ float shf[FIN_THREADS / 32];
  __shared__ int shi[FIN_THREADS / 32];
  const int rule = blockIdx.y;
  Wide rw;
  for (int j = 0; j < N_WIDE; ++j) {
    rw.k[j] = w.k[j];
    rw.p[j] = w.p[j] != nullptr
                  ? w.p[j] + rule * ((int64_t)P * C * w.k[j] * kWideW[j])
                  : nullptr;
  }
  float* rout = out + (int64_t)rule * rows * K;
  for (int c = blockIdx.x; c < K; c += gridDim.x)
    finalize_wide_slot(rw, pm, P, C, ws, hc, hll_num, c, rout, K, shf, shi);
}

// Pane `pane` of every rule (y) and every component back to its identity:
// rule r's pane of a component is one contiguous run of len floats at
// (r * P + pane) * len, stored grid-stride in x (coalesced).
__global__ void multirule_reset_kernel(ResetTab rt, int P, int pane) {
  const int rule = blockIdx.y;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int j = 0; j < rt.n; ++j) {
    float* a = rt.p[j] + ((int64_t)rule * P + pane) * rt.len[j];
    const float init = rt.init[j];
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < rt.len[j]; i += stride)
      a[i] = init;
  }
}

extern "C" {

// base: device uint8 (n_rules, n_rows); V: float32 (S, n_rows); M: uint8
// (S, n_rows); slots: int32 (n_rows,). pane_vec: device uint8 (n_rows,)
// per-row panes that replace `pane`, or null. colmap: host int32 (ncols,
// 3) = (comp, k, spec). comp_ptrs / comp_k: host arrays of N_COMPS device
// pointers to rule 0's block (null = absent) and widths; act: float32
// (n_rules, P, C).
int multirule_fold(const uint8_t* base, const float* V, const uint8_t* M,
                   const int32_t* slots, int n_rows, int n_rules, int pane,
                   const uint8_t* pane_vec, int P, int C,
                   const int32_t* colmap, int ncols, float* const* comp_ptrs,
                   const int32_t* comp_k, float* act, void* stream) {
  ColMap cm;
  if (!make_colmap(colmap, ncols, &cm) || n_rows < 0 || n_rules < 0 ||
      n_rules > MAX_RULES || pane < 0 || pane >= P)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || n_rules == 0) return (int)cudaSuccess;
  const int threads = 256;
  const dim3 grid(grid_for(n_rows, threads), n_rules);
  multirule_fold_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      base, V, M, slots, n_rows, pane, pane_vec, P, C, cm,
      make_comps(comp_ptrs, comp_k), act);
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

// base, V, M, slots, pane, pane_vec: as multirule_fold. colmap: host
// int32 (ncols, 3) = (wide comp W_HLL or W_HIST, k, spec). wide_ptrs /
// wide_k: host arrays of N_WIDE device pointers to rule 0's block (null =
// absent) and widths; hist_consts: as csrc/sketches.cu groupby_fold_wide's.
int multirule_fold_wide(const uint8_t* base, const float* V, const uint8_t* M,
                        const int32_t* slots, int n_rows, int n_rules,
                        int pane, const uint8_t* pane_vec, int P, int C,
                        const int32_t* colmap, int ncols,
                        float* const* wide_ptrs, const int32_t* wide_k,
                        const float* hist_consts, void* stream) {
  WideCols wc;
  if (!make_widecols(colmap, ncols, &wc) || n_rows < 0 || n_rules < 0 ||
      n_rules > MAX_RULES || pane < 0 || pane >= P)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < ncols; ++j)
    if (wc.comp[j] != W_HLL && wc.comp[j] != W_HIST)
      return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || n_rules == 0 || ncols == 0) return (int)cudaSuccess;
  const int threads = 256;
  const dim3 grid(grid_for(n_rows, threads),
                  (n_rules + RULES_PER_BLOCK - 1) / RULES_PER_BLOCK);
  multirule_fold_wide_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      base, V, M, slots, n_rows, n_rules, pane, pane_vec, P, C, wc,
      make_wide(wide_ptrs, wide_k), make_hc(hist_consts));
  return (int)cudaGetLastError();
}

// wide_ptrs / wide_k: as multirule_fold_wide's; spectab: host int32
// (nspecs, 3) = (kind WK_*, k, output row); fracs: host float32 (nspecs,);
// hll_num: float32(alpha·m·m); out: device float32 (n_rules, rows, K), from
// multirule_finalize, of which this kernel writes the specs' rows.
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
  if (K == 0 || n_rules == 0 || nspecs == 0) return (int)cudaSuccess;
  const dim3 grid(K < 65535 ? K : 65535, n_rules);
  multirule_finalize_wide_kernel<<<grid, FIN_THREADS, 0,
                                   (cudaStream_t)stream>>>(
      make_wide(wide_ptrs, wide_k), pane_mask, P, C, K, ws,
      make_hc(hist_consts), hll_num, rows, out);
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
  const int threads = 256;
  const long long blocks = (most + threads - 1) / threads;
  const dim3 grid(blocks < 1024 ? (int)blocks : 1024, n_rules);
  multirule_reset_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      rt, P, pane);
  return (int)cudaGetLastError();
}

}  // extern "C"
