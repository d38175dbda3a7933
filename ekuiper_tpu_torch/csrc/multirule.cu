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
//                      parameters bound
// multirule_finalize   replaces _batched_finalize_impl (210) and the key
//                      cut of finalize_begin (230-241)
// multirule_reset_pane replaces _batched_reset_impl (256)
//
// The per-row and per-slot arithmetic is csrc/groupby_common.cuh's, the
// same code the single-rule kernels run, so the two round alike.
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

#include "groupby_common.cuh"

#define MAX_RULES 65535  // gridDim.y

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
// `pane` of its rule as fold_scalar_kernel folds it; a slot outside [0, C)
// is dropped.
__global__ void multirule_fold_kernel(const uint8_t* __restrict__ base,
                                      const float* __restrict__ V,
                                      const uint8_t* __restrict__ M,
                                      const int32_t* __restrict__ slots,
                                      int n_rows, int pane, int P, int C,
                                      ColMap cm, Comps cp,
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
    const int64_t pc = (int64_t)pane * C + slot;
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
// (S, n_rows); slots: int32 (n_rows,). colmap: host int32 (ncols, 3) =
// (comp, k, spec). comp_ptrs / comp_k: host arrays of N_COMPS device
// pointers to rule 0's block (null = absent) and widths; act: float32
// (n_rules, P, C).
int multirule_fold(const uint8_t* base, const float* V, const uint8_t* M,
                   const int32_t* slots, int n_rows, int n_rules, int pane,
                   int P, int C, const int32_t* colmap, int ncols,
                   float* const* comp_ptrs, const int32_t* comp_k, float* act,
                   void* stream) {
  ColMap cm;
  if (!make_colmap(colmap, ncols, &cm) || n_rows < 0 || n_rules < 0 ||
      n_rules > MAX_RULES || pane < 0 || pane >= P)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || n_rules == 0) return (int)cudaSuccess;
  const int threads = 256;
  const dim3 grid(grid_for(n_rows, threads), n_rules);
  multirule_fold_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      base, V, M, slots, n_rows, pane, P, C, cm,
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
