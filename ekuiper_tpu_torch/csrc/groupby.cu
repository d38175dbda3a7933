// Group-by kernels of the fused window aggregate, for Hopper (sm_90a).
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes). Every entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launch.
//
// State layout, launch tables and the device functions the kernels share
// with csrc/multirule.cu (the rule group's batched kernels): see
// csrc/groupby_common.cuh.
//
// groupby_fold_scalar    replaces DeviceGroupBy._fold_impl/_fold_core
//                        (ekuiper_tpu/ops/groupby.py:348-441), the
//                        touch column's bump (379-385) included
// groupby_fold_masked_scalar replaces _fold_masked_impl (354): the same
//                        fold under an explicit (mb,) row mask, into one
//                        pane (the sliding refold's edge folds), the
//                        touch column's bump included
// groupby_finalize_scalar replaces _finalize_impl/_finalize_dyn_impl ->
//                        _finalize_body/_merged/_final_value (444-520)
// groupby_reset_pane     replaces _reset_pane_impl (763), for every
//                        component: the scalar ones, act, and the wide
//                        sketch components of csrc/sketches.cu
//
// The sketch kernels (the wide fold, the wide finalize, heavy-hitter
// recovery) live in csrc/sketches.cu and fill other rows of the same
// finalize output: groupby_finalize_scalar writes each scalar spec's row
// and act, and skips the sketch kinds.
//
// What bounds them on an H100: each moves a few hundred KB to a few MB
// (rows in, the touched state lines, or one pane of state), which is
// well under a microsecond at 3.35 TB/s. At the main path's sizes
// (65,536 rows, 16,384 slots) each takes longer than that; how much of
// it is launch overhead and how much the body (for the fold, its
// atomics at L2) is what chip_smoke.py's body_ms / kernel_ms split
// reports. The design keeps every call to one launch, no scratch, no
// second pass, and parameters passed by value, so no host-to-device
// copy precedes a launch. The masked fold reads the mask of every row of
// the padded batch, and the slot, values and spec masks only of the rows
// the mask keeps (an edge refold keeps a time cut of one bucket), whose
// atomics it issues; like the fold, it takes far longer than its byte
// bound, its atomics at L2 being the likely limit.

#include "groupby_common.cuh"
#include "slot_type.cuh"

// One thread per row, grid-stride. `base` is the row mask after WHERE;
// M[s] is spec s's mask (base AND column validity AND not-NaN AND its
// FILTER), V[s] its float32 argument. A masked row writes nothing: the
// reference adds/mins/maxes the identity for it, which leaves the same
// state. The destination pane is `pane`, or pane_vec[r] when pane_vec is
// given (per-row panes: a sliding batch that crosses a bucket edge, the
// reference's uint8 pane vector). fold_scalar_row (csrc/groupby_common.cuh)
// drops a slot outside [0, C) or a pane outside [0, P). With a touch
// column (tiered key state) each row past `base` also adds one to its
// slot's uint32 touch counter.
template <typename SlotT>
__global__ void fold_scalar_kernel(const uint8_t* __restrict__ base,
                                   const float* __restrict__ V,
                                   const uint8_t* __restrict__ M,
                                   const SlotT* __restrict__ slots, int R,
                                   int pane, const uint8_t* __restrict__ pane_vec,
                                   int P, int C, ColMap cm, Comps cp,
                                   float* __restrict__ act,
                                   unsigned int* __restrict__ touch) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R;
       r += gridDim.x * blockDim.x) {
    if (!base[r]) continue;
    const int p = pane_vec != nullptr ? (int)pane_vec[r] : pane;
    fold_scalar_row(cm, cp, V, M, slots, R, r, p, P, C, act, touch);
  }
}

// The masked fold (#2): one thread per row of a cached, padded batch,
// grid-stride. mask[r] is the refold's row mask after WHERE (the rows of
// one bucket inside the window's time cut; padding rows are 0); M[s] is
// already ANDed with it. Every row goes to the one pane `pane` (the
// sliding refold's scratch pane). A row with mask 0 writes nothing, so
// the padding past the batch's real rows (slot 0) changes no act, no
// min/max identity, no counter. With a touch column (a tiered sliding
// rule) each row past the mask adds one to its slot's uint32 counter, as
// the reference's _fold_core does for its masked fold (groupby.py:379-385):
// the edge refolds count as touches of the rule's scratch-pane state.
template <typename SlotT>
__global__ void fold_masked_scalar_kernel(const uint8_t* __restrict__ mask,
                                          const float* __restrict__ V,
                                          const uint8_t* __restrict__ M,
                                          const SlotT* __restrict__ slots,
                                          int R, int pane, int P, int C,
                                          ColMap cm, Comps cp,
                                          float* __restrict__ act,
                                          unsigned int* __restrict__ touch) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R;
       r += gridDim.x * blockDim.x) {
    if (!mask[r]) continue;
    fold_scalar_row(cm, cp, V, M, slots, R, r, pane, P, C, act, touch);
  }
}

// One thread per slot: finalize_slot (csrc/groupby_common.cuh) writes each
// scalar spec's final value into its row of out (rows, C) and the merged
// act into the last row.
__global__ void finalize_scalar_kernel(Comps cp, const float* __restrict__ act,
                                       const uint8_t* __restrict__ pm, int P,
                                       int C, SpecTab st, int rows,
                                       float* __restrict__ out) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C;
       c += gridDim.x * blockDim.x)
    finalize_slot(cp, act, pm, P, C, st, rows, c, out, C);
}

// Grid-stride over each component's pane in turn: a pane of a (P, C, ...)
// component is one contiguous run of len floats, so neighbouring threads
// store to neighbouring addresses (coalesced) for the narrow scalar
// components and the wide sketch ones alike.
__global__ void reset_pane_kernel(ResetTab rt, int pane) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int j = 0; j < rt.n; ++j) {
    float* a = rt.p[j] + (int64_t)pane * rt.len[j];
    const float init = rt.init[j];
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < rt.len[j]; i += stride)
      a[i] = init;
  }
}

extern "C" {

// colmap: host int32 (ncols, 3) = (comp, k, spec). comp_ptrs / comp_k:
// host arrays of N_COMPS device pointers (null = absent) and widths.
// slots: device (R,) of uint16 if slot_u16, else int32. pane_vec: device
// uint8 (R,) per-row panes, or null for the scalar pane. touch: device
// uint32 (C,), or null for a state without a touch column.
int groupby_fold_scalar(const uint8_t* base, const float* V, const uint8_t* M,
                        const void* slots, int slot_u16, int R, int pane,
                        const uint8_t* pane_vec, int P, int C,
                        const int32_t* colmap, int ncols,
                        float* const* comp_ptrs, const int32_t* comp_k,
                        float* act, unsigned int* touch, void* stream) {
  ColMap cm;
  if (!make_colmap(colmap, ncols, &cm) || R < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const int threads = 256;
  const Comps cp = make_comps(comp_ptrs, comp_k);
  cudaStream_t st = (cudaStream_t)stream;
  with_slot_type(slots, slot_u16, [&](auto s) {
    fold_scalar_kernel<<<grid_for(R, threads), threads, 0, st>>>(
        base, V, M, s, R, pane, pane_vec, P, C, cm, cp, act, touch);
  });
  return (int)cudaGetLastError();
}

// The masked fold (#2). mask: device uint8 (R,), the row mask after WHERE;
// V / M: device (S, R); slots: device (R,) of uint16 if slot_u16, else
// int32; pane: the destination pane, inside [0, P). colmap, comp_ptrs,
// comp_k, touch: as groupby_fold_scalar.
int groupby_fold_masked_scalar(const uint8_t* mask, const float* V,
                               const uint8_t* M, const void* slots,
                               int slot_u16, int R, int pane, int P, int C,
                               const int32_t* colmap, int ncols,
                               float* const* comp_ptrs, const int32_t* comp_k,
                               float* act, unsigned int* touch,
                               void* stream) {
  ColMap cm;
  if (!make_colmap(colmap, ncols, &cm) || R < 0 || pane < 0 || pane >= P)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const int threads = 256;
  const Comps cp = make_comps(comp_ptrs, comp_k);
  cudaStream_t st = (cudaStream_t)stream;
  with_slot_type(slots, slot_u16, [&](auto s) {
    fold_masked_scalar_kernel<<<grid_for(R, threads), threads, 0, st>>>(
        mask, V, M, s, R, pane, P, C, cm, cp, act, touch);
  });
  return (int)cudaGetLastError();
}

// spectab: host int32 (nspecs, 2 + N_COMPS) = (kind, k_n, k_s1, k_s2,
// k_mn, k_mx, output row); pane_mask: device uint8 (P,); out: device
// float32 (rows, C), act in its last row.
int groupby_finalize_scalar(float* const* comp_ptrs, const int32_t* comp_k,
                            const float* act, const uint8_t* pane_mask, int P,
                            int C, const int32_t* spectab, int nspecs,
                            int rows, float* out, void* stream) {
  SpecTab st;
  if (!make_spectab(spectab, nspecs, rows, &st) || C < 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  const int threads = 256;
  finalize_scalar_kernel<<<grid_for(C, threads), threads, 0,
                           (cudaStream_t)stream>>>(
      make_comps(comp_ptrs, comp_k), act, pane_mask, P, C, st, rows, out);
  return (int)cudaGetLastError();
}

// ptrs / lens / inits: host arrays of n components (device pointer, floats
// in one pane, identity).
int groupby_reset_pane(float* const* ptrs, const long long* lens,
                       const float* inits, int n, int pane, void* stream) {
  ResetTab rt;
  const long long most = make_resettab(ptrs, lens, inits, n, &rt);
  if (most < 0) return (int)cudaErrorInvalidValue;
  if (most == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (most + threads - 1) / threads;
  reset_pane_kernel<<<blocks < 4096 ? (int)blocks : 4096, threads, 0,
                      (cudaStream_t)stream>>>(rt, pane);
  return (int)cudaGetLastError();
}

const char* groupby_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
