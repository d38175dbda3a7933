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
// groupby_fold           replaces DeviceGroupBy._fold_impl/_fold_core
//                        (ekuiper_tpu/ops/groupby.py:348-441) in ONE
//                        launch a chunk: act, the scalar columns, the touch
//                        column's bump (379-385), the per-row pane vector
//                        (334-338) and the hll / hist / hh branches
//                        (419-439); csrc/fold.cuh. It also replaces
//                        _fold_masked_impl (353-354), which is _fold_core
//                        under the refold's row mask: the sliding
//                        refold's cached segments, concatenated, go into
//                        its scratch pane in one launch a segment group
//                        (ekuiper_tpu_torch/ops/groupby.py
//                        fold_masked_many), base being their row masks
//                        after WHERE
// groupby_finalize_scalar replaces _finalize_impl/_finalize_dyn_impl ->
//                        _finalize_body/_merged/_final_value (444-520)
// groupby_reset_pane     replaces _reset_pane_impl (763), for every
//                        component: the scalar ones, act, and the wide
//                        sketch components of csrc/sketches.cu
//
// The sketch kernels (the wide finalize, heavy-hitter recovery) live in csrc/sketches.cu and fill other rows of the same
// finalize output: groupby_finalize_scalar writes each scalar spec's row
// and act, and skips the sketch kinds.
//
// What bounds them on an H100: each moves a few hundred KB to a few MB
// (rows in, the touched state lines, or one pane of state), which is
// well under a microsecond at 3.35 TB/s. At the main path's sizes
// (65,536 rows, 16,384 slots) each takes longer than that; how much of
// it is launch overhead and how much the body (for the folds, their
// atomics at L2) is what chip_smoke.py's body_ms / kernel_ms split
// reports. The fold is one launch a chunk (or a masked fold's segment
// group) for every mix of columns (csrc/fold.cuh); the other entry points
// are one launch each, with no scratch and no second pass. A masked
// fold reads the mask of every row of the padded batches, and the slot,
// values and spec masks only of the rows the mask keeps (an edge refold
// keeps a time cut of one bucket), whose atomics it issues.

#include <type_traits>

#include "fold.cuh"
#include "groupby_common.cuh"
#include "slot_type.cuh"

// The one-launch fold (#1): csrc/fold.cuh fold_body, by role.
template <typename SlotT>
__global__ void __launch_bounds__(FOLD_THREADS)
    groupby_fold_kernel(const __grid_constant__ FoldChunk a) {
  fold_body<SlotT>(a);
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

// The one-launch fold (#1) of R rows into pane `pane`, or each row into
// pane_vec[r] (device uint8 (R,), or null). base: device uint8 (R,), the
// row mask after WHERE; V / M: device (S, R); slots: device (R,) of uint16
// if slot_u16, else int32. colmap: host int32 (ncols, 3) = (comp, k,
// spec) of the scalar columns; widemap: host int32 (nwide, 3) = (WIDE_IDS
// comp, k, spec) of the hll / hist / hh columns. comp_ptrs / comp_k,
// wide_ptrs / wide_k: host arrays of N_COMPS and N_WIDE device pointers
// (null = absent) and widths. touch: device uint32 (C,), or null. hist_consts: host float32 (lo, hi, 1/lo, 1/log_gamma,
// log_gamma, center_scale). An hh state must be 16-byte aligned.
int groupby_fold(const uint8_t* base, const float* V, const uint8_t* M,
                 const void* slots, int slot_u16, int R, int pane,
                 const uint8_t* pane_vec, int P, int C,
                 const int32_t* colmap, int ncols, const int32_t* widemap,
                 int nwide, float* const* comp_ptrs, const int32_t* comp_k,
                 float* act, unsigned int* touch, float* const* wide_ptrs,
                 const int32_t* wide_k, const float* hist_consts,
                 void* stream) {
  FoldChunk a{};
  if (!fold_cols(colmap, ncols, widemap, nwide, comp_k[C_N], &a) || R < 0 ||
      P < 1 ||
      C < 0 || (long long)R * 2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool hh = a.hh.n > 0;
  if (hh && wide_ptrs[W_HH] == nullptr) return (int)cudaErrorInvalidValue;
  if (hh && (reinterpret_cast<uintptr_t>(wide_ptrs[W_HH]) & 15u))
    return (int)cudaErrorMisalignedAddress;
  if (R == 0) return (int)cudaSuccess;
  a.base = base;
  a.V = V;
  a.M = M;
  a.slots = slots;
  a.pane_vec = pane_vec;
  a.N = R;
  a.m = R;
  a.R_sh = 1;
  a.pane = pane;
  a.Pp = P;
  a.C = C;
  a.cp = make_comps(comp_ptrs, comp_k);
  a.act = act;
  a.touch = touch;
  a.w = make_wide(wide_ptrs, wide_k);
  a.hc = make_hc(hist_consts);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  with_slot_type(slots, slot_u16, [&](auto s) {
    using SlotT = std::remove_const_t<std::remove_pointer_t<decltype(s)>>;
    err = launch_fold(groupby_fold_kernel<SlotT>, a, st);
  });
  return (int)err;
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
