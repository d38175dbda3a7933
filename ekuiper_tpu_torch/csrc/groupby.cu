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
//                        (ekuiper_tpu/ops/groupby.py:348-441)
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
// copy precedes a launch.

#include "groupby_common.cuh"

// One thread per row, grid-stride. `base` is the row mask after WHERE;
// M[s] is spec s's mask (base AND column validity AND not-NaN AND its
// FILTER), V[s] its float32 argument. A masked row writes nothing: the
// reference adds/mins/maxes the identity for it, which leaves the same
// state. A slot outside [0, C) is dropped, as XLA drops an out-of-range
// scatter update. The destination pane is `pane`, or pane_vec[r] when
// pane_vec is given (per-row panes: a sliding batch that crosses a bucket
// edge, the reference's uint8 pane vector); a pane outside [0, P) is
// dropped likewise.
__global__ void fold_scalar_kernel(const uint8_t* __restrict__ base,
                                   const float* __restrict__ V,
                                   const uint8_t* __restrict__ M,
                                   const int32_t* __restrict__ slots, int R,
                                   int pane, const uint8_t* __restrict__ pane_vec,
                                   int P, int C, ColMap cm, Comps cp,
                                   float* __restrict__ act) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R;
       r += gridDim.x * blockDim.x) {
    if (!base[r]) continue;
    const int slot = slots[r];
    if (slot < 0 || slot >= C) continue;
    const int p = pane_vec != nullptr ? (int)pane_vec[r] : pane;
    if (p >= P) continue;
    const int64_t pc = (int64_t)p * C + slot;
    atomicAdd(act + pc, 1.0f);
    fold_row_columns(cm, cp, V, M, R, r, pc);
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
// pane_vec: device uint8 (R,) per-row panes, or null for the scalar pane.
int groupby_fold_scalar(const uint8_t* base, const float* V, const uint8_t* M,
                        const int32_t* slots, int R, int pane,
                        const uint8_t* pane_vec, int P, int C,
                        const int32_t* colmap, int ncols,
                        float* const* comp_ptrs, const int32_t* comp_k,
                        float* act, void* stream) {
  ColMap cm;
  if (!make_colmap(colmap, ncols, &cm) || R < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const int threads = 256;
  fold_scalar_kernel<<<grid_for(R, threads), threads, 0,
                       (cudaStream_t)stream>>>(base, V, M, slots, R, pane,
                                               pane_vec, P, C, cm,
                                               make_comps(comp_ptrs, comp_k),
                                               act);
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
