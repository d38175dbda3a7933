// Sketch kernels of the fused window aggregate, for Hopper (sm_90a): the
// wide state components hll (HyperLogLog registers), hist (signed
// log-histogram) and hh (heavy-hitters counters).
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes), beside
// csrc/groupby.cu. Every entry point launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// of its launch.
//
// State layout (the reference's, ekuiper_tpu/ops/groupby.py):
//   wide[c] : float32 (P, C, K_c, W_c) for c in hll (W 256), hist (W 1024),
//             hh (W 2688); identity 0 (absent component: null)
//
// groupby_fold_wide     replaces the hll/hist/hh branches of
//                       DeviceGroupBy._fold_core (groupby.py:419-439) with
//                       sketches.hll_parts / hist_bin / hh_update_parts.
//                       One launch per batch, after groupby_fold_scalar
//                       (which adds act and the scalar components).
// groupby_fold_masked_wide replaces the same branches of
//                       _fold_masked_impl (groupby.py:354): the wide fold
//                       under an explicit (mb,) row mask into one pane,
//                       after groupby_fold_masked_scalar (csrc/groupby.cu).
// groupby_finalize_wide replaces the hll and percentile_approx final
//                       values of _final_value (groupby.py:510-519) with
//                       sketches.hll_estimate / hist_quantile, and their
//                       pane merge (_merged: max for hll, sum for hist).
// groupby_hh_finalize   replaces _hh_finalize_impl (groupby.py:628-656)
//                       with sketches.hh_candidates (sketches.py:180-228).
//
// What bounds them on an H100 at the main path's sizes (65,536 rows,
// 16,384 slots):
// - the fold moves the rows in (~0.6 MB) and the touched register lines;
//   each row issues 1 atomic (hll, hist) or 2·(1 + popcount(code)), at
//   most 42, atomics (hh), so atomics at L2 rather than bytes are its
//   likely limit. One thread per row, native float atomicAdd, and for
//   the hll registers the float atomic max of csrc/groupby_common.cuh,
//   a native integer atomicMax here (rho >= 0, so the float bits order
//   as ints): no compare-and-swap loop.
// - both finalizes read every live pane of their component once: 352 MB
//   for the heavy-hitters hopping state (2 panes x 16,384 x 2,688 floats),
//   0.105 ms at 3.35 TB/s; so they are bytes-bound. One block per slot
//   reads the slot's contiguous registers coalesced; every per-slot step
//   after the merge (the register sums, the 1,024-bin scan, the 128-cell
//   bit recovery and top-k) runs in registers and shared memory.
//
// The hashes, the hll register and rho, the histogram bin, the row fold
// and the hll / percentile final values are csrc/sketch_common.cuh's,
// which the rule group's batched kernels (csrc/multirule.cu) share.

#include "sketch_common.cuh"
#include "slot_type.cuh"

struct HHSpecs {  // heavy_hitters specs: k in the hh component, 2·topk, row
  int n;
  int k[MAX_SPECS];
  int k2[MAX_SPECS];
  int row[MAX_SPECS];  // first of the 2·k2 rows (k2 codes, then k2 est)
};

// One thread per row, grid-stride. M[s] is spec s's mask (the row mask
// after WHERE AND column validity AND not-NaN AND its FILTER). The pane is
// `pane`, or pane_vec[r] when pane_vec is given (per-row panes, as
// groupby_fold_scalar).
template <typename SlotT>
__global__ void fold_wide_kernel(const float* __restrict__ V,
                                 const uint8_t* __restrict__ M,
                                 const SlotT* __restrict__ slots, int R,
                                 int pane, const uint8_t* __restrict__ pane_vec,
                                 int P, int C, WideCols wc, Wide w,
                                 HistConsts hc) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R;
       r += gridDim.x * blockDim.x) {
    const int p = pane_vec != nullptr ? (int)pane_vec[r] : pane;
    fold_wide_row(V, M, slots, R, r, p, P, C, wc, w, hc);
  }
}

// The masked wide fold (#2): one thread per row of a cached, padded batch,
// grid-stride, into the one pane `pane`. mask[r] is the refold's row mask
// after WHERE (0 on padding rows), M[s] already ANDed with it; a row with
// mask 0 is skipped before its spec masks are read.
template <typename SlotT>
__global__ void fold_masked_wide_kernel(const uint8_t* __restrict__ mask,
                                        const float* __restrict__ V,
                                        const uint8_t* __restrict__ M,
                                        const SlotT* __restrict__ slots, int R,
                                        int pane, int P, int C, WideCols wc,
                                        Wide w, HistConsts hc) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R;
       r += gridDim.x * blockDim.x) {
    if (!mask[r]) continue;
    fold_wide_row(V, M, slots, R, r, pane, P, C, wc, w, hc);
  }
}

// One block of FIN_THREADS threads per slot (grid-stride): the slot's
// hll and percentile_approx final values (csrc/sketch_common.cuh
// finalize_wide_slot) into their rows of out (rows, C).
__global__ void __launch_bounds__(FIN_THREADS)
finalize_wide_kernel(Wide w, const uint8_t* __restrict__ pm, int P, int C,
                     WideSpecs ws, HistConsts hc, float hll_num,
                     float* __restrict__ out) {
  __shared__ float shf[FIN_THREADS / 32];
  __shared__ int shi[FIN_THREADS / 32];
  for (int c = blockIdx.x; c < C; c += gridDim.x)
    finalize_wide_slot(w, pm, P, C, ws, hc, hll_num, c, out, C, shf, shi);
}

// One block of 128 threads per slot (grid-stride), one thread per
// (depth, slot) cell of the sketch. The block sum-merges the slot's live
// panes into shared memory (2,688 counters, 10.5 KB), then each thread
// recovers its cell's code by bit majority (2·bit > total), validates it
// (total > 0 and the code hashes back to this cell), estimates it by
// count-min (min over depths of the total at the code's cell; 0 when
// invalid) and ranks it against the other 127 in lax.top_k's order:
// estimate descending, the lower cell index first among equal estimates.
// The first k2 ranks are written: codes to rows [row, row + k2), estimates
// to [row + k2, row + 2·k2).
#define HH_THREADS HH_CELLS
__global__ void __launch_bounds__(HH_THREADS)
hh_finalize_kernel(const float* __restrict__ hh, int K,
                   const uint8_t* __restrict__ pm, int P, int C, HHSpecs hs,
                   float* __restrict__ out) {
  __shared__ float sh[HH_SIZE];
  __shared__ float est[HH_CELLS];
  const int t = threadIdx.x;
  for (int c = blockIdx.x; c < C; c += gridDim.x) {
    for (int s = 0; s < hs.n; ++s) {
      for (int i = t; i < HH_SIZE; i += HH_THREADS) {
        float m = 0.0f;
        for (int p = 0; p < P; ++p)
          if (pm[p])
            m = __fadd_rn(m, hh[(((int64_t)p * C + c) * K + hs.k[s]) * HH_SIZE + i]);
        sh[i] = m;
      }
      __syncthreads();
      const int d = t / HH_WIDTH, wslot = t % HH_WIDTH;
      const float tot = sh[t * HH_CELL];
      uint32_t code = 0;
      for (int b = 0; b < HH_BITS; ++b)
        if (__fmul_rn(sh[t * HH_CELL + 1 + b], 2.0f) > tot) code |= 1u << b;
      const bool ok = tot > 0.0f && hh_slot(code, d) == (uint32_t)wslot;
      float e = f32_inf();
      for (int d2 = 0; d2 < HH_DEPTH; ++d2)
        e = fminf(e, sh[(d2 * HH_WIDTH + hh_slot(code, d2)) * HH_CELL]);
      const float mine = ok ? e : 0.0f;
      est[t] = mine;
      __syncthreads();
      int rank = 0;
      for (int j = 0; j < HH_CELLS; ++j) {
        const float o = est[j];
        rank += (o > mine) || (o == mine && j < t);
      }
      const int k2 = hs.k2[s];
      if (rank < k2) {
        out[(int64_t)(hs.row[s] + rank) * C + c] = (float)code;
        out[(int64_t)(hs.row[s] + k2 + rank) * C + c] = mine;
      }
      __syncthreads();
    }
  }
}

extern "C" {

// colmap: host int32 (ncols, 3) = (wide comp, k, spec). wide_ptrs /
// wide_k: host arrays of N_WIDE device pointers (null = absent) and K.
// hist_consts: host float32 (lo, hi, 1/lo, 1/log_gamma, log_gamma,
// center_scale). slots: device (R,) of uint16 if slot_u16, else int32.
// pane_vec: device uint8 (R,) per-row panes, or null.
int groupby_fold_wide(const float* V, const uint8_t* M, const void* slots,
                      int slot_u16, int R, int pane, const uint8_t* pane_vec,
                      int P, int C, const int32_t* colmap, int ncols,
                      float* const* wide_ptrs, const int32_t* wide_k,
                      const float* hist_consts, void* stream) {
  WideCols wc;
  if (!make_widecols(colmap, ncols, &wc) || R < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || ncols == 0) return (int)cudaSuccess;
  const int threads = 256;
  const Wide w = make_wide(wide_ptrs, wide_k);
  const HistConsts hc = make_hc(hist_consts);
  cudaStream_t st = (cudaStream_t)stream;
  with_slot_type(slots, slot_u16, [&](auto s) {
    fold_wide_kernel<<<grid_for(R, threads), threads, 0, st>>>(
        V, M, s, R, pane, pane_vec, P, C, wc, w, hc);
  });
  return (int)cudaGetLastError();
}

// The masked wide fold (#2). mask: device uint8 (R,), the row mask after
// WHERE; pane: the destination pane, inside [0, P); the rest as
// groupby_fold_wide.
int groupby_fold_masked_wide(const uint8_t* mask, const float* V,
                             const uint8_t* M, const void* slots, int slot_u16,
                             int R, int pane, int P, int C,
                             const int32_t* colmap, int ncols,
                             float* const* wide_ptrs, const int32_t* wide_k,
                             const float* hist_consts, void* stream) {
  WideCols wc;
  if (!make_widecols(colmap, ncols, &wc) || R < 0 || pane < 0 || pane >= P)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || ncols == 0) return (int)cudaSuccess;
  const int threads = 256;
  const Wide w = make_wide(wide_ptrs, wide_k);
  const HistConsts hc = make_hc(hist_consts);
  cudaStream_t st = (cudaStream_t)stream;
  with_slot_type(slots, slot_u16, [&](auto s) {
    fold_masked_wide_kernel<<<grid_for(R, threads), threads, 0, st>>>(
        mask, V, M, s, R, pane, P, C, wc, w, hc);
  });
  return (int)cudaGetLastError();
}

// spectab: host int32 (nspecs, 3) = (kind WK_*, k, output row); fracs:
// host float32 (nspecs,); hll_num: float32(alpha·m·m); out: device
// float32 (rows, C), of which this kernel writes the specs' rows.
int groupby_finalize_wide(float* const* wide_ptrs, const int32_t* wide_k,
                          const uint8_t* pane_mask, int P, int C,
                          const int32_t* spectab, const float* fracs,
                          int nspecs, const float* hist_consts, float hll_num,
                          float* out, void* stream) {
  WideSpecs ws;
  if (!make_widespecs(spectab, fracs, nspecs, &ws) || C < 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0 || nspecs == 0) return (int)cudaSuccess;
  finalize_wide_kernel<<<C < 65535 ? C : 65535, FIN_THREADS, 0,
                         (cudaStream_t)stream>>>(
      make_wide(wide_ptrs, wide_k), pane_mask, P, C, ws, make_hc(hist_consts),
      hll_num, out);
  return (int)cudaGetLastError();
}

// hh: device float32 (P, C, K, HH_SIZE); spectab: host int32 (nspecs, 3)
// = (k, k2, first output row); out: device float32 (rows, C).
int groupby_hh_finalize(const float* hh, int K, const uint8_t* pane_mask,
                        int P, int C, const int32_t* spectab, int nspecs,
                        float* out, void* stream) {
  if (nspecs > MAX_SPECS || C < 0) return (int)cudaErrorInvalidValue;
  if (C == 0 || nspecs == 0) return (int)cudaSuccess;
  HHSpecs hs;
  hs.n = nspecs;
  for (int s = 0; s < nspecs; ++s) {
    hs.k[s] = spectab[3 * s];
    hs.k2[s] = spectab[3 * s + 1];
    hs.row[s] = spectab[3 * s + 2];
    if (hs.k2[s] < 1 || hs.k2[s] > HH_CELLS) return (int)cudaErrorInvalidValue;
  }
  hh_finalize_kernel<<<C < 65535 ? C : 65535, HH_THREADS, 0,
                       (cudaStream_t)stream>>>(hh, K, pane_mask, P, C, hs, out);
  return (int)cudaGetLastError();
}

const char* sketches_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
