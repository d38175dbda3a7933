// Device functions and launch tables shared by the group-by kernels of
// csrc/groupby.cu (one rule) and csrc/multirule.cu (a rule group on a
// leading rule axis): the component and spec tables, the float atomic
// min/max, the pane merge and the per-slot final values. One copy, so the
// batched kernels round exactly as the single-rule ones do.
//
// State layout of one rule (the reference's, ekuiper_tpu/ops/groupby.py):
//   comp[c] : float32 (P, C, K_c)  for c in n, s1, s2, mn, mx (absent: null)
//   act     : float32 (P, C)
// with identities n = s1 = s2 = act = 0, mn = +inf, mx = -inf.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define N_COMPS 5  // n, s1, s2, mn, mx (ekuiper_tpu_torch/ops/kernels.py COMP_IDS)
#define MAX_COLS 64
#define MAX_SPECS 64

enum { C_N = 0, C_S1 = 1, C_S2 = 2, C_MN = 3, C_MX = 4 };
enum { K_COUNT = 0, K_SUM, K_AVG, K_MIN, K_MAX, K_STDDEV, K_STDDEVS, K_VAR,
       K_VARS };  // codes above K_VARS: sketch kinds, written by sketches.cu
#define MAX_RESET 16

struct Comps {
  float* p[N_COMPS];
  int k[N_COMPS];
};

struct ColMap {  // one entry per (component, k) column of the state
  int n;
  int comp[MAX_COLS];
  int k[MAX_COLS];
  int spec[MAX_COLS];
};

struct SpecTab {  // per spec: final-value kind, its column in each comp
  int n;            // and its output row
  int kind[MAX_SPECS];
  int kc[N_COMPS][MAX_SPECS];  // -1 where the spec has no such component
  int row[MAX_SPECS];
};

struct ResetTab {  // every component: its data, one pane's length, identity
  int n;
  float* p[MAX_RESET];
  long long len[MAX_RESET];
  float init[MAX_RESET];
};

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float f32_nan() { return __int_as_float(0x7fc00000); }
// max(x, 0) that keeps NaN, as jnp.maximum and torch.clamp do (fmaxf
// would return 0 for an inf - inf variance)
__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }

// Float atomic min/max by the sign split: non-negative floats order like
// their int bits, negative floats order reversed as unsigned bits. -0.0
// takes the negative branch (its bits are 0x80000000), the +/-inf
// identities are ordinary values of either branch, and NaN never reaches
// here (the fold masks NaN inputs out).
__device__ __forceinline__ void atomic_min_f32(float* a, float v) {
  if (__float_as_int(v) >= 0)
    atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* a, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}

// The scalar columns of one row, already past the row mask: for each state
// column whose spec mask M[spec, r] is set, an atomic add / min / max of
// V[spec, r] at flat (pane, slot) index pc. V and M are (S, n_rows).
__device__ __forceinline__ void fold_row_columns(const ColMap& cm,
                                                 const Comps& cp,
                                                 const float* __restrict__ V,
                                                 const uint8_t* __restrict__ M,
                                                 int n_rows, int r,
                                                 int64_t pc) {
  for (int j = 0; j < cm.n; ++j) {
    const int64_t at = (int64_t)cm.spec[j] * n_rows + r;
    if (!M[at]) continue;
    const int comp = cm.comp[j];
    float* dst = cp.p[comp] + pc * cp.k[comp] + cm.k[j];
    const float v = V[at];
    switch (comp) {
      case C_N: atomicAdd(dst, 1.0f); break;
      case C_S1: atomicAdd(dst, v); break;
      case C_S2: atomicAdd(dst, __fmul_rn(v, v)); break;
      case C_MN: atomic_min_f32(dst, v); break;
      default: atomic_max_f32(dst, v); break;
    }
  }
}

// One row of a single rule's scalar fold into pane p: act and every scalar
// column, for a row already past its row mask. A slot outside [0, C) or a
// pane outside [0, P) is dropped, as XLA drops an out-of-range scatter
// update. SlotT is the slot vector's type: uint16 while the key capacity
// is at most 65,535, int32 past it (the reference's slot_dtype); a cached
// sliding batch keeps the type it was uploaded with.
template <typename SlotT>
__device__ __forceinline__ void fold_scalar_row(const ColMap& cm,
                                                const Comps& cp,
                                                const float* __restrict__ V,
                                                const uint8_t* __restrict__ M,
                                                const SlotT* __restrict__ slots,
                                                int n_rows, int r, int p, int P,
                                                int C, float* __restrict__ act) {
  const int slot = (int)slots[r];
  if (slot < 0 || slot >= C || p < 0 || p >= P) return;
  const int64_t pc = (int64_t)p * C + slot;
  atomicAdd(act + pc, 1.0f);
  fold_row_columns(cm, cp, V, M, n_rows, r, pc);
}

// Pane merge of column k of one component for slot c under the pane mask.
__device__ __forceinline__ float merged(const Comps& cp, int comp, int k,
                                        const uint8_t* pm, int P, int C,
                                        int c) {
  const float* a = cp.p[comp];
  const int K = cp.k[comp];
  float m = comp == C_MN ? f32_inf() : (comp == C_MX ? -f32_inf() : 0.0f);
  for (int p = 0; p < P; ++p) {
    if (!pm[p]) continue;
    const float v = a[((int64_t)p * C + c) * K + k];
    if (comp == C_MN) m = fminf(m, v);
    else if (comp == C_MX) m = fmaxf(m, v);
    else m = __fadd_rn(m, v);
  }
  return m;
}

// Slot c of one rule: merge the masked panes, compute each scalar spec's
// final value with the reference's NaN-for-empty rules (_final_value) into
// out[row * stride + c], and the merged act into the last row (rows - 1).
// The _rn intrinsics keep nvcc from contracting a*b-c into an FMA, so the
// result rounds as the plain version (one torch op per step) does.
__device__ __forceinline__ void finalize_slot(const Comps& cp,
                                              const float* __restrict__ act,
                                              const uint8_t* __restrict__ pm,
                                              int P, int C,
                                              const SpecTab& st, int rows,
                                              int c, float* __restrict__ out,
                                              int64_t stride) {
  for (int s = 0; s < st.n; ++s) {
    const int kind = st.kind[s];
    if (kind > K_VARS) continue;
    const float n =
        st.kc[C_N][s] >= 0 ? merged(cp, C_N, st.kc[C_N][s], pm, P, C, c) : 0.f;
    float val;
    if (kind == K_COUNT) {
      val = n;
    } else if (kind == K_SUM || kind == K_AVG) {
      const float s1 = merged(cp, C_S1, st.kc[C_S1][s], pm, P, C, c);
      val = kind == K_SUM ? s1 : __fdiv_rn(s1, fmaxf(n, 1.0f));
      if (!(n > 0.f)) val = f32_nan();
    } else if (kind == K_MIN) {
      val = n > 0.f ? merged(cp, C_MN, st.kc[C_MN][s], pm, P, C, c) : f32_nan();
    } else if (kind == K_MAX) {
      val = n > 0.f ? merged(cp, C_MX, st.kc[C_MX][s], pm, P, C, c) : f32_nan();
    } else {
      const float s1 = merged(cp, C_S1, st.kc[C_S1][s], pm, P, C, c);
      const float s2 = merged(cp, C_S2, st.kc[C_S2][s], pm, P, C, c);
      const float mean = __fdiv_rn(s1, fmaxf(n, 1.0f));
      float v;
      if (kind == K_STDDEV || kind == K_VAR) {
        v = max0(__fsub_rn(__fdiv_rn(s2, fmaxf(n, 1.0f)), __fmul_rn(mean, mean)));
      } else {
        v = max0(__fdiv_rn(__fsub_rn(s2, __fmul_rn(s1, mean)),
                           fmaxf(__fsub_rn(n, 1.0f), 1.0f)));
      }
      if (kind == K_STDDEV || kind == K_STDDEVS) v = __fsqrt_rn(v);
      const bool ok = (kind == K_STDDEV || kind == K_VAR) ? n > 0.f : n >= 2.f;
      val = ok ? v : f32_nan();
    }
    out[(int64_t)st.row[s] * stride + c] = val;
  }
  float a = 0.0f;
  for (int p = 0; p < P; ++p)
    if (pm[p]) a = __fadd_rn(a, act[(int64_t)p * C + c]);
  out[(int64_t)(rows - 1) * stride + c] = a;
}

static inline int grid_for(long long n, int threads) {
  long long g = (n + threads - 1) / threads;
  if (g < 1) g = 1;
  if (g > 65535) g = 65535;
  return (int)g;
}

static inline Comps make_comps(float* const* comp_ptrs, const int32_t* comp_k) {
  Comps cp;
  for (int j = 0; j < N_COMPS; ++j) {
    cp.p[j] = comp_ptrs[j];
    cp.k[j] = comp_k[j];
  }
  return cp;
}

// colmap: host int32 (ncols, 3) = (comp, k, spec). False if it is too long.
static inline bool make_colmap(const int32_t* colmap, int ncols, ColMap* cm) {
  if (ncols < 0 || ncols > MAX_COLS) return false;
  cm->n = ncols;
  for (int j = 0; j < ncols; ++j) {
    cm->comp[j] = colmap[3 * j];
    cm->k[j] = colmap[3 * j + 1];
    cm->spec[j] = colmap[3 * j + 2];
  }
  return true;
}

// spectab: host int32 (nspecs, 2 + N_COMPS) = (kind, k_n, k_s1, k_s2, k_mn,
// k_mx, output row). False if it is too long or a scalar spec's row lies
// outside [0, rows - 1) (the last row is act's).
static inline bool make_spectab(const int32_t* spectab, int nspecs, int rows,
                                SpecTab* st) {
  if (nspecs < 0 || nspecs > MAX_SPECS || rows < 1) return false;
  st->n = nspecs;
  for (int s = 0; s < nspecs; ++s) {
    const int32_t* e = spectab + s * (2 + N_COMPS);
    st->kind[s] = e[0];
    for (int j = 0; j < N_COMPS; ++j) st->kc[j][s] = e[1 + j];
    st->row[s] = e[1 + N_COMPS];
    if (st->kind[s] <= K_VARS && (st->row[s] < 0 || st->row[s] >= rows - 1))
      return false;
  }
  return true;
}

// ptrs / lens / inits: host arrays of n components (device pointer, floats
// in one pane, identity). Returns the longest pane, or -1 if n is too large.
static inline long long make_resettab(float* const* ptrs, const long long* lens,
                                      const float* inits, int n, ResetTab* rt) {
  if (n > MAX_RESET || n < 0) return -1;
  rt->n = n;
  long long most = 0;
  for (int j = 0; j < n; ++j) {
    rt->p[j] = ptrs[j];
    rt->len[j] = lens[j];
    rt->init[j] = inits[j];
    if (lens[j] > most) most = lens[j];
  }
  return most;
}
