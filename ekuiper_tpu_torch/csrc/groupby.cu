// Group-by kernels of the fused window aggregate, for Hopper (sm_90a).
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes). Every entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launch.
//
// State layout (the reference's, ekuiper_tpu/ops/groupby.py):
//   comp[c] : float32 (P, C, K_c)  for c in n, s1, s2, mn, mx (absent: null)
//   act     : float32 (P, C)
// with identities n = s1 = s2 = act = 0, mn = +inf, mx = -inf.
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
    for (int j = 0; j < cm.n; ++j) {
      const int64_t at = (int64_t)cm.spec[j] * R + r;
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

// One thread per slot: merge the masked panes, compute each scalar spec's
// final value with the reference's NaN-for-empty rules (_final_value) into
// its row of out (rows, C), and the merged act into the last row. The _rn
// intrinsics
// keep nvcc from contracting a*b-c into an FMA, so the result rounds as
// the plain version (one torch op per step) does.
__global__ void finalize_scalar_kernel(Comps cp, const float* __restrict__ act,
                                       const uint8_t* __restrict__ pm, int P,
                                       int C, SpecTab st, int rows,
                                       float* __restrict__ out) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C;
       c += gridDim.x * blockDim.x) {
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
      out[(int64_t)st.row[s] * C + c] = val;
    }
    float a = 0.0f;
    for (int p = 0; p < P; ++p)
      if (pm[p]) a = __fadd_rn(a, act[(int64_t)p * C + c]);
    out[(int64_t)(rows - 1) * C + c] = a;
  }
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

static int grid_for(int n, int threads) {
  int g = (n + threads - 1) / threads;
  if (g < 1) g = 1;
  if (g > 65535) g = 65535;
  return g;
}

static Comps make_comps(float* const* comp_ptrs, const int32_t* comp_k) {
  Comps cp;
  for (int j = 0; j < N_COMPS; ++j) {
    cp.p[j] = comp_ptrs[j];
    cp.k[j] = comp_k[j];
  }
  return cp;
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
  if (ncols > MAX_COLS || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  ColMap cm;
  cm.n = ncols;
  for (int j = 0; j < ncols; ++j) {
    cm.comp[j] = colmap[3 * j];
    cm.k[j] = colmap[3 * j + 1];
    cm.spec[j] = colmap[3 * j + 2];
  }
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
  if (nspecs > MAX_SPECS || C < 0 || rows < 1) return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  SpecTab st;
  st.n = nspecs;
  for (int s = 0; s < nspecs; ++s) {
    const int32_t* e = spectab + s * (2 + N_COMPS);
    st.kind[s] = e[0];
    for (int j = 0; j < N_COMPS; ++j) st.kc[j][s] = e[1 + j];
    st.row[s] = e[1 + N_COMPS];
    if (st.kind[s] <= K_VARS && (st.row[s] < 0 || st.row[s] >= rows - 1))
      return (int)cudaErrorInvalidValue;
  }
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
  if (n > MAX_RESET || n < 0) return (int)cudaErrorInvalidValue;
  ResetTab rt;
  rt.n = n;
  long long most = 0;
  for (int j = 0; j < n; ++j) {
    rt.p[j] = ptrs[j];
    rt.len[j] = lens[j];
    rt.init[j] = inits[j];
    if (lens[j] > most) most = lens[j];
  }
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
