// Device code of the sketch components shared by csrc/sketches.cu (one
// rule) and csrc/multirule.cu (a rule group on a leading rule axis): the
// hashes, the hll register and rho, the histogram bin, one row's wide
// fold, the block reductions and one slot's hll / percentile final value.
// One copy, so a register, a rho, a bin and a final value come out of the
// single-rule and the batched kernels with the same bits.
//
// State layout of one rule (the reference's, ekuiper_tpu/ops/groupby.py):
//   wide[c] : float32 (P, C, K_c, W_c) for c in hll (W 256), hist (W 1024),
//             hh (W 2688); identity 0 (absent component: null)
#pragma once

#include "groupby_common.cuh"

#define N_WIDE 3  // hll, hist, hh (ekuiper_tpu_torch/ops/kernels.py WIDE_IDS)

enum { W_HLL = 0, W_HIST = 1, W_HH = 2 };
enum { WK_HLL = 0, WK_PCT = 1 };  // final-value kinds of the wide finalizes

#define HLL_M 256
#define HIST_BINS 1024
#define HIST_HALF 511
#define HH_DEPTH 2
#define HH_WIDTH 64
#define HH_BITS 20
#define HH_CELL (1 + HH_BITS)
#define HH_CELLS (HH_DEPTH * HH_WIDTH)
#define HH_SIZE (HH_CELLS * HH_CELL)

__constant__ int kWideW[N_WIDE] = {HLL_M, HIST_BINS, HH_SIZE};

struct Wide {
  float* p[N_WIDE];
  int k[N_WIDE];
};

struct WideCols {  // one entry per (wide component, k) column of the state
  int n;
  int comp[MAX_COLS];
  int k[MAX_COLS];
  int spec[MAX_COLS];
};

// float32 constants of the log histogram, rounded on the host from the
// reference's float64 ones (ops/sketches.py), so both versions use the
// same bits. As XLA compiles the reference, a division by a constant is a
// multiply by its float32 reciprocal, and the bin centre's two constant
// factors are one (center_scale = lo · sqrt(gamma)).
struct HistConsts {
  float lo, hi, inv_lo, inv_log_gamma, log_gamma, center_scale;
};

struct WideSpecs {  // hll / percentile_approx specs: kind, k, output row
  int n;
  int kind[MAX_SPECS];
  int k[MAX_SPECS];
  int row[MAX_SPECS];
  float frac[MAX_SPECS];
};

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// sketches.hash_f32: salt s xors the bits with 0x9E3779B9·(s + 1)
__device__ __forceinline__ uint32_t hash_f32(float v, uint32_t salt_mul) {
  return splitmix32(__float_as_uint(v) ^ (0x9E3779B9u * salt_mul));
}

__device__ __forceinline__ uint32_t hh_slot(uint32_t code, int d) {
  return splitmix32(code ^ (0x9E3779B9u * (uint32_t)(d + 7))) & (HH_WIDTH - 1);
}

// sketches.hll_parts: the register of v's hll update, and its rho in
// *rho: 33 - (highest set bit of float32(max(h2, 1))), from the rounded
// float's exponent, 33 - (e - 126). rho is 0 only where h2 rounds up to
// 2^32: a max with the registers' identity, which changes nothing.
__device__ __forceinline__ int hll_reg_rho(float v, float* rho) {
  const uint32_t h1 = hash_f32(v, 1u);
  const uint32_t h2 = hash_f32(v, 2u);
  const float hv = __uint2float_rn(h2 > 1u ? h2 : 1u);
  *rho = (float)(159 - (int)((__float_as_uint(hv) >> 23) & 0xff));
  return (int)(h1 & (HLL_M - 1));
}

// sketches.hist_bin: the signed log-bin of v (v is not NaN here)
__device__ __forceinline__ int hist_bin(float v, const HistConsts& hc) {
  if (!(v > 0.0f) && !(v < 0.0f)) return HIST_HALF;
  const float c = fminf(fmaxf(fabsf(v), hc.lo), hc.hi);
  const float q = __fmul_rn(logf(__fmul_rn(c, hc.inv_lo)), hc.inv_log_gamma);
  int idx = (int)floorf(q);
  idx = idx < 0 ? 0 : (idx > HIST_HALF - 1 ? HIST_HALF - 1 : idx);
  return v > 0.0f ? HIST_HALF + 1 + idx : HIST_HALF - 1 - idx;
}

// The hll / hist columns of one row at flat (pane, slot) index pc: per
// column whose spec mask M[s] is set, the hll register max or the
// histogram bin add of V[s] (the hll encoding, or the value). A masked
// column writes nothing (the reference max-es 0 or adds 0 for it).
// Heavy-hitters columns are not folded here: fold_hh_cell below folds
// them.
__device__ __forceinline__ void fold_wide_columns(const float* __restrict__ V,
                                                  const uint8_t* __restrict__ M,
                                                  int R, int r, int64_t pc,
                                                  const WideCols& wc,
                                                  const Wide& w,
                                                  const HistConsts& hc) {
  for (int j = 0; j < wc.n; ++j) {
    const int64_t at = (int64_t)wc.spec[j] * R + r;
    if (!M[at]) continue;
    const int comp = wc.comp[j];
    const int W = kWideW[comp];
    float* dst = w.p[comp] + (pc * w.k[comp] + wc.k[j]) * W;
    const float v = V[at];
    if (comp == W_HLL) {
      float rho;
      const int reg = hll_reg_rho(v, &rho);
      if (rho > 0.0f) atomic_max_f32(dst + reg, rho);
    } else if (comp == W_HIST) {
      atomicAdd(dst + hist_bin(v, hc), 1.0f);
    }
  }
}

// One row of the wide fold into pane p (fold_wide_columns), dropping a
// slot outside [0, C) or a pane outside [0, P). SlotT: uint16 or int32, as
// the scalar fold's (csrc/groupby_common.cuh fold_scalar_row). The mesh
// (csrc/sharded.cu) refuses heavy_hitters at plan time.
template <typename SlotT>
__device__ __forceinline__ void fold_wide_row(const float* __restrict__ V,
                                              const uint8_t* __restrict__ M,
                                              const SlotT* __restrict__ slots,
                                              int R, int r, int p, int P,
                                              int C, const WideCols& wc,
                                              const Wide& w,
                                              const HistConsts& hc) {
  const int slot = (int)slots[r];
  if (slot < 0 || slot >= C || p < 0 || p >= P) return;
  fold_wide_columns(V, M, R, r, (int64_t)p * C + slot, wc, w, hc);
}

// The heavy-hitters update of one (row, depth) (sketches.hh_update_parts
// scattered by _fold_core, groupby.py:433-439): 1.0 added to the total
// (counter 0) and to counter 1 + b of each set bit b < HH_BITS of `code`,
// in the cell (d, hh_slot(code, d)) of column k of key block `key` (pane
// * C + slot) of the hh state (., C, K, HH_SIZE). Every add is +1.0 to a
// count below 2^24, so the counters come out bit-equal to the plain
// version's in any order of the adds.
//
// The cell's counters go in as float4 atomics (sm_90), one per aligned
// 4-float group holding a set counter, 0.0 in the group's other lanes (x +
// 0.0 keeps x's bits for the counters, never -0.0; a group past the cell's
// ends stays in the key block, whose 10,752 bytes are a multiple of 16).
// Needs the hh state 16-byte aligned. On an H100 at phase 2's shapes this
// took 0.0052 ms, against 0.0067 for a warp laying its rows' adds out 32
// at a time and 0.0155 for one thread per (row, depth, counter):
// PERF.md's findings.
__device__ __forceinline__ void fold_hh_cell(float* __restrict__ hh,
                                             long long key, int K, int k,
                                             int d, uint32_t code) {
  float* cell = hh + (key * K + k) * HH_SIZE +
                (d * HH_WIDTH + hh_slot(code, d)) * HH_CELL;
  // the cell starts a floats past a 16-byte boundary (the key block is
  // 10,752 bytes, a multiple of 16); counter c is bit a + c of the run of
  // 4-float groups from that boundary, at most 24 bits
  const int a = (int)((reinterpret_cast<uintptr_t>(cell) >> 2) & 3u);
  float4* g = reinterpret_cast<float4*>(cell - a);
  const uint32_t bits = (((code & ((1u << HH_BITS) - 1u)) << 1) | 1u) << a;
  for (int q = 0; q < 6; ++q) {
    const uint32_t m4 = (bits >> (4 * q)) & 0xfu;
    if (m4)
      atomicAdd(g + q, make_float4((float)(m4 & 1u), (float)((m4 >> 1) & 1u),
                                   (float)((m4 >> 2) & 1u),
                                   (float)(m4 >> 3)));
  }
}

// Block-wide sum over FIN_THREADS threads (8 warps); every thread gets it.
#define FIN_THREADS 256
__device__ __forceinline__ float block_sum(float x, float* sh) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  float t = 0.0f;
  for (int i = 0; i < FIN_THREADS / 32; ++i) t += sh[i];
  return t;
}

// Block-wide exclusive prefix sum of x (counts, exact in float32 below
// 2^24, so the order of the adds does not matter).
__device__ __forceinline__ float block_exclusive_scan(float x, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  __syncthreads();
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  float before = 0.0f;
  for (int i = 0; i < warp; ++i) before += sh[i];
  return before + inc - x;
}

__device__ __forceinline__ int block_min_int(int x, int* sh) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  int t = sh[0];
  for (int i = 1; i < FIN_THREADS / 32; ++i) t = min(t, sh[i]);
  return t;
}

// Slot c's hll and percentile_approx final values, by one block of
// FIN_THREADS threads, into out[row * stride + c] (thread 0 writes). hll:
// one register per thread, max-merged over the live panes (-inf where no
// pane is live, then clamped to 0), then Σ 2^-r and the zero count, then
// the raw or linear-counting estimate, rounded half to even. percentile:
// four adjacent bins per thread, sum-merged, an exclusive scan for the
// cumulative counts, the first bin whose count reaches
// max(frac·total, 1e-9), its centre and sign; NaN for an empty histogram.
// The _rn intrinsics keep nvcc from contracting a·b + c into an FMA, so
// every step rounds as the plain version's torch op does. shf / shi:
// FIN_THREADS / 32 floats and ints of shared memory.
__device__ __forceinline__ void finalize_wide_slot(
    const Wide& w, const uint8_t* __restrict__ pm, int P, int C,
    const WideSpecs& ws, const HistConsts& hc, float hll_num, int c,
    float* __restrict__ out, int64_t stride, float* shf, int* shi) {
  const int t = threadIdx.x;
  for (int s = 0; s < ws.n; ++s) {
    float val;
    if (ws.kind[s] == WK_HLL) {
      const int K = w.k[W_HLL];
      float r = -f32_inf();
      for (int p = 0; p < P; ++p)
        if (pm[p])
          r = fmaxf(r, w.p[W_HLL][(((int64_t)p * C + c) * K + ws.k[s]) *
                                      HLL_M + t]);
      r = r < 0.0f ? 0.0f : r;
      const float z = block_sum(exp2f(-r), shf);
      const float zeros = block_sum(r == 0.0f ? 1.0f : 0.0f, shf);
      const float raw = __fdiv_rn(hll_num, z);
      const float small =
          __fmul_rn((float)HLL_M,
                    logf(__fdiv_rn((float)HLL_M, fmaxf(zeros, 1.0f))));
      val = rintf((raw < 2.5f * HLL_M && zeros > 0.0f) ? small : raw);
    } else {
      const int K = w.k[W_HIST];
      float h[4];
      float local = 0.0f;
      for (int i = 0; i < 4; ++i) {
        float m = 0.0f;
        for (int p = 0; p < P; ++p)
          if (pm[p])
            m = __fadd_rn(m, w.p[W_HIST][(((int64_t)p * C + c) * K +
                                          ws.k[s]) * HIST_BINS + 4 * t + i]);
        h[i] = m;
        local += m;
      }
      float cum = block_exclusive_scan(local, shf);
      const float total = block_sum(local, shf);
      const float target = fmaxf(__fmul_rn(ws.frac[s], total), 1e-9f);
      int first = HIST_BINS;
      for (int i = 0; i < 4; ++i) {
        cum += h[i];
        if (cum >= target) {
          first = 4 * t + i;
          break;
        }
      }
      int idx = block_min_int(first, shi);
      if (idx == HIST_BINS) idx = 0;  // argmax of all-False
      const int mag = idx > HIST_HALF ? idx - HIST_HALF - 1 : HIST_HALF - 1 - idx;
      const float center =
          __fmul_rn(expf(__fmul_rn((float)mag, hc.log_gamma)), hc.center_scale);
      val = idx == HIST_HALF ? 0.0f : (idx > HIST_HALF ? center : -center);
      if (!(total > 0.0f)) val = f32_nan();
    }
    if (t == 0) out[(int64_t)ws.row[s] * stride + c] = val;
    __syncthreads();
  }
}

static inline Wide make_wide(float* const* ptrs, const int32_t* ks) {
  Wide w;
  for (int j = 0; j < N_WIDE; ++j) {
    w.p[j] = ptrs[j];
    w.k[j] = ks[j];
  }
  return w;
}

// colmap: host int32 (ncols, 3) = (wide comp, k, spec). False if it is
// too long.
static inline bool make_widecols(const int32_t* colmap, int ncols,
                                 WideCols* wc) {
  if (ncols < 0 || ncols > MAX_COLS) return false;
  wc->n = ncols;
  for (int j = 0; j < ncols; ++j) {
    wc->comp[j] = colmap[3 * j];
    wc->k[j] = colmap[3 * j + 1];
    wc->spec[j] = colmap[3 * j + 2];
  }
  return true;
}

// spectab: host int32 (nspecs, 3) = (kind WK_*, k, output row); fracs:
// host float32 (nspecs,). False if there are too many specs.
static inline bool make_widespecs(const int32_t* spectab, const float* fracs,
                                  int nspecs, WideSpecs* ws) {
  if (nspecs < 0 || nspecs > MAX_SPECS) return false;
  ws->n = nspecs;
  for (int s = 0; s < nspecs; ++s) {
    ws->kind[s] = spectab[3 * s];
    ws->k[s] = spectab[3 * s + 1];
    ws->row[s] = spectab[3 * s + 2];
    ws->frac[s] = fracs[s];
  }
  return true;
}

static inline HistConsts make_hc(const float* hist_consts) {
  HistConsts hc;
  hc.lo = hist_consts[0];
  hc.hi = hist_consts[1];
  hc.inv_lo = hist_consts[2];
  hc.inv_log_gamma = hist_consts[3];
  hc.log_gamma = hist_consts[4];
  hc.center_scale = hist_consts[5];
  return hc;
}
