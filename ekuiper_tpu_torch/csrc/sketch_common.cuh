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

// ------------------------------------------------------ the wide finalize
// Every (rule, key)'s hll and percentile_approx final values: #16 wide
// (multirule_finalize_wide, csrc/multirule.cu) and #3 wide
// (groupby_finalize_wide, csrc/sketches.cu, a group of one rule with
// K = C) both run finalize_wide_warps, so the two give the same bits.
//
// Bound on an H100: reading each live (rule, pane, key) register or bin
// run once (H5: 2.11 GB of hll registers over two panes, 4.23 GB of bins
// in one pane), so bytes. Design: a persistent grid (as many blocks of
// FIN_THREADS as the card holds at once) whose warps walk the (rule, key)
// items grid-stride, a warp an item, the specs one after another. Lane l
// holds float4 i = run[4·(l + 32·i) .. +3] of a key's run, so each of
// the warp's loads is 512 contiguous bytes: two a live pane for hll, eight
// for a histogram. The pane mask is read once a warp into ballot words
// (word j in lane j); dead panes are never loaded. The next item's first
// live pane is loaded before the current item's other panes and its
// arithmetic (a register double buffer), so loads stay in flight through
// the reductions, which are warp shuffles only: no shared memory, no
// barrier, one lane writes.
//
// The numbers: the pane merge is fmaxf from -inf (hll) or __fadd_rn from
// 0 (hist) over the live panes in order, as the plain version's amax /
// sum. A key's bin counts are integers below 2^24 and its 2^-r terms
// span fewer than 24 bits of exponent, so every sum below is exact and
// its order does not change a bit; the _rn intrinsics keep nvcc from
// contracting a·b + c into an FMA, so every other step rounds as the plain
// version's torch op does.
#define FIN_THREADS 256
#define FIN_MAX_PANES 1024  // 32 ballot words, one a lane
#ifndef FULL_MASK
#define FULL_MASK 0xffffffffu
#endif

// The live panes of pm as ballot words: word j (panes 32·j .. 32·j + 31)
// in lane j, 0 in the other lanes.
__device__ __forceinline__ uint32_t fin_pane_words(
    const uint8_t* __restrict__ pm, int P, int lane) {
  uint32_t mine = 0u;
  for (int j = 0; 32 * j < P; ++j) {
    const int p = 32 * j + lane;
    const uint32_t b = __ballot_sync(FULL_MASK, p < P && pm[p] != 0);
    if (lane == j) mine = b;
  }
  return mine;
}

// The first live pane after pane `after` (-1: the first), or -1.
__device__ __forceinline__ int fin_next_pane(uint32_t words, int P,
                                             int after) {
  for (int j = (after + 1) >> 5; 32 * j < P; ++j) {
    uint32_t m = __shfl_sync(FULL_MASK, words, j);
    const int seen = after + 1 - 32 * j;  // bits below it are done
    if (seen > 0) m &= ~0u << seen;
    if (m) return 32 * j + __ffs((int)m) - 1;
  }
  return -1;
}

template <int NV>
__device__ __forceinline__ void fin_load(const float* __restrict__ run,
                                         int lane, float4 (&v)[NV]) {
  const float4* r = reinterpret_cast<const float4*>(run) + lane;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = __ldcs(r + 32 * i);
}

// hll (NV 2): max; hist (NV 8): add
template <int NV>
__device__ __forceinline__ void fin_merge(float4 (&a)[NV],
                                          const float4 (&v)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if constexpr (NV == 2) {
      a[i] = make_float4(fmaxf(a[i].x, v[i].x), fmaxf(a[i].y, v[i].y),
                         fmaxf(a[i].z, v[i].z), fmaxf(a[i].w, v[i].w));
    } else {
      a[i] = make_float4(__fadd_rn(a[i].x, v[i].x), __fadd_rn(a[i].y, v[i].y),
                         __fadd_rn(a[i].z, v[i].z), __fadd_rn(a[i].w, v[i].w));
    }
  }
}

// sketches.hll_estimate of the merged registers (8 a lane), rounded half
// to even: the raw or the linear-counting estimate. Every lane gets it.
__device__ __forceinline__ float fin_hll_value(const float4 (&a)[2],
                                               float hll_num) {
  float z = 0.0f, zeros = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float r4[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float r = r4[q] < 0.0f ? 0.0f : r4[q];  // -inf: no live pane
      z = __fadd_rn(z, exp2f(-r));
      zeros = __fadd_rn(zeros, r == 0.0f ? 1.0f : 0.0f);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    z = __fadd_rn(z, __shfl_xor_sync(FULL_MASK, z, o));
    zeros = __fadd_rn(zeros, __shfl_xor_sync(FULL_MASK, zeros, o));
  }
  const float raw = __fdiv_rn(hll_num, z);
  const float small = __fmul_rn(
      (float)HLL_M, logf(__fdiv_rn((float)HLL_M, fmaxf(zeros, 1.0f))));
  return rintf((raw < 2.5f * HLL_M && zeros > 0.0f) ? small : raw);
}

// sketches.hist_quantile of the merged bins: lane l holds bins 128·j +
// 4·l .. +3 in h[j]. A scan across the lanes of each 128-bin chunk j's
// lane sums; the first chunk whose running total reaches
// target = max(frac·total, 1e-9), the first lane in it (a ballot), the
// first bin in that lane; its centre and sign, NaN for an empty
// histogram. Every lane gets it.
__device__ __forceinline__ float fin_pct_value(const float4 (&h)[8],
                                               int lane, float frac,
                                               const HistConsts& hc) {
  float a[8], inc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j] = __fadd_rn(__fadd_rn(h[j].x, h[j].y), __fadd_rn(h[j].z, h[j].w));
    inc[j] = a[j];
  }
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y = __shfl_up_sync(FULL_MASK, inc[j], o);
      if (lane >= o) inc[j] = __fadd_rn(inc[j], y);
    }
  }
  float before[9];
  before[0] = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    before[j + 1] = __fadd_rn(before[j], __shfl_sync(FULL_MASK, inc[j], 31));
  const float total = before[8];
  const float target = fmaxf(__fmul_rn(frac, total), 1e-9f);
  int J = -1;  // the same in every lane
  float b = 0.0f, cum = 0.0f, ex = 0.0f;
  float4 hj = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (J < 0 && before[j + 1] >= target) {
      J = j;
      b = before[j];
      cum = inc[j];
      ex = __fadd_rn(inc[j], -a[j]);
      hj = h[j];
    }
  }
  int idx = 0;  // argmax of all-False
  if (J >= 0) {
    const uint32_t hit =
        __ballot_sync(FULL_MASK, __fadd_rn(b, cum) >= target);
    const int L = __ffs((int)hit) - 1;
    const float c0 = __fadd_rn(__fadd_rn(b, ex), hj.x);
    const float c1 = __fadd_rn(c0, hj.y);
    const float c2 = __fadd_rn(c1, hj.z);
    const int first = c0 >= target ? 0 : (c1 >= target ? 1 : (c2 >= target ? 2 : 3));
    idx = 128 * J + 4 * L + __shfl_sync(FULL_MASK, first, L);
  }
  const int mag = idx > HIST_HALF ? idx - HIST_HALF - 1 : HIST_HALF - 1 - idx;
  const float center =
      __fmul_rn(expf(__fmul_rn((float)mag, hc.log_gamma)), hc.center_scale);
  const float val = idx == HIST_HALF ? 0.0f : (idx > HIST_HALF ? center : -center);
  return total > 0.0f ? val : f32_nan();
}

// One spec's sweep: the warp's items (rule, key) = (item / K, item % K)
// of component `comp` (NV 2: hll registers (.., K_hll, 256); NV 8: hist
// bins (.., K_hist, 1,024)), column k, into out[rule · out_rule + row · K
// + key].
template <int NV>
__device__ __forceinline__ void fin_sweep(
    const float* __restrict__ comp, long long rule_len, int kk, int k, int P,
    int C, int K, int n_items, uint32_t words, int p0, float frac,
    const HistConsts& hc, float hll_num, long long out_rule, int row,
    float* __restrict__ out) {
  constexpr int W = 128 * NV;
  const int lane = threadIdx.x & 31;
  const int n_warps = (int)((gridDim.x * blockDim.x) >> 5);
  auto run = [&](int item, int p) {
    const int rule = item / K;
    const int c = item - rule * K;
    return comp + rule * rule_len + (((long long)p * C + c) * kk + k) * W;
  };
  int item = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  float4 nxt[NV];
  if (p0 >= 0 && item < n_items) fin_load<NV>(run(item, p0), lane, nxt);
  for (; item < n_items; item += n_warps) {
    float4 acc[NV];
    const float id = NV == 2 ? -f32_inf() : 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = make_float4(id, id, id, id);
    if (p0 >= 0) {
      fin_merge<NV>(acc, nxt);
      if (item + n_warps < n_items)
        fin_load<NV>(run(item + n_warps, p0), lane, nxt);
      for (int p = fin_next_pane(words, P, p0); p >= 0;
           p = fin_next_pane(words, P, p)) {
        float4 v[NV];
        fin_load<NV>(run(item, p), lane, v);
        fin_merge<NV>(acc, v);
      }
    }
    float val;
    if constexpr (NV == 2)
      val = fin_hll_value(acc, hll_num);
    else
      val = fin_pct_value(acc, lane, frac, hc);
    if (lane == 0) {
      const int rule = item / K;
      out[rule * out_rule + (long long)row * K + (item - rule * K)] = val;
    }
  }
}

// The body of both wide finalize kernels: the hll and percentile_approx
// specs of ws for keys [0, K) of n_rules rules whose state lies rule
// after rule (P, C, K_c, W_c) in w, panes under the mask pm, into
// out[rule · out_rule + row · K + key]. Launched on a grid of
// fin_blocks() blocks of FIN_THREADS.
__device__ __forceinline__ void finalize_wide_warps(
    const Wide& w, const uint8_t* __restrict__ pm, int P, int C, int K,
    int n_rules, const WideSpecs& ws, const HistConsts& hc, float hll_num,
    long long out_rule, float* __restrict__ out) {
  const uint32_t words = fin_pane_words(pm, P, threadIdx.x & 31);
  const int p0 = fin_next_pane(words, P, -1);
  const int n_items = n_rules * K;
  for (int s = 0; s < ws.n; ++s) {
    if (ws.kind[s] == WK_HLL) {
      const int kk = w.k[W_HLL];
      fin_sweep<2>(w.p[W_HLL], (long long)P * C * kk * HLL_M, kk, ws.k[s],
                   P, C, K, n_items, words, p0, ws.frac[s], hc, hll_num,
                   out_rule, ws.row[s], out);
    } else {
      const int kk = w.k[W_HIST];
      fin_sweep<8>(w.p[W_HIST], (long long)P * C * kk * HIST_BINS, kk,
                   ws.k[s], P, C, K, n_items, words, p0, ws.frac[s], hc,
                   hll_num, out_rule, ws.row[s], out);
    }
  }
}

// The checks of the wide finalizes' entry points: P panes under the
// ballot words' limit, n_rules · K items in 32 bits, and each spec's
// component present and 16-byte aligned (its float4 loads).
static inline cudaError_t fin_check(const Wide& w, const WideSpecs& ws,
                                    int P, long long items) {
  if (P < 1 || P > FIN_MAX_PANES || items < 0 || items > (1LL << 30))
    return cudaErrorInvalidValue;
  for (int s = 0; s < ws.n; ++s) {
    const int comp = ws.kind[s] == WK_HLL ? W_HLL : W_HIST;
    if (ws.kind[s] != WK_HLL && ws.kind[s] != WK_PCT)
      return cudaErrorInvalidValue;
    if (w.p[comp] == nullptr) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(w.p[comp]) & 15u)
      return cudaErrorMisalignedAddress;
  }
  return cudaSuccess;
}

// Blocks of a persistent finalize grid of `kernel`: as many blocks of
// FIN_THREADS as the current card holds at once (from its SM count and
// the kernel's occupancy, cached a device), and no more than `items`
// warps need; -1 on an error of the runtime.
static inline int fin_blocks(const void* kernel, long long items) {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  int most = dev >= 0 && dev < 64 ? cached[dev] : 0;
  if (most == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      FIN_THREADS, 0) !=
            cudaSuccess)
      return -1;
    most = sms * (per_sm > 0 ? per_sm : 1);
    if (dev >= 0 && dev < 64) cached[dev] = most;
  }
  const long long need = (items * 32 + FIN_THREADS - 1) / FIN_THREADS;
  return (int)(need < most ? (need > 0 ? need : 1) : most);
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
