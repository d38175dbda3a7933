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
//   likely limit. One thread per row, native float atomicAdd, and a
//   native integer atomicMax for the hll registers (rho >= 0, so the
//   float bits order as ints): no compare-and-swap loop.
// - both finalizes read every live pane of their component once: 352 MB
//   for the heavy-hitters hopping state (2 panes x 16,384 x 2,688 floats),
//   0.105 ms at 3.35 TB/s; so they are bytes-bound. One block per slot
//   reads the slot's contiguous registers coalesced; every per-slot step
//   after the merge (the register sums, the 1,024-bin scan, the 128-cell
//   bit recovery and top-k) runs in registers and shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define N_WIDE 3  // hll, hist, hh (ekuiper_tpu_torch/ops/kernels.py WIDE_IDS)
#define MAX_COLS 64
#define MAX_SPECS 64

enum { W_HLL = 0, W_HIST = 1, W_HH = 2 };
enum { WK_HLL = 0, WK_PCT = 1 };  // final-value kinds of finalize_wide

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

struct HHSpecs {  // heavy_hitters specs: k in the hh component, 2·topk, row
  int n;
  int k[MAX_SPECS];
  int k2[MAX_SPECS];
  int row[MAX_SPECS];  // first of the 2·k2 rows (k2 codes, then k2 est)
};

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float f32_nan() { return __int_as_float(0x7fc00000); }

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

// sketches.hist_bin: the signed log-bin of v (v is not NaN here)
__device__ __forceinline__ int hist_bin(float v, const HistConsts& hc) {
  if (!(v > 0.0f) && !(v < 0.0f)) return HIST_HALF;
  const float c = fminf(fmaxf(fabsf(v), hc.lo), hc.hi);
  const float q = __fmul_rn(logf(__fmul_rn(c, hc.inv_lo)), hc.inv_log_gamma);
  int idx = (int)floorf(q);
  idx = idx < 0 ? 0 : (idx > HIST_HALF - 1 ? HIST_HALF - 1 : idx);
  return v > 0.0f ? HIST_HALF + 1 + idx : HIST_HALF - 1 - idx;
}

// One thread per row, grid-stride. M[s] is spec s's mask (the row mask
// after WHERE AND column validity AND not-NaN AND its FILTER), V[s] its
// float32 argument: the hll encoding, the value, or the heavy-hitters
// dictionary code. A masked row writes nothing (the reference max-es 0 or
// adds 0 for it); a slot outside [0, C) is dropped. The pane is `pane`, or
// pane_vec[r] when pane_vec is given (per-row panes, as
// groupby_fold_scalar); a pane outside [0, P) is dropped.
__global__ void fold_wide_kernel(const float* __restrict__ V,
                                 const uint8_t* __restrict__ M,
                                 const int32_t* __restrict__ slots, int R,
                                 int pane, const uint8_t* __restrict__ pane_vec,
                                 int P, int C, WideCols wc, Wide w,
                                 HistConsts hc) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R;
       r += gridDim.x * blockDim.x) {
    const int slot = slots[r];
    if (slot < 0 || slot >= C) continue;
    const int p = pane_vec != nullptr ? (int)pane_vec[r] : pane;
    if (p >= P) continue;
    for (int j = 0; j < wc.n; ++j) {
      const int64_t at = (int64_t)wc.spec[j] * R + r;
      if (!M[at]) continue;
      const int comp = wc.comp[j];
      const int W = kWideW[comp];
      float* dst =
          w.p[comp] + (((int64_t)p * C + slot) * w.k[comp] + wc.k[j]) * W;
      const float v = V[at];
      if (comp == W_HLL) {
        const uint32_t h1 = hash_f32(v, 1u);
        const uint32_t h2 = hash_f32(v, 2u);
        // rho = 33 - (highest set bit of float32(max(h2, 1))), from the
        // rounded float's exponent: 33 - (e - 126)
        const float hv = __uint2float_rn(h2 > 1u ? h2 : 1u);
        const int rho = 159 - (int)((__float_as_uint(hv) >> 23) & 0xff);
        if (rho > 0)
          atomicMax(reinterpret_cast<int*>(dst + (h1 & (HLL_M - 1))),
                    __float_as_int((float)rho));
      } else if (comp == W_HIST) {
        atomicAdd(dst + hist_bin(v, hc), 1.0f);
      } else {
        const uint32_t code = (uint32_t)(long long)v;
        for (int d = 0; d < HH_DEPTH; ++d) {
          float* cell = dst + (d * HH_WIDTH + hh_slot(code, d)) * HH_CELL;
          atomicAdd(cell, 1.0f);
          for (int b = 0; b < HH_BITS; ++b)
            if ((code >> b) & 1u) atomicAdd(cell + 1 + b, 1.0f);
        }
      }
    }
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

// One block of 256 threads per slot (grid-stride over slots). hll: one
// register per thread, max-merged over the live panes (-inf where no pane
// is live, then clamped to 0), then Σ 2^-r and the zero count, then the
// raw or linear-counting estimate, rounded half to even. percentile: four
// adjacent bins per thread, sum-merged, an exclusive scan for the
// cumulative counts, the first bin whose count reaches
// max(frac·total, 1e-9), its centre and sign; NaN for an empty histogram.
// The _rn intrinsics keep nvcc from contracting a·b + c into an FMA, so
// every step rounds as the plain version's torch op does.
__global__ void __launch_bounds__(FIN_THREADS)
finalize_wide_kernel(Wide w, const uint8_t* __restrict__ pm, int P, int C,
                     WideSpecs ws, HistConsts hc, float hll_num,
                     float* __restrict__ out) {
  __shared__ float shf[FIN_THREADS / 32];
  __shared__ int shi[FIN_THREADS / 32];
  const int t = threadIdx.x;
  for (int c = blockIdx.x; c < C; c += gridDim.x) {
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
      if (t == 0) out[(int64_t)ws.row[s] * C + c] = val;
      __syncthreads();
    }
  }
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

static int grid_for(int n, int threads) {
  int g = (n + threads - 1) / threads;
  if (g < 1) g = 1;
  if (g > 65535) g = 65535;
  return g;
}

static Wide make_wide(float* const* ptrs, const int32_t* ks) {
  Wide w;
  for (int j = 0; j < N_WIDE; ++j) {
    w.p[j] = ptrs[j];
    w.k[j] = ks[j];
  }
  return w;
}

static HistConsts make_hc(const float* hist_consts) {
  HistConsts hc;
  hc.lo = hist_consts[0];
  hc.hi = hist_consts[1];
  hc.inv_lo = hist_consts[2];
  hc.inv_log_gamma = hist_consts[3];
  hc.log_gamma = hist_consts[4];
  hc.center_scale = hist_consts[5];
  return hc;
}

extern "C" {

// colmap: host int32 (ncols, 3) = (wide comp, k, spec). wide_ptrs /
// wide_k: host arrays of N_WIDE device pointers (null = absent) and K.
// hist_consts: host float32 (lo, hi, 1/lo, 1/log_gamma, log_gamma,
// center_scale). pane_vec: device uint8 (R,) per-row panes, or null.
int groupby_fold_wide(const float* V, const uint8_t* M, const int32_t* slots,
                      int R, int pane, const uint8_t* pane_vec, int P, int C,
                      const int32_t* colmap, int ncols,
                      float* const* wide_ptrs, const int32_t* wide_k,
                      const float* hist_consts, void* stream) {
  if (ncols > MAX_COLS || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || ncols == 0) return (int)cudaSuccess;
  WideCols wc;
  wc.n = ncols;
  for (int j = 0; j < ncols; ++j) {
    wc.comp[j] = colmap[3 * j];
    wc.k[j] = colmap[3 * j + 1];
    wc.spec[j] = colmap[3 * j + 2];
  }
  const int threads = 256;
  fold_wide_kernel<<<grid_for(R, threads), threads, 0, (cudaStream_t)stream>>>(
      V, M, slots, R, pane, pane_vec, P, C, wc, make_wide(wide_ptrs, wide_k),
      make_hc(hist_consts));
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
  if (nspecs > MAX_SPECS || C < 0) return (int)cudaErrorInvalidValue;
  if (C == 0 || nspecs == 0) return (int)cudaSuccess;
  WideSpecs ws;
  ws.n = nspecs;
  for (int s = 0; s < nspecs; ++s) {
    ws.kind[s] = spectab[3 * s];
    ws.k[s] = spectab[3 * s + 1];
    ws.row[s] = spectab[3 * s + 2];
    ws.frac[s] = fracs[s];
  }
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
