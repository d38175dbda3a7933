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
// The folds of #1 and #2 (the hll / hist / hh branches of
// DeviceGroupBy._fold_core, groupby.py:419-439, and of _fold_masked_impl,
// 353-354) are csrc/groupby.cu's groupby_fold, one kernel for act, the
// scalar and the sketch columns; the device code of its sketch roles is
// csrc/sketch_common.cuh's.
//
// groupby_finalize_wide replaces the hll and percentile_approx final
//                       values of _final_value (groupby.py:510-519) with
//                       sketches.hll_estimate / hist_quantile, and their
//                       pane merge (_merged: max for hll, sum for hist).
// groupby_hh_finalize   replaces _hh_finalize_impl (groupby.py:628-656)
//                       with sketches.hh_candidates (sketches.py:180-228).
//
// What bounds them on an H100 at the main path's sizes (65,536 rows,
// 16,384 slots): both finalizes read every live pane of their component
// once: 352 MB for the heavy-hitters hopping state (2 panes x 16,384 x
// 2,688 floats), 0.105 ms at 3.35 TB/s; so they are bytes-bound. The hll
// / percentile finalize is the rule group's (csrc/sketch_common.cuh
// finalize_wide_warps: a warp a slot, float4 loads, warp shuffles, a
// persistent grid); the heavy-hitters one runs a warp a slot on a
// persistent grid, its live panes' columns brought into shared memory by
// bulk copies ahead of their use, its ranks from ballots (below).
//
// The hashes, the hll register and rho, the histogram bin and the hll /
// percentile final values are csrc/sketch_common.cuh's,
// which the rule group's batched kernels (csrc/multirule.cu) share.

#include "bulk_copy.cuh"
#include "sketch_common.cuh"

struct HHSpecs {  // heavy_hitters specs: k in the hh component, 2·topk, row
  int n;
  int k[MAX_SPECS];
  int k2[MAX_SPECS];
  int row[MAX_SPECS];  // first of the 2·k2 rows (k2 codes, then k2 est)
};

// The wide finalize of one rule (csrc/sketch_common.cuh
// finalize_wide_warps, #16's body as a group of one rule with K = C):
// a warp a slot, on a persistent grid; the hll and percentile_approx
// final values into their rows of out (rows, C).
__global__ void __launch_bounds__(FIN_THREADS)
finalize_wide_kernel(Wide w, const uint8_t* __restrict__ pm, int P, int C,
                     WideSpecs ws, HistConsts hc, float hll_num,
                     float* __restrict__ out) {
  finalize_wide_warps(w, pm, P, C, C, 1, ws, hc, hll_num, 0, out);
}

// groupby_hh_finalize's kernel. One warp a block, on a persistent grid
// (as many blocks as the card holds at once); a warp walks its items
// (slot, spec) grid-stride. Per item:
//
// Loads. A slot's hh column (2,688 counters of one (pane, k), 10,752
// contiguous bytes, 16-byte aligned) comes into shared memory by one 1D
// bulk copy a live pane (csrc/bulk_copy.cuh), into a ring of HHF_BUFS
// column buffers a warp, each with its mbarrier. Lane 0 keeps the ring
// full: the next items' columns are in flight while this one is
// recovered. The pane mask is read once a launch into a list of the live
// panes; dead panes are never copied. With one live pane the item reads
// its buffer; with two it reads both; with more, the last buffer holds
// their running sum (the ring is one buffer shorter).
//
// Merge. The live panes are summed in increasing pane order from 0 with
// __fadd_rn, as the plain version's sum: the counts are whole numbers, so
// every sum is exact, and 0 + x first makes a -0.0 the +0.0 the plain
// sum gives.
//
// Recovery. Lane l owns cells l, l + 32, l + 64, l + 96 (cell t = depth
// t / 64, slot t % 64; 21 floats a cell, an odd stride: no bank
// conflicts): its code by bit majority (2·bit > total), valid where
// total > 0 and the code hashes back to the cell, its count-min estimate
// (min over depths of the total at the code's cell), 0 when invalid.
//
// Rank, in lax.top_k's order (estimate descending, the lower cell first
// among equals), without comparing every pair: a cell whose estimate is
// 0 ranks at (cells above 0) + (zero cells below it), from ballots; a
// cell with any other estimate (a valid code's count; negative only in a
// state no fold writes) walks the nonzero cells alone, one shuffle each
// (typically a handful, not 128), and a negative one also passes every
// zero cell. Ranks below k2 are written: codes to rows [row, row + k2),
// estimates to [row + k2, row + 2·k2). No block barrier anywhere.
#define HHF_BUFS 4                // column buffers a warp
#define HH_BYTES (HH_SIZE * 4)    // one (pane, slot, k) column: 10,752 B

// m = a + b float4-wise over one column (lane's float4s u = lane + 32·i);
// first: a is a pane's raw column, taken as 0 + a.
__device__ __forceinline__ void hh_merge(float* m, const float* a,
                                         const float* b, int lane,
                                         bool first) {
  float4* m4 = reinterpret_cast<float4*>(m);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  for (int u = lane; u < HH_SIZE / 4; u += 32) {
    float4 x = a4[u];
    const float4 y = b4[u];
    if (first)
      x = make_float4(__fadd_rn(0.0f, x.x), __fadd_rn(0.0f, x.y),
                      __fadd_rn(0.0f, x.z), __fadd_rn(0.0f, x.w));
    m4[u] = make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y),
                        __fadd_rn(x.z, y.z), __fadd_rn(x.w, y.w));
  }
}

// One item's recovery, rank and writes from its merged column 0 + a (+ b
// where TWO) in shared memory.
template <bool TWO>
__device__ __forceinline__ void hh_recover(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int lane, int c, int C, int k2,
                                           int row, float* __restrict__ out) {
  auto val = [&](int i) {
    const float m = __fadd_rn(0.0f, a[i]);
    if constexpr (TWO) return __fadd_rn(m, b[i]);
    else return m;
  };
  float est[4];
  uint32_t code[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = lane + 32 * q;
    const int base = t * HH_CELL;
    const float tot = val(base);
    uint32_t cd = 0;
#pragma unroll
    for (int bit = 0; bit < HH_BITS; ++bit)
      if (__fmul_rn(val(base + 1 + bit), 2.0f) > tot) cd |= 1u << bit;
    const bool ok = tot > 0.0f &&
                    hh_slot(cd, t / HH_WIDTH) == (uint32_t)(t % HH_WIDTH);
    float e = f32_inf();
#pragma unroll
    for (int d2 = 0; d2 < HH_DEPTH; ++d2)
      e = fminf(e, val((d2 * HH_WIDTH + (int)hh_slot(cd, d2)) * HH_CELL));
    est[q] = ok ? e : 0.0f;
    code[q] = cd;
  }
  uint32_t nz[4];
  int npos = 0, nzero = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    nz[q] = __ballot_sync(FULL_MASK, est[q] != 0.0f);
    npos += __popc(__ballot_sync(FULL_MASK, est[q] > 0.0f));
    nzero += 32 - __popc(nz[q]);
  }
  const uint32_t below = (1u << lane) - 1u;
  int rank[4];
  int zeros_before = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t z = ~nz[q];
    rank[q] = est[q] == 0.0f ? npos + zeros_before + __popc(z & below)
                             : (est[q] < 0.0f ? nzero : 0);
    zeros_before += __popc(z);
  }
#pragma unroll
  for (int q2 = 0; q2 < 4; ++q2) {
    uint32_t w = nz[q2];  // the same in every lane
    while (w) {
      const int bit = __ffs((int)w) - 1;
      w &= w - 1u;
      const float o = __shfl_sync(FULL_MASK, est[q2], bit);
      const int j = 32 * q2 + bit;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rank[q] += est[q] != 0.0f &&
                   ((o > est[q]) || (o == est[q] && j < 32 * q + lane));
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (rank[q] < k2) {
      out[(int64_t)(row + rank[q]) * C + c] = (float)code[q];
      out[(int64_t)(row + k2 + rank[q]) * C + c] = est[q];
    }
  }
}

__global__ void __launch_bounds__(32)
hh_finalize_kernel(const float* __restrict__ hh, int K,
                   const uint8_t* __restrict__ pm, int P, int C, HHSpecs hs,
                   float* __restrict__ out) {
  __shared__ __align__(128) float buf[HHF_BUFS][HH_SIZE];
  __shared__ __align__(8) uint64_t bar[HHF_BUFS];
  __shared__ short live[FIN_MAX_PANES];
  const int lane = (int)threadIdx.x;
  int L = 0;  // live panes, listed in increasing order
  for (int j = 0; 32 * j < P; ++j) {
    const int p = 32 * j + lane;
    const bool on = p < P && pm[p] != 0;
    const uint32_t bits = __ballot_sync(FULL_MASK, on);
    if (on) live[L + __popc(bits & ((1u << lane) - 1u))] = (short)p;
    L += __popc(bits);
  }
  if (lane == 0) {
    for (int i = 0; i < HHF_BUFS; ++i) bulk_bar_init(&bar[i]);
    bulk_bar_fence();
  }
  __syncwarp();
  const long long n_items = (long long)C * hs.n;
  const long long first = blockIdx.x, stride = gridDim.x;
  const long long mine =
      first < n_items ? (n_items - first + stride - 1) / stride : 0;
  if (L == 0) {  // nothing live: every cell 0, ranked by index
    for (long long i = 0; i < mine; ++i) {
      const long long it = first + i * stride;
      const int c = (int)(it / hs.n), s = (int)(it - (long long)c * hs.n);
      for (int r = lane; r < hs.k2[s]; r += 32) {
        out[(int64_t)(hs.row[s] + r) * C + c] = 0.0f;
        out[(int64_t)(hs.row[s] + hs.k2[s] + r) * C + c] = 0.0f;
      }
    }
    return;
  }
  // copy q = i·L + j is pane live[j] of the warp's item i, into buffer
  // q % ring, the (q / ring)-th use of its barrier
  const int ring = L >= 3 ? HHF_BUFS - 1 : HHF_BUFS;
  float* merged = buf[HHF_BUFS - 1];
  const long long copies = mine * L;
  auto issue = [&](long long q) {  // lane 0
    if (q >= copies) return;
    const long long i = q / L;
    const int j = (int)(q - i * L);
    const long long it = first + i * stride;
    const int c = (int)(it / hs.n), s = (int)(it - (long long)c * hs.n);
    const int st = (int)(q % ring);
    bulk_load(buf[st],
              hh + (((long long)live[j] * C + c) * K + hs.k[s]) * HH_SIZE,
              HH_BYTES, &bar[st]);
  };
  auto wait = [&](long long q) {
    bulk_wait(&bar[q % ring], (uint32_t)((q / ring) & 1));
  };
  if (lane == 0)
    for (int q = 0; q < ring; ++q) issue(q);
  for (long long i = 0; i < mine; ++i) {
    const long long it = first + i * stride;
    const int c = (int)(it / hs.n), s = (int)(it - (long long)c * hs.n);
    const long long q0 = i * L;
    wait(q0);
    const float* a = buf[q0 % ring];
    const float* b = nullptr;
    if (L == 2) {
      wait(q0 + 1);
      b = buf[(q0 + 1) % ring];
    } else if (L >= 3) {
      wait(q0 + 1);
      hh_merge(merged, a, buf[(q0 + 1) % ring], lane, true);
      __syncwarp();
      if (lane == 0) {
        bulk_reuse_fence();
        issue(q0 + ring);
        issue(q0 + 1 + ring);
      }
      for (int j = 2; j < L - 1; ++j) {
        wait(q0 + j);
        hh_merge(merged, merged, buf[(q0 + j) % ring], lane, false);
        __syncwarp();
        if (lane == 0) {
          bulk_reuse_fence();
          issue(q0 + j + ring);
        }
      }
      wait(q0 + L - 1);
      a = merged;
      b = buf[(q0 + L - 1) % ring];
    }
    if (b != nullptr)
      hh_recover<true>(a, b, lane, c, C, hs.k2[s], hs.row[s], out);
    else
      hh_recover<false>(a, b, lane, c, C, hs.k2[s], hs.row[s], out);
    __syncwarp();  // every read of the item's buffers done
    if (lane == 0) {
      bulk_reuse_fence();
      for (int j = L <= 2 ? 0 : L - 1; j < L; ++j) issue(q0 + j + ring);
    }
  }
}

// hh_finalize_kernel's persistent grid: as many one-warp blocks as the
// card holds at once (its shared memory allows five an SM), at most one
// an item.
static inline int hh_blocks(long long items) {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  int most = dev >= 0 && dev < 64 ? cached[dev] : 0;
  if (most == 0) {
    int sms = 0, per_sm = 0;
    const void* k = (const void*)hh_finalize_kernel;
    if (cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, 32, 0) !=
            cudaSuccess)
      return -1;
    most = sms * (per_sm > 0 ? per_sm : 1);
    if (dev >= 0 && dev < 64) cached[dev] = most;
  }
  return (int)(items < most ? (items > 0 ? items : 1) : most);
}

extern "C" {

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
  const Wide w = make_wide(wide_ptrs, wide_k);
  const cudaError_t bad = fin_check(w, ws, P, C);
  if (bad != cudaSuccess) return (int)bad;
  if (C == 0 || nspecs == 0) return (int)cudaSuccess;
  const int blocks = fin_blocks((const void*)finalize_wide_kernel, C);
  if (blocks < 0) return (int)cudaGetLastError();
  finalize_wide_kernel<<<blocks, FIN_THREADS, 0, (cudaStream_t)stream>>>(
      w, pane_mask, P, C, ws, make_hc(hist_consts), hll_num, out);
  return (int)cudaGetLastError();
}

// hh: device float32 (P, C, K, HH_SIZE), 16-byte aligned, P <=
// FIN_MAX_PANES; spectab: host int32 (nspecs, 3)
// = (k, k2, first output row); out: device float32 (rows, C).
int groupby_hh_finalize(const float* hh, int K, const uint8_t* pane_mask,
                        int P, int C, const int32_t* spectab, int nspecs,
                        float* out, void* stream) {
  if (nspecs > MAX_SPECS || C < 0 || K < 1 || P < 1 || P > FIN_MAX_PANES ||
      (reinterpret_cast<uintptr_t>(hh) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0 || nspecs == 0) return (int)cudaSuccess;
  HHSpecs hs;
  hs.n = nspecs;
  for (int s = 0; s < nspecs; ++s) {
    hs.k[s] = spectab[3 * s];
    hs.k2[s] = spectab[3 * s + 1];
    hs.row[s] = spectab[3 * s + 2];
    if (hs.k2[s] < 1 || hs.k2[s] > HH_CELLS) return (int)cudaErrorInvalidValue;
  }
  const int blocks = hh_blocks((long long)C * nspecs);
  if (blocks < 0) return (int)cudaGetLastError();
  hh_finalize_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>(
      hh, K, pane_mask, P, C, hs, out);
  return (int)cudaGetLastError();
}

const char* sketches_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
