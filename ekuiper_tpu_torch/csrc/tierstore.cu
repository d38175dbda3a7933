// Kernels of the tiered key state, for Hopper (sm_90a).
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes), like
// csrc/groupby.cu. Every entry point launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// of its launches.
//
// State layout (the reference's, ekuiper_tpu/ops/groupby.py): each
// component is float32 (P, C, K[, W]), act is float32 (P, C), and the
// touch column is uint32 (C,). A packed row (ops/tierstore.py TierStore)
// holds one slot's per-pane partials: each component's (P, w) block
// flattened in C order, w = K (* W) floats per slot and pane, the
// components in sorted order, then act's (P,) block. The layout must equal
// the reference's column for column: the cold tier's rows cross both
// packages in checkpoints.
//
// tier_demote replaces TierStore._demote_impl
//   (ekuiper_tpu/ops/tierstore.py:263): gather D slots' rows into a fresh
//   (D, Wp) float32 block, then reset those slots of every component (and
//   their touch counters) to the fold identity. The reference reads the
//   old state for every gathered row before any reset, and its pad rows
//   repeat a real slot (slots[0]); so a reset must never race a pad's
//   gather. Design: two launches in order on one stream, a gather over all
//   D rows, then a reset over the n real rows only (a pad's slot is a real
//   row's, reset once). One thread per (row, packed column), neighbouring
//   threads on neighbouring columns, so each pane's run of w floats is one
//   coalesced read or write. Bound on an H100: reading D·Wp floats of
//   state, writing the block and n·Wp floats of state, a few KB to a few
//   MB (2,048 slots of a 10-pane scalar rule: 0.5 MB each way), well under
//   a microsecond of memory time, so launch-bound at these shapes.
//
// tier_promote replaces TierStore._promote_impl (tierstore.py:278): the
//   rows of a (D, Wp) block merged into their slots, add for n, s1, s2,
//   hist, hh and act, min for mn, max for mx and hll (the absorb's
//   algebra). Pad rows hold the combine identity and repeat slots[0], so
//   every (slot, element) gets one real contribution and identity ones:
//   the merge is an atomic add / min / max per element (the float atomic
//   min/max of csrc/groupby_common.cuh), whose result does not depend on
//   the order. Bound: reading the block and reading and writing D·Wp
//   floats of state.

#include "groupby_common.cuh"

#define MAX_TIER_COMPS 16  // ekuiper_tpu_torch/ops/kernels.py MAX_PARTS

enum { TOP_ADD = 0, TOP_MIN = 1, TOP_MAX = 2 };

struct TierTab {  // the packed row's blocks, in packed order (act last)
  int n;
  float* p[MAX_TIER_COMPS];       // (P, C, w) state
  long long w[MAX_TIER_COMPS];    // floats per slot and pane
  long long off[MAX_TIER_COMPS];  // first packed column of the block
  float init[MAX_TIER_COMPS];     // fold identity
  int op[MAX_TIER_COMPS];         // promote's merge
};

// The state element behind packed column j of a row on `slot`; *b is set
// to the column's block.
__device__ __forceinline__ float* tier_elem(const TierTab& t, long long j,
                                            int slot, int C, int* b) {
  int k = 0;
  while (k + 1 < t.n && j >= t.off[k + 1]) ++k;
  *b = k;
  const long long local = j - t.off[k];
  const long long p = local / t.w[k];
  const long long e = local - p * t.w[k];
  return t.p[k] + (p * C + slot) * t.w[k] + e;
}

// One thread per (row, column) of the block, grid-stride. A slot outside
// [0, C) gathers the identity (never reached: ops/tierstore.py checks).
__global__ void tier_gather_kernel(TierTab t, const int32_t* __restrict__ slots,
                                   long long total, long long Wp, int C,
                                   float* __restrict__ packed) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long d = i / Wp;
    const long long j = i - d * Wp;
    const int slot = slots[d];
    int b;
    if (slot < 0 || slot >= C) {
      tier_elem(t, j, 0, C, &b);
      packed[i] = t.init[b];
      continue;
    }
    packed[i] = *tier_elem(t, j, slot, C, &b);
  }
}

// The n real rows' slots back to the identity; their touch counters to 0.
__global__ void tier_reset_kernel(TierTab t, const int32_t* __restrict__ slots,
                                  long long total, long long Wp, int C,
                                  unsigned int* __restrict__ touch) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long d = i / Wp;
    const long long j = i - d * Wp;
    const int slot = slots[d];
    if (slot < 0 || slot >= C) continue;
    int b;
    float* dst = tier_elem(t, j, slot, C, &b);
    *dst = t.init[b];
    if (j == 0 && touch != nullptr) touch[slot] = 0u;
  }
}

// One thread per (row, column) of the block, pads included: an atomic
// add / min / max of the packed value into its state element.
__global__ void tier_promote_kernel(TierTab t, const int32_t* __restrict__ slots,
                                    long long total, long long Wp, int C,
                                    const float* __restrict__ packed) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long d = i / Wp;
    const long long j = i - d * Wp;
    const int slot = slots[d];
    if (slot < 0 || slot >= C) continue;
    int b;
    float* dst = tier_elem(t, j, slot, C, &b);
    const float v = packed[i];
    switch (t.op[b]) {
      case TOP_MIN: atomic_min_f32(dst, v); break;
      case TOP_MAX: atomic_max_f32(dst, v); break;
      default: atomicAdd(dst, v); break;
    }
  }
}

// ptrs / ws / inits / ops: host arrays of ncomps blocks in packed order
// (device pointer, floats per slot and pane, identity, merge). False if
// the table is too long or a width is not positive; *Wp is the row width.
static inline bool make_tiertab(float* const* ptrs, const long long* ws,
                                const float* inits, const int32_t* ops,
                                int ncomps, int P, TierTab* t,
                                long long* Wp) {
  if (ncomps < 1 || ncomps > MAX_TIER_COMPS || P < 1) return false;
  t->n = ncomps;
  long long col = 0;
  for (int k = 0; k < ncomps; ++k) {
    if (ws[k] < 1) return false;
    t->p[k] = ptrs[k];
    t->w[k] = ws[k];
    t->off[k] = col;
    t->init[k] = inits[k];
    t->op[k] = ops[k];
    col += (long long)P * ws[k];
  }
  *Wp = col;
  return true;
}

static inline int blocks_for(long long total, int threads) {
  const long long b = (total + threads - 1) / threads;
  return b < 1 ? 1 : (b > 65535 ? 65535 : (int)b);
}

extern "C" {

// slots: device int32 (D,), rows [n, D) repeating a real row's slot;
// packed: device float32 (D, Wp), written whole; touch: device uint32
// (C,) or null.
int tier_demote(float* const* ptrs, const long long* ws, const float* inits,
                const int32_t* ops, int ncomps, int P, int C,
                const int32_t* slots, int D, int n, float* packed,
                unsigned int* touch, void* stream) {
  TierTab t;
  long long Wp = 0;
  if (!make_tiertab(ptrs, ws, inits, ops, ncomps, P, &t, &Wp) || D < 0 ||
      n < 0 || n > D || C < 0)
    return (int)cudaErrorInvalidValue;
  if (D == 0) return (int)cudaSuccess;
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  const long long gathered = (long long)D * Wp;
  tier_gather_kernel<<<blocks_for(gathered, threads), threads, 0, st>>>(
      t, slots, gathered, Wp, C, packed);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;
  const long long reset = (long long)n * Wp;
  tier_reset_kernel<<<blocks_for(reset, threads), threads, 0, st>>>(
      t, slots, reset, Wp, C, touch);
  return (int)cudaGetLastError();
}

// packed: device float32 (D, Wp); slots: device int32 (D,).
int tier_promote(float* const* ptrs, const long long* ws, const float* inits,
                 const int32_t* ops, int ncomps, int P, int C,
                 const int32_t* slots, int D, const float* packed,
                 void* stream) {
  TierTab t;
  long long Wp = 0;
  if (!make_tiertab(ptrs, ws, inits, ops, ncomps, P, &t, &Wp) || D < 0 ||
      C < 0)
    return (int)cudaErrorInvalidValue;
  if (D == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long total = (long long)D * Wp;
  tier_promote_kernel<<<blocks_for(total, threads), threads, 0,
                        (cudaStream_t)stream>>>(t, slots, total, Wp, C,
                                                packed);
  return (int)cudaGetLastError();
}

}  // extern "C"
