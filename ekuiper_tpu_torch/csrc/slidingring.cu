// Kernels of the sliding-window DABA ring, for Hopper (sm_90a).
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes), like
// csrc/groupby.cu. Every entry point launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// of its launch. Every argument but the device pointers is passed by
// value (the ring order and validity included), so no host-to-device
// copy precedes a launch.
//
// Layout (the reference's, ekuiper_tpu/ops/slidingring.py): each pane
// state component is float32 (P, C, w) with w floats per slot (K, K*W for
// the wide sketches, 1 for act). The ring holds, per component,
//   tot   (C, w)      additive components (n, s1, s2, hist, hh, act)
//   back  (C, w)      two-stack components (mn: min; mx, hll: max)
//   front (R, C, w)   the two-stack components' suffix combines
// One pane (or ring slot) of a component is one contiguous run of C * w
// floats. Each launch takes a table of every component, as
// groupby_components does (csrc/prefinalize.cu).
//
// ring_advance replaces SlidingRing._advance_impl (slidingring.py:283):
//   tot = (tot + on·new) - on·old, in that order, rounded at each step;
//   back = min/max(back, closed_on ? new : identity).
// ring_flip replaces _flip_impl (slidingring.py:303): walks the R ring
//   slots in the age order `order`, last to first; additive components
//   get the masked sum into tot, two-stack components the reverse
//   cumulative min/max written to front[order[i]], then back reset to its
//   identity.
// ring_query replaces _query_impl (slidingring.py:332): the window body
//   into a fresh (C, Wout) array laid out as _components_layout (the
//   components side by side, act last): tot (if body_on) plus
//   adj_w[i]·pane[adj_slot[i]] for all QUERY_ADJ slots, zero weights
//   included, as the reference computes it (so a ±inf in a zero-weight
//   slot's pane gives NaN); for two-stack components front[f_idx] (if
//   body_on and f_on), back (if body_on) and the adj_mm-gated panes.
//
// What bounds them on an H100: bytes. The flip reads R panes of every
// component and writes tot / front once (3.49 GB for the percentile rule,
// 1.04 ms at 3.35 TB/s); the advance reads two panes and reads and writes
// the running partials (268 MB, 0.08 ms); the query reads the partials
// and up to four pane slices and writes the result (0.12 ms). Design: one
// thread per element of the components laid end to end (a narrow
// component does not leave the card idle while a wide one runs),
// neighbouring threads on neighbouring floats, so every pane read is one
// coalesced run; the flip walks the ring slots in a loop inside the
// thread, which keeps the suffix combine in a register. No shared memory,
// no atomics, no second pass.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PARTS 16  // ekuiper_tpu_torch/ops/kernels.py MAX_PARTS
#define MAX_RING 256  // n_ring_panes <= 254 (panes ship as uint8)
#define QUERY_ADJ 4   // ekuiper_tpu_torch/ops/slidingring.py QUERY_ADJ

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

struct RingParts {  // the components of one launch, in output order
  int n;
  const float* pane[MAX_PARTS];  // (P, C, w) pane state
  float* run[MAX_PARTS];         // tot (sums) or back (min / max), (C, w)
  float* front[MAX_PARTS];       // (R, C, w) suffix stack; null for sums
  int w[MAX_PARTS];              // floats per slot
  int col[MAX_PARTS];            // first output column (query only)
  long long start[MAX_PARTS];    // first element (advance and flip)
  int op[MAX_PARTS];
  float init[MAX_PARTS];         // the component's identity
};

struct RingOrder {  // the flip's age-ordered rotation of the ring slots
  int R;
  int order[MAX_RING];
  uint8_t valid[MAX_RING];
};

struct QueryArgs {
  int body_on, f_on, f_idx;
  int adj_slot[QUERY_ADJ];
  float adj_w[QUERY_ADJ];
  int adj_mm[QUERY_ADJ];
};

// NaN-keeping min/max, as jnp.minimum / torch.minimum (fminf would drop a
// NaN operand)
__device__ __forceinline__ float min_nan(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}
__device__ __forceinline__ float combine(int op, float a, float b) {
  return op == OP_MIN ? min_nan(a, b) : max_nan(a, b);
}

// The component holding element e of the components laid end to end.
__device__ __forceinline__ int part_of(const RingParts& rp, int64_t e) {
  int t = 0;
  while (t + 1 < rp.n && e >= rp.start[t + 1]) ++t;
  return t;
}

__global__ void ring_advance_kernel(RingParts rp, int C, int64_t total,
                                    int closed, int closed_on, int evict,
                                    int evict_on) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int t = part_of(rp, e);
    const int64_t i = e - rp.start[t];
    const int64_t len = (int64_t)C * rp.w[t];
    const float* pane = rp.pane[t];
    float* run = rp.run[t];
    const int op = rp.op[t];
    if (op == OP_SUM) {
      const float add = closed_on ? pane[closed * len + i] : 0.0f;
      const float sub = evict_on ? pane[evict * len + i] : 0.0f;
      run[i] = __fsub_rn(__fadd_rn(run[i], add), sub);
    } else {
      run[i] = combine(op, run[i], closed_on ? pane[closed * len + i]
                                             : rp.init[t]);
    }
  }
}

__global__ void ring_flip_kernel(RingParts rp, RingOrder ro, int C,
                                 int64_t total) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int t = part_of(rp, e);
    const int64_t i = e - rp.start[t];
    const int64_t len = (int64_t)C * rp.w[t];
    const float* pane = rp.pane[t];
    const int op = rp.op[t];
    if (op == OP_SUM) {
      float s = 0.0f;
      for (int k = ro.R - 1; k >= 0; --k)
        if (ro.valid[k]) s = __fadd_rn(s, pane[ro.order[k] * len + i]);
      rp.run[t][i] = s;
    } else {
      const float init = rp.init[t];
      float* front = rp.front[t];
      float acc = init;
      for (int k = ro.R - 1; k >= 0; --k) {
        const float g = ro.valid[k] ? pane[ro.order[k] * len + i] : init;
        acc = combine(op, acc, g);
        front[ro.order[k] * len + i] = acc;
      }
      rp.run[t][i] = init;
    }
  }
}

__global__ void ring_query_kernel(RingParts rp, QueryArgs qa, int C, int Wout,
                                  float* __restrict__ out) {
  const int64_t total = (int64_t)C * Wout;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(e / Wout);
    const int j = (int)(e - (int64_t)c * Wout);
    int t = 0;
    while (t + 1 < rp.n && j >= rp.col[t + 1]) ++t;
    const int w = rp.w[t];
    const int64_t len = (int64_t)C * w;
    const int64_t idx = (int64_t)c * w + (j - rp.col[t]);
    const float* pane = rp.pane[t];
    const int op = rp.op[t];
    float v;
    if (op == OP_SUM) {
      v = qa.body_on ? rp.run[t][idx] : 0.0f;
      for (int i = 0; i < QUERY_ADJ; ++i)
        v = __fadd_rn(v, __fmul_rn(qa.adj_w[i], pane[qa.adj_slot[i] * len + idx]));
    } else {
      const float init = rp.init[t];
      v = (qa.body_on && qa.f_on) ? rp.front[t][qa.f_idx * len + idx] : init;
      v = combine(op, v, qa.body_on ? rp.run[t][idx] : init);
      for (int i = 0; i < QUERY_ADJ; ++i)
        v = combine(op, v, qa.adj_mm[i] ? pane[qa.adj_slot[i] * len + idx] : init);
    }
    out[e] = v;
  }
}

static int blocks_for(int64_t n, int threads) {
  const int64_t b = (n + threads - 1) / threads;
  return b < 1 ? 1 : (b > 8192 ? 8192 : (int)b);
}

// Fill a RingParts from host arrays of n entries; returns the elements of
// all components (C * sum(w)) or -1 for a table the kernels cannot take.
static int64_t make_parts(RingParts* rp, const float* const* pane,
                          float* const* run, float* const* front,
                          const int32_t* w, const int32_t* ops,
                          const float* init, int n, int C) {
  if (n < 1 || n > MAX_PARTS || C < 0) return -1;
  rp->n = n;
  int64_t total = 0;
  int col = 0;
  for (int t = 0; t < n; ++t) {
    if (w[t] < 1 || ops[t] < OP_SUM || ops[t] > OP_MAX) return -1;
    if (ops[t] != OP_SUM && front != nullptr && front[t] == nullptr) return -1;
    rp->pane[t] = pane[t];
    rp->run[t] = run[t];
    rp->front[t] = front != nullptr ? front[t] : nullptr;
    rp->w[t] = w[t];
    rp->col[t] = col;
    rp->start[t] = total;
    rp->op[t] = ops[t];
    rp->init[t] = init[t];
    col += w[t];
    total += (int64_t)C * w[t];
  }
  return total;
}

extern "C" {

// pane / run: host arrays of n device pointers ((P, C, w) pane state; tot
// or back (C, w)); w, ops: host int32; init: host float32. closed / evict:
// pane indices, *_on: 0 or 1.
int ring_advance(const float* const* pane, float* const* run,
                 const int32_t* w, const int32_t* ops, const float* init,
                 int n, int C, int closed, int closed_on, int evict,
                 int evict_on, void* stream) {
  RingParts rp;
  const int64_t total = make_parts(&rp, pane, run, nullptr, w, ops, init, n, C);
  if (total < 0 || closed < 0 || evict < 0) return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  ring_advance_kernel<<<blocks_for(total, threads), threads, 0,
                        (cudaStream_t)stream>>>(rp, C, total, closed,
                                                closed_on != 0, evict,
                                                evict_on != 0);
  return (int)cudaGetLastError();
}

// front: host array of n device pointers to (R, C, w) stacks (null for the
// additive components); order: host int32 (R,), a permutation of the ring
// slots; valid: host uint8 (R,).
int ring_flip(const float* const* pane, float* const* run,
              float* const* front, const int32_t* w, const int32_t* ops,
              const float* init, int n, int C, const int32_t* order,
              const uint8_t* valid, int R, void* stream) {
  RingParts rp;
  const int64_t total = make_parts(&rp, pane, run, front, w, ops, init, n, C);
  if (total < 0 || R < 1 || R > MAX_RING) return (int)cudaErrorInvalidValue;
  RingOrder ro;
  ro.R = R;
  for (int k = 0; k < R; ++k) {
    if (order[k] < 0 || order[k] >= R) return (int)cudaErrorInvalidValue;
    ro.order[k] = order[k];
    ro.valid[k] = valid[k] != 0;
  }
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  ring_flip_kernel<<<blocks_for(total, threads), threads, 0,
                     (cudaStream_t)stream>>>(rp, ro, C, total);
  return (int)cudaGetLastError();
}

// front: as ring_flip; adj_slot / adj_w / adj_mm: host arrays of
// QUERY_ADJ; out: device float32 (C, sum(w)).
int ring_query(const float* const* pane, float* const* run,
               float* const* front, const int32_t* w, const int32_t* ops,
               const float* init, int n, int C, int body_on, int f_on,
               int f_idx, const int32_t* adj_slot, const float* adj_w,
               const uint8_t* adj_mm, float* out, void* stream) {
  RingParts rp;
  const int64_t total = make_parts(&rp, pane, run, front, w, ops, init, n, C);
  if (total < 0 || f_idx < 0) return (int)cudaErrorInvalidValue;
  QueryArgs qa;
  qa.body_on = body_on != 0;
  qa.f_on = f_on != 0;
  qa.f_idx = f_idx;
  for (int i = 0; i < QUERY_ADJ; ++i) {
    if (adj_slot[i] < 0) return (int)cudaErrorInvalidValue;
    qa.adj_slot[i] = adj_slot[i];
    qa.adj_w[i] = adj_w[i];
    qa.adj_mm[i] = adj_mm[i] != 0;
  }
  const int wout = rp.col[n - 1] + rp.w[n - 1];
  if (C == 0) return (int)cudaSuccess;
  const int threads = 256;
  ring_query_kernel<<<blocks_for((int64_t)C * wout, threads), threads, 0,
                      (cudaStream_t)stream>>>(rp, qa, C, wout, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
