// Kernels of the latency-hiding window emit, for Hopper (sm_90a).
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes), like
// csrc/groupby.cu. Every entry point launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// of its launch.
//
// State layout (the reference's, ekuiper_tpu/ops/groupby.py): each
// component is float32 (P, C, K[, W]), act is float32 (P, C); one pane of
// a component is one contiguous run of C * w floats, w = K (* W).
//
// groupby_components replaces DeviceGroupBy._components_impl and
//   _components_dyn_impl (ekuiper_tpu/ops/groupby.py:541, 549, body 566):
//   the panes selected by a (P,) mask merged into one fresh (C, Wout)
//   float32 array, the components side by side in _components_layout's
//   order (sorted names, then act), each flattened to its w columns. The
//   merge is the reference's _merged (groupby.py:444-453): min over the
//   masked panes from +inf for mn, max from -inf for mx and hll (an empty
//   mask gives -inf), a sum from 0 for everything else. The mask is a
//   device tensor, so one kernel serves the full and every subset mask.
//   Bound on an H100: reading the live panes once and writing the result
//   once; the percentile rule moves 67 MB each way (0.040 ms at
//   3.35 TB/s), the flagship rule a few hundred KB (launch-bound). Design:
//   one thread per output element, neighbouring threads on neighbouring
//   columns of one slot, so each pane's read of a component is one
//   coalesced run; the thread loops over the P <= 255 panes.
//
// groupby_absorb replaces DeviceGroupBy._absorb_impl (groupby.py:729):
//   host-shadow partials, already on the card, merged into one pane of the
//   state in place, min for mn, max for mx and hll, add otherwise; a
//   component the shadow lacks is left alone. The shadow covers the first
//   Cs <= C slots, and its (Cs, w) rows line up with the pane's first
//   Cs * w floats. Bound: reading the shadow and reading and writing those
//   floats of the pane once. Design: one launch over every component, each
//   a grid-stride run.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PARTS 16  // ekuiper_tpu_torch/ops/kernels.py MAX_PARTS

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

struct Parts {  // the components of one launch, in output order
  int n;
  const float* src[MAX_PARTS];  // (P, C, w) state, or (Cs, w) shadow
  float* dst[MAX_PARTS];        // (P, C, w) state (absorb only)
  int w[MAX_PARTS];             // floats per slot
  int col[MAX_PARTS];           // first output column (components only)
  int op[MAX_PARTS];
};

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

// NaN-keeping min/max, as torch.minimum / jnp.minimum (fminf would drop a
// NaN operand)
__device__ __forceinline__ float min_nan(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float merge(int op, float acc, float v) {
  if (op == OP_MIN) return min_nan(acc, v);
  if (op == OP_MAX) return max_nan(acc, v);
  return acc + v;
}

__global__ void components_kernel(Parts pt, const uint8_t* __restrict__ mask,
                                  int P, int C, int Wout,
                                  float* __restrict__ out) {
  const int64_t total = (int64_t)C * Wout;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(e / Wout);
    const int j = (int)(e - (int64_t)c * Wout);
    int t = 0;
    while (t + 1 < pt.n && j >= pt.col[t + 1]) ++t;
    const int w = pt.w[t];
    const int op = pt.op[t];
    const float* src = pt.src[t] + (int64_t)c * w + (j - pt.col[t]);
    const int64_t pane_stride = (int64_t)C * w;
    float acc = op == OP_MIN ? f32_inf() : (op == OP_MAX ? -f32_inf() : 0.0f);
    for (int p = 0; p < P; ++p)
      if (__ldg(mask + p)) acc = merge(op, acc, __ldg(src + p * pane_stride));
    out[e] = acc;
  }
}

__global__ void absorb_kernel(Parts pt, int pane, int C, int Cs) {
  for (int t = 0; t < pt.n; ++t) {
    const int64_t len = (int64_t)Cs * pt.w[t];
    float* dst = pt.dst[t] + (int64_t)pane * C * pt.w[t];
    const float* src = pt.src[t];
    const int op = pt.op[t];
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < len;
         i += (int64_t)gridDim.x * blockDim.x)
      dst[i] = merge(op, dst[i], src[i]);
  }
}

static int blocks_for(int64_t n, int threads) {
  const int64_t b = (n + threads - 1) / threads;
  return b < 1 ? 1 : (b > 8192 ? 8192 : (int)b);
}

extern "C" {

// src: host array of n device pointers to (P, C, w[t]) state; w, ops: host
// int32 arrays; mask: device uint8 (P,); out: device float32 (C, sum(w)).
int groupby_components(const float* const* src, const int32_t* w,
                       const int32_t* ops, int n, const uint8_t* mask, int P,
                       int C, float* out, void* stream) {
  if (n < 1 || n > MAX_PARTS || P < 1 || P > 255 || C < 0)
    return (int)cudaErrorInvalidValue;
  Parts pt;
  pt.n = n;
  int wout = 0;
  for (int t = 0; t < n; ++t) {
    if (w[t] < 1 || ops[t] < OP_SUM || ops[t] > OP_MAX)
      return (int)cudaErrorInvalidValue;
    pt.src[t] = src[t];
    pt.dst[t] = nullptr;
    pt.w[t] = w[t];
    pt.col[t] = wout;
    pt.op[t] = ops[t];
    wout += w[t];
  }
  if (C == 0) return (int)cudaSuccess;
  const int threads = 256;
  components_kernel<<<blocks_for((int64_t)C * wout, threads), threads, 0,
                      (cudaStream_t)stream>>>(pt, mask, P, C, wout, out);
  return (int)cudaGetLastError();
}

// dst / src: host arrays of n device pointers, state (P, C, w[t]) and
// shadow (Cs, w[t]); w, ops: host int32 arrays.
int groupby_absorb(float* const* dst, const float* const* src,
                   const int32_t* w, const int32_t* ops, int n, int pane,
                   int C, int Cs, void* stream) {
  if (n < 0 || n > MAX_PARTS || pane < 0 || Cs < 0 || Cs > C)
    return (int)cudaErrorInvalidValue;
  Parts pt;
  pt.n = n;
  int64_t most = 0;
  for (int t = 0; t < n; ++t) {
    if (w[t] < 1 || ops[t] < OP_SUM || ops[t] > OP_MAX)
      return (int)cudaErrorInvalidValue;
    pt.src[t] = src[t];
    pt.dst[t] = dst[t];
    pt.w[t] = w[t];
    pt.col[t] = 0;
    pt.op[t] = ops[t];
    if ((int64_t)Cs * w[t] > most) most = (int64_t)Cs * w[t];
  }
  if (most == 0) return (int)cudaSuccess;
  const int threads = 256;
  absorb_kernel<<<blocks_for(most, threads), threads, 0,
                  (cudaStream_t)stream>>>(pt, pane, C, Cs);
  return (int)cudaGetLastError();
}

}  // extern "C"
