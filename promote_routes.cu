// Designs of the tier promote (#19) kept out of the port, beside the
// port's own (ekuiper_tpu_torch/csrc/tierstore.cu tier_promote: a thread
// a (row, packed column) of the real rows, a float atomic a column; its
// tables and the demote's run plan are included from there), for
// promote_routes.py to check against kernels.tier_promote_plain and time
// on one card:
//
// probe_promote_flat: the port's threads, each merging by a load, the
//   merge and a store (promote_merge: the fold atomics' sign-split min /
//   max, -0.0 below +0.0) in place of the atomic.
// probe_promote_runs: the demote's runs (tier_demote_plan over rows [0,
//   n)), 1-32 lanes a (row, component, pane) run, float4 where block and
//   state share a 16-byte phase, a load, merge and store each.
// probe_promote_runs_red: the same runs, each element merged by a float
//   atomic (float4 atomic adds over an additive run's aligned body).
//
// Every design merges the identity once more into row 0's slot where the
// block had pads (n < D). Built by promote_routes.py with nvcc -I
// ekuiper_tpu_torch/csrc.

#include "tierstore.cu"

// The value atomic_min_f32 / atomic_max_f32 leave in *a when *a holds a.
__device__ __forceinline__ float split_min_f32(float a, float v) {
  if (__float_as_int(v) >= 0)
    return __float_as_int(a) < __float_as_int(v) ? a : v;
  return __float_as_uint(a) > __float_as_uint(v) ? a : v;
}

__device__ __forceinline__ float split_max_f32(float a, float v) {
  if (__float_as_int(v) >= 0)
    return __float_as_int(a) > __float_as_int(v) ? a : v;
  return __float_as_uint(a) < __float_as_uint(v) ? a : v;
}

// v merged into s by the block's op, then, on a padded block's row 0
// (`pad`), with the identity once more, as the reference's pad rows.
__device__ __forceinline__ float promote_merge(float s, float v, int op,
                                              float init, bool pad) {
  if (op == TOP_MIN) {
    const float r = split_min_f32(s, v);
    return pad ? split_min_f32(r, init) : r;
  }
  if (op == TOP_MAX) {
    const float r = split_max_f32(s, v);
    return pad ? split_max_f32(r, init) : r;
  }
  const float r = __fadd_rn(s, v);
  return pad ? __fadd_rn(r, init) : r;
}

__device__ __forceinline__ float4 promote_merge4(float4 s, float4 v, int op,
                                                 float init, bool pad) {
  return make_float4(promote_merge(s.x, v.x, op, init, pad),
                     promote_merge(s.y, v.y, op, init, pad),
                     promote_merge(s.z, v.z, op, init, pad),
                     promote_merge(s.w, v.w, op, init, pad));
}

// One (row, pane) run of w floats by lane g of a group of G: the packed
// run src merged into the state run dst. float4 over the part where the
// two share a 16-byte phase, scalars for the head and tail around it
// (everything where the phases differ); a lane issues four runs' loads
// before their stores, as demote_run.
__device__ __forceinline__ void promote_run(float* __restrict__ dst,
                                            const float* __restrict__ src,
                                            int w, int op, float init,
                                            bool pad, int g, int G) {
  int head = 0, body = 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (((a ^ reinterpret_cast<uintptr_t>(src)) & 15u) == 0) {
    head = (int)((4u - ((a >> 2) & 3u)) & 3u);
    head = head < w ? head : w;
    body = (w - head) >> 2;
  }
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int e = g; e < body; e += 4 * G) {
    float4 x[4], y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e + u * G < body) {
        x[u] = d4[e + u * G];
        y[u] = s4[e + u * G];
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e + u * G < body)
        d4[e + u * G] = promote_merge4(x[u], y[u], op, init, pad);
  }
  const int tail = head + 4 * body;
  const int ns = head + (w - tail);  // the scalars: [0, head), [tail, w)
  for (int x = g; x < ns; x += 4 * G) {
    float sv[4], v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int y = x + u * G;
      if (y < ns) {
        const int e = y < head ? y : tail + (y - head);
        sv[u] = dst[e];
        v[u] = src[e];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int y = x + u * G;
      if (y < ns)
        dst[y < head ? y : tail + (y - head)] =
            promote_merge(sv[u], v[u], op, init, pad);
    }
  }
}

__device__ __forceinline__ void promote_atomic(float* dst, float v, int op,
                                               float init, bool pad) {
  if (op == TOP_MIN) {
    atomic_min_f32(dst, v);
    if (pad) atomic_min_f32(dst, init);
  } else if (op == TOP_MAX) {
    atomic_max_f32(dst, v);
    if (pad) atomic_max_f32(dst, init);
  } else {
    atomicAdd(dst, v);
    if (pad) atomicAdd(dst, init);
  }
}

__global__ void __launch_bounds__(DEMOTE_THREADS)
probe_flat_kernel(TierTab t, const int32_t* __restrict__ slots, int n, int C,
                  int Wp, bool pads, const float* __restrict__ packed) {
  const int i = (int)blockIdx.x * DEMOTE_THREADS + (int)threadIdx.x;
  if (i >= n * Wp) return;
  const int d = i / Wp;
  const int j = i - d * Wp;
  const float v = packed[i];
  const int slot = slots[d];
  int b = 0;
  while (b + 1 < t.n && j >= (int)t.off[b + 1]) ++b;
  const int w = (int)t.w[b];
  const int local = j - (int)t.off[b];
  const int p = local / w;
  float* dst = t.p[b] + ((long long)p * C + slot) * w + (local - p * w);
  *dst = promote_merge(*dst, v, t.op[b], t.init[b], pads && d == 0);
}

__device__ __forceinline__ void runs_red(float* __restrict__ dst,
                                         const float* __restrict__ src,
                                         int w, int op, float init, bool pad,
                                         int g, int G) {
  int head = 0, body = 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (op == TOP_ADD && ((a ^ reinterpret_cast<uintptr_t>(src)) & 15u) == 0) {
    head = (int)((4u - ((a >> 2) & 3u)) & 3u);
    head = head < w ? head : w;
    body = (w - head) >> 2;
  }
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  const float4 i4 = make_float4(init, init, init, init);
  for (int e = g; e < body; e += G) {
    atomicAdd(d4 + e, s4[e]);
    if (pad) atomicAdd(d4 + e, i4);
  }
  const int tail = head + 4 * body;
  const int ns = head + (w - tail);
  for (int y = g; y < ns; y += G) {
    const int e = y < head ? y : tail + (y - head);
    promote_atomic(dst + e, src[e], op, init, pad);
  }
}

// RED false: the runs merged by promote_run (loads and stores), true: by
// runs_red (atomics). Two kernels, so a trace tells them apart.
template <bool RED>
__device__ __forceinline__ void runs_body(const TierTab& t,
                                          const DemotePlan& dp,
                                          const int32_t* __restrict__ slots,
                                          int n, int C, int Wp, bool pads,
                                          const float* __restrict__ packed) {
  const int blk = (int)blockIdx.x;
  int k = 0;
  while (k + 1 < dp.ncls && blk >= dp.first[k + 1]) ++k;
  const int b = dp.comp[k];
  const int w = (int)t.w[b];
  const int G = 1 << dp.lg[k];
  const int tid = (blk - dp.first[k]) * DEMOTE_THREADS + (int)threadIdx.x;
  const int u = tid >> dp.lg[k];
  const int g = tid & (G - 1);
  const int d = u / dp.P;
  if (d >= n) return;
  const int p = u - d * dp.P;
  float* dst = t.p[b] + ((long long)p * C + slots[d]) * w;
  const float* src = packed + (long long)d * Wp + t.off[b] + (long long)p * w;
  if (RED)
    runs_red(dst, src, w, t.op[b], t.init[b], pads && d == 0, g, G);
  else
    promote_run(dst, src, w, t.op[b], t.init[b], pads && d == 0, g, G);
}

__global__ void __launch_bounds__(DEMOTE_THREADS)
probe_runs_store_kernel(TierTab t, DemotePlan dp,
                        const int32_t* __restrict__ slots, int n, int C,
                        int Wp, bool pads, const float* __restrict__ packed) {
  runs_body<false>(t, dp, slots, n, C, Wp, pads, packed);
}

__global__ void __launch_bounds__(DEMOTE_THREADS)
probe_runs_red_kernel(TierTab t, DemotePlan dp,
                      const int32_t* __restrict__ slots, int n, int C, int Wp,
                      bool pads, const float* __restrict__ packed) {
  runs_body<true>(t, dp, slots, n, C, Wp, pads, packed);
}

extern "C" {

int probe_promote_flat(float* const* ptrs, const long long* ws,
                       const float* inits, const int32_t* ops, int ncomps,
                       int P, int C, const int32_t* slots, int n, int D,
                       const float* packed, void* stream) {
  TierTab t;
  long long Wp = 0;
  if (!make_tiertab(ptrs, ws, inits, ops, ncomps, P, &t, &Wp) || n < 1 ||
      n > D || (long long)n * Wp > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int total = n * (int)Wp;
  probe_flat_kernel<<<(total + DEMOTE_THREADS - 1) / DEMOTE_THREADS,
                      DEMOTE_THREADS, 0, (cudaStream_t)stream>>>(
      t, slots, n, C, (int)Wp, n < D, packed);
  return (int)cudaGetLastError();
}

// red 0: probe_runs_store_kernel, 1: probe_runs_red_kernel
int probe_promote_runs(float* const* ptrs, const long long* ws,
                       const float* inits, const int32_t* ops, int ncomps,
                       int P, int C, const int32_t* slots, int n, int D,
                       const float* packed, int red, void* stream) {
  TierTab t;
  long long Wp = 0;
  if (!make_tiertab(ptrs, ws, inits, ops, ncomps, P, &t, &Wp) || n < 1 ||
      n > D || Wp > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  DemotePlan dp;  // the runs of rows [0, n): no pad class
  if (!tier_demote_plan(t, P, n, n, &dp)) return (int)cudaErrorInvalidValue;
  if (red)
    probe_runs_red_kernel<<<dp.first[dp.ncls], DEMOTE_THREADS, 0,
                            (cudaStream_t)stream>>>(t, dp, slots, n, C,
                                                    (int)Wp, n < D, packed);
  else
    probe_runs_store_kernel<<<dp.first[dp.ncls], DEMOTE_THREADS, 0,
                              (cudaStream_t)stream>>>(t, dp, slots, n, C,
                                                      (int)Wp, n < D, packed);
  return (int)cudaGetLastError();
}

}  // extern "C"
