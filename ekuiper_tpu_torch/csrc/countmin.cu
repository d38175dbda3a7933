// Count-min sketch kernels, for Hopper (sm_90a).
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes), beside the other
// csrc/*.cu. Every entry point launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError() of its
// launch.
//
// State: counts, float32 (d, w) row-major, on the device; row d of a value
// v is hash_f32(v, salt = d + 2) % w (ekuiper_tpu/ops/sketches.py
// CountMinSketch._hashes), which csrc/sketch_common.cuh's hash_f32 takes
// as its salt multiplier d + 3. w need not be a power of two: the modulo
// is a uint32 one, as the reference's.
//
// cms_update  replaces CountMinSketch._update_impl (sketches.py:282): each
//             value adds one into its cell of each of the d rows.
// cms_query   replaces _query_impl (sketches.py:288): each value's
//             estimate, the min over the d rows of its cell.
//
// What bounds them on an H100: the update reads n values and the (d, w)
// counts and writes the counts once (0.5 MB at 65,536 values into
// (4, 8192), 0.16 µs at 3.35 TB/s). Its adds are the problem: a skewed
// stream (the reference's heavy-hitters use) sends a third of its values
// to the cells of three values, and atomics to one address serialize at
// L2. One thread a value issuing d global atomics took 290 times the
// bound at phase M's mix. The query reads n values and n·d
// cells and writes n floats: one thread a value, the d hashes in
// registers.
//
// The update: a thread a value (grid-stride, warp-uniform rounds), each
// of the d cells' adds aggregated within the warp (__match_any_sync: the
// lanes that hash to one cell add their count with one global atomic,
// issued by the group's lowest lane). A hot cell takes one atomic a warp,
// not one a value, and every width takes the same path. A block per
// (chunk, row) counting into a row of w floats in shared memory, then
// flushing its non-zero cells, was measured beside it and kept out of the
// port (cms_routes.py, PERF.md): at (4, 8192) it ties on phase M's skewed
// mix and loses on a uniform stream, where the zeroing and scan of a 32
// KB row a block cost more than the few collisions they save.
// The counts stay integers below 2^24, where any order and grouping of the
// adds gives the same bits: the update is bit-equal to the plain version.

#include "sketch_common.cuh"

#define CMS_THREADS 256

__global__ void __launch_bounds__(CMS_THREADS)
    cms_update_kernel(float* __restrict__ counts, int depth, uint32_t width,
                      const float* __restrict__ values, int n) {
  const unsigned lane = threadIdx.x & 31u;
  for (int base = blockIdx.x * CMS_THREADS; base < n;
       base += gridDim.x * CMS_THREADS) {
    const int i = base + (int)threadIdx.x;
    const bool live = i < n;
    const float v = live ? values[i] : 0.0f;
    for (int d = 0; d < depth; ++d) {
      // a lane past n takes 0xffffffff, which no real cell (< w) equals
      const uint32_t h =
          live ? hash_f32(v, (uint32_t)(d + 3)) % width : 0xffffffffu;
      const unsigned peers = __match_any_sync(0xffffffffu, h);
      if (live && lane == (unsigned)(__ffs(peers) - 1))
        atomicAdd(counts + (int64_t)d * width + h, (float)__popc(peers));
    }
  }
}

// One thread per value: the min over the d rows of its cell.
__global__ void cms_query_kernel(const float* __restrict__ counts, int depth,
                                 uint32_t width,
                                 const float* __restrict__ values, int n,
                                 float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float v = values[i];
    float est = counts[hash_f32(v, 3u) % width];
    for (int d = 1; d < depth; ++d) {
      const uint32_t h = hash_f32(v, (uint32_t)(d + 3)) % width;
      est = fminf(est, counts[(int64_t)d * width + h]);
    }
    out[i] = est;
  }
}

extern "C" {

// counts: device float32 (depth, width); values: device float32 (n,).
int cms_update(float* counts, int depth, int width, const float* values,
               int n, void* stream) {
  if (depth < 1 || width < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cms_update_kernel<<<grid_for(n, CMS_THREADS), CMS_THREADS, 0,
                      (cudaStream_t)stream>>>(counts, depth, (uint32_t)width,
                                              values, n);
  return (int)cudaGetLastError();
}

// counts, values: as cms_update; out: device float32 (n,).
int cms_query(const float* counts, int depth, int width, const float* values,
              int n, float* out, void* stream) {
  if (depth < 1 || width < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  cms_query_kernel<<<grid_for(n, threads), threads, 0,
                     (cudaStream_t)stream>>>(counts, depth, (uint32_t)width,
                                             values, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
