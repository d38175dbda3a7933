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
// (4, 8192), 0.16 µs at 3.35 TB/s), but issues n·d scattered atomics into
// a table that stays in L2, so atomic throughput at L2 is its likely
// limit. The query reads n values and n·d cells and writes n floats.
// Design: one thread per value, grid-stride; the d hashes run in
// registers; native float atomicAdd (the counts stay integers below 2^24,
// where any order of the adds gives the same bits). No scratch, no second
// pass.

#include "sketch_common.cuh"

// One thread per value: d atomic adds of 1 into counts[d, h_d(v)].
__global__ void cms_update_kernel(float* __restrict__ counts, int depth,
                                  uint32_t width,
                                  const float* __restrict__ values, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float v = values[i];
    for (int d = 0; d < depth; ++d) {
      const uint32_t h = hash_f32(v, (uint32_t)(d + 3)) % width;
      atomicAdd(counts + (int64_t)d * width + h, 1.0f);
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
  const int threads = 256;
  cms_update_kernel<<<grid_for(n, threads), threads, 0,
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
