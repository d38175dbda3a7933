// The count-min update's (#10) "rows" design, measured beside the port's
// kernel (ekuiper_tpu_torch/csrc/countmin.cu cms_update_kernel: a thread
// a value, warp-aggregated global atomics) by cms_routes.py and kept out
// of the port: a grid over (chunk of values, row d); each block zeroes a
// row of w floats in shared memory, hashes its chunk, adds equal cells of
// a warp together (__match_any_sync, one shared atomic a distinct cell a
// warp), then adds each non-zero cell of its row into the counts with one
// global atomic, so a hot cell takes one global atomic a block.
//
// Built by cms_routes.py with the port's nvcc flags against its csrc/.

#include "sketch_common.cuh"

#define PROBE_THREADS 256

// Block (x, d) takes values [x·chunk, (x + 1)·chunk) into row d. Every
// thread of a block runs the same number of rounds, so a warp's lanes stay
// converged for __match_any_sync; a lane past the chunk takes the cell
// 0xffffffff, which no real cell (< w) equals.
__global__ void __launch_bounds__(PROBE_THREADS)
    probe_cms_rows_kernel(float* __restrict__ counts, uint32_t width,
                          const float* __restrict__ values, int n,
                          int chunk) {
  extern __shared__ float row[];
  const int d = blockIdx.y;
  for (uint32_t c = threadIdx.x; c < width; c += PROBE_THREADS) row[c] = 0.0f;
  __syncthreads();
  const int lo = blockIdx.x * chunk;
  const int hi = min(n, lo + chunk);
  const unsigned lane = threadIdx.x & 31u;
  for (int base = lo; base < hi; base += PROBE_THREADS) {
    const int i = base + (int)threadIdx.x;
    const uint32_t h =
        i < hi ? hash_f32(values[i], (uint32_t)(d + 3)) % width : 0xffffffffu;
    const unsigned peers = __match_any_sync(0xffffffffu, h);
    if (h != 0xffffffffu && lane == (unsigned)(__ffs(peers) - 1))
      atomicAdd(row + h, (float)__popc(peers));
  }
  __syncthreads();
  float* out = counts + (int64_t)d * width;
  for (uint32_t c = threadIdx.x; c < width; c += PROBE_THREADS) {
    const float v = row[c];
    if (v != 0.0f) atomicAdd(out + c, v);
  }
}

extern "C" {

// As cms_update (csrc/countmin.cu); an error where a row of w floats does
// not fit a block's shared memory. About one wave of blocks over the d
// rows, a chunk at least one round of the block's threads.
int probe_cms_rows(float* counts, int depth, int width, const float* values,
                   int n, void* stream) {
  int dev = 0, sms = 0, smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const long long bytes = (long long)width * (long long)sizeof(float);
  if (depth < 1 || depth > 65535 || width < 1 || n < 0 || bytes > smem)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  long long per_row = (sms + depth - 1) / depth;
  const long long rounds = (n + PROBE_THREADS - 1) / PROBE_THREADS;
  if (per_row > rounds) per_row = rounds;
  if (per_row < 1) per_row = 1;
  const int chunk = (int)((n + per_row - 1) / per_row);
  const int blocks = (n + chunk - 1) / chunk;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_cms_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  probe_cms_rows_kernel<<<dim3(blocks, depth), PROBE_THREADS, (size_t)bytes,
                          (cudaStream_t)stream>>>(counts, (uint32_t)width,
                                                  values, n, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
