// Kernels of the relational tier (stream-stream interval joins, lag(),
// rank / dense_rank / lead), for Hopper (sm_90a).
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes), like
// csrc/groupby.cu. Every entry point launches on the caller's stream,
// allocates nothing (the wrapper passes the sort's scratch), does not
// synchronise, and returns cudaGetLastError() of its launches.
//
// join_match replaces JoinRing._match_impl (ekuiper_tpu/ops/joinring.py:186):
//   mask[i, j] = slot_l[i] == slot_r[j] AND lo <= ts_l[i] - ts_r[j] <= hi
//                AND vl[i] AND vr[j] AND residual[i, j]
//   over the padded (PL, PR) candidate block, PL and PR powers of two. The
//   event times are rebased int32 (a call's range at most 2^28, NULL rows
//   at the sentinels -2^30 / 2^30) and the band is clamped to +-2^28, so
//   dt is formed in int32 exactly as the reference forms it and never
//   overflows. The ON residual is the expression IR's bool result over the
//   broadcast (PL, 1) / (1, PR) columns, computed by torch before the
//   launch as the fold's WHERE closures are (ops/groupby.py); the kernel
//   reads it through two strides, so a residual that depends on one side
//   only stays (PL, 1) or (1, PR). Bound of the function (residual columns
//   in, mask out): each side's slot, time, validity and float32 residual
//   columns read once, PL * PR bytes written (268 MB at 16,384 a side,
//   0.080 ms at 3.35 TB/s). The kernel itself also reads the materialised
//   (PL, PR) residual, which torch's broadcast compare writes before it.
//   Design: one thread per (i, j), neighbouring threads on neighbouring j,
//   so the right side's columns are read and the mask written coalesced;
//   grid.y walks the left rows (a grid-stride loop past 65,535).
//
// segscan_shift replaces SegScan._shift_impl (ekuiper_tpu/ops/segscan.py:124):
//   a stable sort of one micro-batch by (slot, arrival), then per row its
//   row number continuing the carry's count, lag(1) (the carry's last
//   value at a segment head, else the previous row's), the running sum
//   (NULL = NaN rows add 0) from the carry's sum; each segment's tail
//   writes the carry back (count, last value, has, sum) and each segment
//   whose slot had a carry counts one continued partition. Bound: reading
//   the batch and writing four outputs (13 bytes a row in, 13 out), plus
//   the carry's touched slots: 3.4 MB at 131,072 rows, ~1 us; the sort's
//   passes over the keys (log2(B) (log2(B)+1) / 2 compare steps) are the
//   real cost.
//
// segscan_sort replaces SegScan._sort_impl (ekuiper_tpu/ops/segscan.py:165):
//   per collection, row_number and lead(1) in arrival order within a
//   segment (sort by (seg, arrival)), then rank and dense_rank in value
//   order within a segment (sort by (seg, value, arrival), NaN keyed as
//   +inf, as segscan.py:180-181 does; NULL ranks as NULL). Bound as the
//   shift's: the collection read once, six outputs written once.
//
// Design of both sorts: a bitonic sort of packed 64-bit keys (segment in
// the high word, the arrival index or the value's order-preserving bits in
// the low word) with the arrival index as a 32-bit payload, compared as the
// pair (key, payload), so the order is the reference's lexsort order
// exactly. Chunks of SORT_CHUNK keys sort in shared memory in one launch;
// each larger merge stage runs its long strides as global passes and its
// short ones in shared memory. Then one thread per segment head walks its
// segment in order and writes every row's outputs at its arrival index (a
// permutation, so no two threads write one row); pad rows (segment id
// 2^30) write the defaults. A segment of many rows walked by one thread is
// slow but right; speed is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SORT_CHUNK 2048         // keys a block sorts in shared memory
#define SORT_THREADS 1024
#define SEG_PAD 0x40000000u     // ekuiper_tpu/ops/segscan.py _SEG_PAD

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// ------------------------------------------------------------------ #20
__global__ void join_match_kernel(const int32_t* __restrict__ slot_l,
                                  const int32_t* __restrict__ ts_l,
                                  const uint8_t* __restrict__ vl,
                                  const int32_t* __restrict__ slot_r,
                                  const int32_t* __restrict__ ts_r,
                                  const uint8_t* __restrict__ vr, int PL,
                                  int PR, int lo, int hi,
                                  const uint8_t* __restrict__ resid,
                                  long long rs_i, long long rs_j,
                                  uint8_t* __restrict__ mask) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= PR) return;
  const int32_t sr = slot_r[j];
  const int32_t tr = ts_r[j];
  const bool okr = vr[j] != 0;
  for (int i = blockIdx.y; i < PL; i += gridDim.y) {
    const int32_t dt = ts_l[i] - tr;
    bool m = okr && vl[i] != 0 && slot_l[i] == sr && dt >= lo && dt <= hi;
    if (m && resid != nullptr) m = resid[i * rs_i + j * rs_j] != 0;
    mask[(long long)i * PR + j] = m ? 1 : 0;
  }
}

// ------------------------------------------------------- bitonic sort
__device__ __forceinline__ bool kv_greater(unsigned long long ka, uint32_t va,
                                           unsigned long long kb,
                                           uint32_t vb) {
  return ka > kb || (ka == kb && va > vb);
}

// One compare-exchange step of the network in shared memory: pair t's lower
// element i, partner i + j, ascending where the global index has bit k clear.
__device__ __forceinline__ void shared_step(unsigned long long* sk,
                                            uint32_t* sv, int C, long long base,
                                            long long k, int j) {
  for (int t = threadIdx.x; t < C / 2; t += blockDim.x) {
    const int i = 2 * t - (t & (j - 1));
    const int l = i + j;
    const bool asc = ((base + i) & k) == 0;
    const bool gt = kv_greater(sk[i], sv[i], sk[l], sv[l]);
    if (gt == asc) {
      const unsigned long long tk = sk[i];
      sk[i] = sk[l];
      sk[l] = tk;
      const uint32_t tv = sv[i];
      sv[i] = sv[l];
      sv[l] = tv;
    }
  }
  __syncthreads();
}

// Every stage k <= C of the network inside each chunk of C keys (k_only 0),
// or, for one stage k > C, its strides j < C (k_only = k).
__global__ void bitonic_shared_kernel(unsigned long long* __restrict__ keys,
                                      uint32_t* __restrict__ vals, int C,
                                      long long k_only) {
  __shared__ unsigned long long sk[SORT_CHUNK];
  __shared__ uint32_t sv[SORT_CHUNK];
  const long long base = (long long)blockIdx.x * C;
  for (int t = threadIdx.x; t < C; t += blockDim.x) {
    sk[t] = keys[base + t];
    sv[t] = vals[base + t];
  }
  __syncthreads();
  if (k_only == 0) {
    for (int k = 2; k <= C; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) shared_step(sk, sv, C, base, k, j);
  } else {
    for (int j = C >> 1; j > 0; j >>= 1)
      shared_step(sk, sv, C, base, k_only, j);
  }
  for (int t = threadIdx.x; t < C; t += blockDim.x) {
    keys[base + t] = sk[t];
    vals[base + t] = sv[t];
  }
}

// One step (k, j >= C) of the network over all B keys, one thread a pair.
__global__ void bitonic_global_kernel(unsigned long long* __restrict__ keys,
                                      uint32_t* __restrict__ vals, int B,
                                      long long k, int j) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B / 2) return;
  const int i = 2 * t - (t & (j - 1));
  const int l = i + j;
  const bool asc = (i & k) == 0;
  const unsigned long long ki = keys[i], kl = keys[l];
  const uint32_t vi = vals[i], vl = vals[l];
  if (kv_greater(ki, vi, kl, vl) == asc) {
    keys[i] = kl;
    keys[l] = ki;
    vals[i] = vl;
    vals[l] = vi;
  }
}

// Ascending sort of B (a power of two) (key, payload) pairs.
static void bitonic_sort(unsigned long long* keys, uint32_t* vals, int B,
                         cudaStream_t st) {
  const int C = B < SORT_CHUNK ? B : SORT_CHUNK;
  const int half = C / 2 < 1 ? 1 : C / 2;
  const int threads = half < SORT_THREADS ? half : SORT_THREADS;
  bitonic_shared_kernel<<<B / C, threads, 0, st>>>(keys, vals, C, 0);
  for (long long k = 2LL * C; k <= B; k <<= 1) {
    for (long long j = k >> 1; j >= C; j >>= 1)
      bitonic_global_kernel<<<(B / 2 + 255) / 256, 256, 0, st>>>(
          keys, vals, B, k, (int)j);
    bitonic_shared_kernel<<<B / C, threads, 0, st>>>(keys, vals, C, k);
  }
}

// ------------------------------------------------------------ key builds
__device__ __forceinline__ uint32_t seg_id(const int32_t* seg,
                                           const uint8_t* valid, int i) {
  return valid[i] ? (uint32_t)seg[i] : SEG_PAD;
}

// (segment, arrival): the arrival index is the low word and the payload.
__global__ void arrival_keys_kernel(const int32_t* __restrict__ seg,
                                    const uint8_t* __restrict__ valid, int B,
                                    unsigned long long* __restrict__ keys,
                                    uint32_t* __restrict__ order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  keys[i] = ((unsigned long long)seg_id(seg, valid, i) << 32) | (uint32_t)i;
  order[i] = (uint32_t)i;
}

// A float's bits, mapped so that unsigned order is numeric order.
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// (segment, value, arrival): NaN keyed as +inf; arrival is the payload.
__global__ void value_keys_kernel(const int32_t* __restrict__ seg,
                                  const float* __restrict__ vals,
                                  const uint8_t* __restrict__ valid, int B,
                                  unsigned long long* __restrict__ keys,
                                  uint32_t* __restrict__ order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const float v = vals[i];
  const float k = isnan(v) ? INFINITY : v;
  keys[i] = ((unsigned long long)seg_id(seg, valid, i) << 32) |
            ordered_bits(k);
  order[i] = (uint32_t)i;
}

__device__ __forceinline__ uint32_t seg_of(const unsigned long long* keys,
                                           int p) {
  return (uint32_t)(keys[p] >> 32);
}

// ------------------------------------------------------------------ #21
__global__ void shift_walk_kernel(const unsigned long long* __restrict__ keys,
                                  const uint32_t* __restrict__ order, int B,
                                  const float* __restrict__ vals,
                                  int32_t* __restrict__ cnt,
                                  float* __restrict__ last,
                                  uint8_t* __restrict__ has,
                                  float* __restrict__ acc, int C,
                                  int32_t* __restrict__ rn,
                                  float* __restrict__ lag,
                                  uint8_t* __restrict__ lhas,
                                  float* __restrict__ run,
                                  int32_t* __restrict__ continued) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const uint32_t s = seg_of(keys, p);
  if (s == SEG_PAD) {  // pad rows: the defaults, each its own
    const uint32_t o = order[p];
    rn[o] = 0;
    lag[o] = qnan();
    lhas[o] = 0;
    run[o] = 0.f;
    return;
  }
  if (p > 0 && seg_of(keys, p - 1) == s) return;  // not a segment head
  const bool in = s < (uint32_t)C;
  const int32_t c0 = in ? cnt[s] : 0;
  const bool h0 = in && has[s] != 0;
  const float l0 = in ? last[s] : 0.f;
  const float a0 = in ? acc[s] : 0.f;
  if (h0) atomicAdd(continued, 1);
  // The running sum accumulates in double and rounds once per row, as the
  // plain version's float64 cumsum does: a float accumulator walked down a
  // segment of 2^17 rows drifts far past the reference's tree scan.
  int32_t pos = 0;
  double cum = 0.0;
  float prev = 0.f;
  for (int q = p; q < B && seg_of(keys, q) == s; ++q) {
    const uint32_t o = order[q];
    const float v = vals[o];
    ++pos;
    rn[o] = c0 + pos;
    if (pos == 1) {
      lag[o] = h0 ? l0 : qnan();
      lhas[o] = h0 ? 1 : 0;
    } else {
      lag[o] = prev;
      lhas[o] = 1;
    }
    cum += isnan(v) ? 0.0 : (double)v;
    run[o] = a0 + (float)cum;
    prev = v;
  }
  if (in) {  // the segment's tail writes the carry back
    cnt[s] = c0 + pos;
    last[s] = prev;
    has[s] = 1;
    acc[s] = a0 + (float)cum;
  }
}

// ------------------------------------------------------------------ #22
// Arrival order: row number, lead(1) and its flag.
__global__ void arrival_walk_kernel(const unsigned long long* __restrict__ keys,
                                    const uint32_t* __restrict__ order, int B,
                                    const float* __restrict__ vals,
                                    int32_t* __restrict__ rn,
                                    float* __restrict__ lead,
                                    uint8_t* __restrict__ lead_has) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const uint32_t s = seg_of(keys, p);
  if (s == SEG_PAD) {
    const uint32_t o = order[p];
    rn[o] = 0;
    lead[o] = qnan();
    lead_has[o] = 0;
    return;
  }
  if (p > 0 && seg_of(keys, p - 1) == s) return;
  int32_t pos = 0;
  for (int q = p; q < B && seg_of(keys, q) == s; ++q) {
    const uint32_t o = order[q];
    rn[o] = ++pos;
    const bool next = q + 1 < B && seg_of(keys, q + 1) == s;
    lead[o] = next ? vals[order[q + 1]] : qnan();
    lead_has[o] = next ? 1 : 0;
  }
}

// Value order: rank (the position of the value's first row), dense_rank
// (distinct values so far), NULL (NaN) ranked as NULL.
__global__ void value_walk_kernel(const unsigned long long* __restrict__ keys,
                                  const uint32_t* __restrict__ order, int B,
                                  const float* __restrict__ vals,
                                  int32_t* __restrict__ rank,
                                  int32_t* __restrict__ dense,
                                  uint8_t* __restrict__ rank_has) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const uint32_t s = seg_of(keys, p);
  if (s == SEG_PAD) {
    const uint32_t o = order[p];
    rank[o] = 0;
    dense[o] = 0;
    rank_has[o] = 0;
    return;
  }
  if (p > 0 && seg_of(keys, p - 1) == s) return;
  int32_t pos = 0, r = 0, d = 0;
  float prev = 0.f;
  for (int q = p; q < B && seg_of(keys, q) == s; ++q) {
    const uint32_t o = order[q];
    const float v = vals[o];
    const float k = isnan(v) ? INFINITY : v;
    ++pos;
    if (q == p || k != prev) {  // a new value (-0 equals +0, as in jnp)
      r = pos;
      ++d;
    }
    prev = k;
    const bool real = !isnan(v);
    rank[o] = real ? r : 0;
    dense[o] = real ? d : 0;
    rank_has[o] = real ? 1 : 0;
  }
}

static inline int blocks_of(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

static inline bool pow2(int b) { return b > 0 && (b & (b - 1)) == 0; }

extern "C" {

// slot_* / ts_*: device int32 (P*,); v*: device bool (P*,); resid: device
// bool read at i * rs_i + j * rs_j, or null; mask: device bool (PL, PR).
int join_match(const int32_t* slot_l, const int32_t* ts_l, const uint8_t* vl,
               int PL, const int32_t* slot_r, const int32_t* ts_r,
               const uint8_t* vr, int PR, int lo, int hi, const uint8_t* resid,
               long long rs_i, long long rs_j, uint8_t* mask, void* stream) {
  if (PL < 0 || PR < 0) return (int)cudaErrorInvalidValue;
  if (PL == 0 || PR == 0) return (int)cudaSuccess;
  const int threads = 256;
  const dim3 grid(blocks_of(PR, threads), PL < 65535 ? PL : 65535);
  join_match_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      slot_l, ts_l, vl, slot_r, ts_r, vr, PL, PR, lo, hi, resid, rs_i, rs_j,
      mask);
  return (int)cudaGetLastError();
}

// slots / vals / valid: device (B,) int32 / float32 / bool, B a power of
// two; cnt / last / has / acc: the carry, device (C,), updated in place;
// keys / order: scratch (B,) uint64 / uint32; rn / lag / lhas / run:
// outputs (B,); continued: one device int32, zeroed here.
int segscan_shift(const int32_t* slots, const float* vals,
                  const uint8_t* valid, int B, int32_t* cnt, float* last,
                  uint8_t* has, float* acc, int C, unsigned long long* keys,
                  uint32_t* order, int32_t* rn, float* lag, uint8_t* lhas,
                  float* run, int32_t* continued, void* stream) {
  if (!pow2(B) || C < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(continued, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  arrival_keys_kernel<<<blocks_of(B, threads), threads, 0, st>>>(
      slots, valid, B, keys, order);
  bitonic_sort(keys, order, B, st);
  shift_walk_kernel<<<blocks_of(B, threads), threads, 0, st>>>(
      keys, order, B, vals, cnt, last, has, acc, C, rn, lag, lhas, run,
      continued);
  return (int)cudaGetLastError();
}

// seg / vals / valid: device (B,) int32 / float32 / bool, B a power of
// two; keys / order: scratch (B,); outputs (B,): rn int32, lead float32,
// lead_has bool, rank int32, dense int32, rank_has bool.
int segscan_sort(const int32_t* seg, const float* vals, const uint8_t* valid,
                 int B, unsigned long long* keys, uint32_t* order, int32_t* rn,
                 float* lead, uint8_t* lead_has, int32_t* rank, int32_t* dense,
                 uint8_t* rank_has, void* stream) {
  if (!pow2(B)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  arrival_keys_kernel<<<blocks_of(B, threads), threads, 0, st>>>(
      seg, valid, B, keys, order);
  bitonic_sort(keys, order, B, st);
  arrival_walk_kernel<<<blocks_of(B, threads), threads, 0, st>>>(
      keys, order, B, vals, rn, lead, lead_has);
  value_keys_kernel<<<blocks_of(B, threads), threads, 0, st>>>(
      seg, vals, valid, B, keys, order);
  bitonic_sort(keys, order, B, st);
  value_walk_kernel<<<blocks_of(B, threads), threads, 0, st>>>(
      keys, order, B, vals, rank, dense, rank_has);
  return (int)cudaGetLastError();
}

}  // extern "C"
