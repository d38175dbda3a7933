// A stable LSD radix sort of 8-bit digits over a packed 64-bit key (a
// segment id in the high word, an order-preserving value in the low word)
// with the arrival index as the payload, for Hopper (sm_90a). Shared by
// csrc/relational.cu (#21 segscan_shift, #22 segscan_sort: by segment, and
// by segment and value) and csrc/multirule.cu (the rule group's fold
// order: by (pane, slot)). Its design is set out in csrc/relational.cu's
// header note:
//  - radix_hist_kernel writes the keys and counts every digit place in one
//    read; its last block marks the places whose real keys fall in more
//    than one bin (a pass whose place is unmarked returns at once, with no
//    read-back to the host). Pad rows ride a 257th bin after every real
//    key, so the sorted order holds the real rows first.
//  - radix_pass_kernel: one stable scatter a place, a tile of 1,024 keys a
//    block, the tile's offset in each bin by decoupled look-back.
// A caller zeroes the SortPlan and the passes' look-back words before the
// histogram, launches the passes of the places it needs, and finds the
// sorted keys and payloads with sorted_by(sb, __popc(plan)).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SEG_THREADS 256
#define SEG_WARPS (SEG_THREADS / 32)
#define RADIX_ITEMS 4
#define RADIX_TILE (SEG_THREADS * RADIX_ITEMS)  // keys a pass's block ranks
#define DIGITS 256
#define BINS (DIGITS + 1)       // the digits' bins, then the pad rows'
#define NO_BIN BINS             // a lane past the batch's end
#define PLACES 8                // 8-bit digit places of the 64-bit key
#define PAD_BIT 0x80000000u     // payload flag of a pad row
#define LB_AGG 0x40000000u      // look-back word: this tile's own count
#define LB_INCL 0x80000000u     // ... the count of it and every tile before
#define LB_COUNT 0x3fffffffu
#define LB_BATCH 16             // look-back words read at once
#define SPIN_LIMIT (1 << 22)
#define MAX_B (1 << 29)         // counts and positions stay below 2^30
#define FULL_MASK 0xffffffffu

struct SortPlan {
  uint32_t plan[2];      // places each sort runs (bit d = place d): the
                         // arrival order's, the value order's
  uint32_t n_real;       // rows that are not pads
  uint32_t npad;
  uint32_t max_real1;    // the last real row's arrival index + 1
  uint32_t done;         // histogram blocks finished
  uint32_t ticket[12];   // the passes' tile tickets, by status slot
  uint32_t scan_ticket[2];
  uint32_t hist[PLACES][DIGITS];
};

struct SortBufs {
  const unsigned long long* k0;  // keys in arrival order
  const uint32_t* p0;            // arrival index | PAD_BIT
  unsigned long long* k[2];      // the passes' ping-pong buffers
  uint32_t* p[2];
};

// Where a sort leaves its keys after `passes` passes (pass k reads here
// with passes = k and writes k[k & 1], p[k & 1]).
__device__ __forceinline__ void sorted_by(const SortBufs& sb, int passes,
                                          const unsigned long long** k,
                                          const uint32_t** p) {
  if (passes == 0) {
    *k = sb.k0;
    *p = sb.p0;
  } else {
    *k = sb.k[(passes - 1) & 1];
    *p = sb.p[(passes - 1) & 1];
  }
}

// Look-back words, written once per state. A pass's word holds its count,
// so a volatile store is enough; a scan record's flag is published after a
// fence, behind the fields it announces.
__device__ __forceinline__ void store_word(uint32_t* p, uint32_t v) {
  *(volatile uint32_t*)p = v;
}

__device__ __forceinline__ void publish_word(uint32_t* p, uint32_t v) {
  __threadfence();
  store_word(p, v);
}

__device__ __forceinline__ uint32_t read_word(const uint32_t* p) {
  return *(const volatile uint32_t*)p;
}

// After a look-back read found a tile not yet published: false once the
// spins reach SPIN_LIMIT (a fault, never a hang).
__device__ __forceinline__ bool wait_more(int* spins) {
  if (++*spins > SPIN_LIMIT) return false;
  if (*spins > 64) __nanosleep(128);
  return true;
}

// Exclusive sum over the block of one value a thread (SEG_THREADS
// threads); *total gets the block's sum.
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t v,
                                                        uint32_t* s_warp,
                                                        uint32_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  uint32_t before = 0, sum = 0;
#pragma unroll
  for (int i = 0; i < SEG_WARPS; ++i) {
    const uint32_t t = s_warp[i];
    if (i < w) before += t;
    sum += t;
  }
  __syncthreads();
  *total = sum;
  return before + x - v;
}

// Keys, payloads and the digit counts of every place (VALUE: the value's
// four places and the segment's, else the segment's), over a grid-stride
// loop; the last block to finish writes the plan. Src gives row i's pad
// flag, segment and value bits: src.row(i, &pad, &seg, &value_bits).
template <bool VALUE, class Src>
__global__ void __launch_bounds__(SEG_THREADS)
    radix_hist_kernel(const Src src, int B,
                      unsigned long long* __restrict__ k0,
                      uint32_t* __restrict__ p0, SortPlan* __restrict__ sp,
                      int32_t* __restrict__ continued) {
  __shared__ uint32_t s_hist[PLACES][DIGITS];
  __shared__ uint32_t s_npad, s_max1;
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < PLACES * DIGITS; i += SEG_THREADS)
    s_hist[i / DIGITS][i % DIGITS] = 0;
  if (tid == 0) {
    s_npad = 0;
    s_max1 = 0;
    if (continued != nullptr && blockIdx.x == 0) *continued = 0;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * SEG_THREADS;
  for (long long base = (long long)blockIdx.x * SEG_THREADS; base < B;
       base += stride) {
    const long long i = base + tid;
    const bool in = i < B;
    bool pad = false;
    uint32_t s = 0, vb = 0;
    if (in) {
      src.row(i, &pad, &s, &vb);
      k0[i] = ((unsigned long long)s << 32) | vb;
      p0[i] = (uint32_t)i | (pad ? PAD_BIT : 0u);
    }
    const bool real = in && !pad;
    const uint32_t pads = __ballot_sync(FULL_MASK, in && pad);
    const uint32_t m = __reduce_max_sync(FULL_MASK,
                                         real ? (uint32_t)i + 1u : 0u);
    if (lane == 0) {
      if (pads) atomicAdd(&s_npad, (uint32_t)__popc(pads));
      if (m) atomicMax(&s_max1, m);
    }
#pragma unroll
    for (int d = VALUE ? 0 : 4; d < PLACES; ++d) {
      const uint32_t bin = real ? ((d < 4 ? vb : s) >> (8 * (d & 3))) & 0xffu
                                : NO_BIN;
      // a warp whose rows share the bin (one segment) adds once
      const uint32_t b0 = __shfl_sync(FULL_MASK, bin, 0);
      if (__all_sync(FULL_MASK, bin == b0)) {
        if (lane == 0 && b0 != NO_BIN) atomicAdd(&s_hist[d][b0], 32u);
      } else if (bin != NO_BIN) {
        atomicAdd(&s_hist[d][bin], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < PLACES * DIGITS; i += SEG_THREADS) {
    const uint32_t c = s_hist[i / DIGITS][i % DIGITS];
    if (c) atomicAdd(&sp->hist[i / DIGITS][i % DIGITS], c);
  }
  if (tid == 0) {
    if (s_npad) atomicAdd(&sp->npad, s_npad);
    if (s_max1) atomicMax(&sp->max_real1, s_max1);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&sp->done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  uint32_t c[PLACES], need = 0;
#pragma unroll
  for (int d = 0; d < PLACES; ++d) c[d] = __ldcg(&sp->hist[d][tid]);
#pragma unroll
  for (int d = 0; d < PLACES; ++d)
    if (__syncthreads_count(c[d] != 0) > 1) need |= 1u << d;
  if (tid == 0) {
    const uint32_t n_real = (uint32_t)B - __ldcg(&sp->npad);
    const bool misplaced = __ldcg(&sp->max_real1) > n_real;
    uint32_t pa = need & 0xf0u, pv = need;
    if (pa == 0 && misplaced) pa = 0x10u;
    if (pv == 0 && misplaced) pv = 0x01u;
    sp->n_real = n_real;
    sp->plan[0] = pa;
    sp->plan[1] = pv;
  }
}

// One stable scatter by digit place `place` of sort `sort`, if its plan
// runs it. status: (tiles, BINS) look-back words of this pass, zeroed.
__global__ void __launch_bounds__(SEG_THREADS)
    radix_pass_kernel(const SortBufs sb, int B,
                      const SortPlan* __restrict__ sp, int sort, int place,
                      uint32_t* __restrict__ status,
                      uint32_t* __restrict__ ticket) {
  const uint32_t plan = sp->plan[sort];
  if (!((plan >> place) & 1u)) return;
  const int k = __popc(plan & ((1u << place) - 1u));
  const unsigned long long* ik;
  const uint32_t* ip;
  sorted_by(sb, k, &ik, &ip);
  unsigned long long* ok = sb.k[k & 1];
  uint32_t* op = sb.p[k & 1];
  __shared__ uint32_t s_cnt[SEG_WARPS][BINS + 1];
  __shared__ uint32_t s_pre[BINS];  // each bin's first position, global
  __shared__ uint32_t s_loc[BINS];  // ... in the tile
  __shared__ uint32_t s_warp[SEG_WARPS];
  __shared__ unsigned long long s_key[RADIX_TILE];
  __shared__ uint32_t s_pay[RADIX_TILE];
  __shared__ int s_tile;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) s_tile = (int)atomicAdd(ticket, 1u);
  for (int i = tid; i < SEG_WARPS * (BINS + 1); i += SEG_THREADS)
    s_cnt[i / (BINS + 1)][i % (BINS + 1)] = 0;
  // each digit's first position: the place's counts scanned; pads after
  // every real key
  uint32_t total;
  s_pre[tid] = block_exclusive_sum(sp->hist[place][tid], s_warp, &total);
  if (tid == 0) s_pre[DIGITS] = sp->n_real;
  const int tile = s_tile;
  const long long base =
      (long long)tile * RADIX_TILE + (long long)w * (32 * RADIX_ITEMS) + lane;
  const uint32_t lower = (1u << lane) - 1u;
  unsigned long long key[RADIX_ITEMS];
  uint32_t pay[RADIX_ITEMS], bin[RADIX_ITEMS], rank[RADIX_ITEMS];
#pragma unroll
  for (int j = 0; j < RADIX_ITEMS; ++j) {
    const long long e = base + 32 * j;
    bin[j] = NO_BIN;
    if (e < B) {
      key[j] = ik[e];
      pay[j] = ip[e];
      bin[j] = (pay[j] & PAD_BIT) ? DIGITS
                                  : (uint32_t)(key[j] >> (8 * place)) & 0xffu;
    }
    // rank among the warp's rows so far: the earlier steps' count of the
    // bin, then the lower lanes of this step that share it (found by one
    // ballot per bit of the 9-bit bin)
    uint32_t peers = FULL_MASK;
#pragma unroll
    for (int bit = 0; bit < 9; ++bit) {
      const bool on = (bin[j] >> bit) & 1u;
      const uint32_t set = __ballot_sync(FULL_MASK, on);
      peers &= on ? set : ~set;
    }
    const uint32_t before = s_cnt[w][bin[j]];
    __syncwarp();
    if (lane == __ffs(peers) - 1) s_cnt[w][bin[j]] = before + __popc(peers);
    __syncwarp();
    rank[j] = before + __popc(peers & lower);
  }
  __syncthreads();
  uint32_t digit_count = 0;  // the tile's count of digit tid
  for (int b = tid; b < BINS; b += SEG_THREADS) {
    uint32_t sum = 0;
    for (int i = 0; i < SEG_WARPS; ++i) {
      const uint32_t c = s_cnt[i][b];
      s_cnt[i][b] = sum;
      sum += c;
    }
    if (b < DIGITS) digit_count = sum;
    uint32_t* mine = status + (size_t)tile * BINS + b;
    uint32_t prefix = 0;
    if (tile == 0) {
      store_word(mine, LB_INCL | sum);
    } else {
      store_word(mine, LB_AGG | sum);
      // the words of LB_BATCH tiles before at once, nearest first, down to
      // an inclusive one
      int spins = 0;
      for (int q = tile - 1; q >= 0;) {
        uint32_t word[LB_BATCH];
#pragma unroll
        for (int i = 0; i < LB_BATCH; ++i)
          word[i] = q - i >= 0 ? read_word(status + (size_t)(q - i) * BINS + b)
                               : 0u;
        int used = 0;
        bool done = false, stall = false;
#pragma unroll
        for (int i = 0; i < LB_BATCH; ++i) {
          if (done || stall || q - i < 0) continue;
          if (word[i] == 0) {
            stall = true;
            continue;
          }
          prefix += word[i] & LB_COUNT;
          ++used;
          done = (word[i] & LB_INCL) != 0;
        }
        if (done || (stall && !wait_more(&spins))) break;
        q -= used;
      }
      store_word(mine, LB_INCL | (prefix + sum));
    }
    s_pre[b] += prefix;
  }
  // the tile's rows in bin order through shared memory, then written out
  // in that order: neighbouring threads write neighbouring positions of a
  // bin
  s_loc[tid] = block_exclusive_sum(digit_count, s_warp, &total);
  if (tid == 0) s_loc[DIGITS] = total;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RADIX_ITEMS; ++j) {
    if (bin[j] == NO_BIN) continue;
    const uint32_t at = s_loc[bin[j]] + s_cnt[w][bin[j]] + rank[j];
    s_key[at] = key[j];
    s_pay[at] = pay[j];
  }
  __syncthreads();
  const long long rows = B - (long long)tile * RADIX_TILE;
  const int n = rows < RADIX_TILE ? (int)rows : RADIX_TILE;
  for (int at = tid; at < n; at += SEG_THREADS) {
    const unsigned long long kk = s_key[at];
    const uint32_t pp = s_pay[at];
    const uint32_t bb = (pp & PAD_BIT) ? DIGITS
                                       : (uint32_t)(kk >> (8 * place)) & 0xffu;
    const uint32_t dst = s_pre[bb] + (at - s_loc[bb]);
    ok[dst] = kk;
    op[dst] = pp;
  }
}

// ------------------------------------------------------------------ host
static inline int blocks_of(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

static inline int hist_blocks(int B) {
  const int b = blocks_of(B, 1024);
  return b > 128 ? 128 : b;
}

// The passes of one sort over places [first, last), status slots from
// slot0 on.
static inline void radix_passes(const SortBufs& sb, int B, SortPlan* sp,
                                uint32_t* status, int tiles, int sort,
                                int first, int last, int slot0,
                                cudaStream_t st) {
  for (int d = first; d < last; ++d) {
    const int slot = slot0 + d - first;
    radix_pass_kernel<<<tiles, SEG_THREADS, 0, st>>>(
        sb, B, sp, sort, d, status + (size_t)slot * tiles * BINS,
        &sp->ticket[slot]);
  }
}
