// Kernels of the relational tier (stream-stream interval joins, lag(),
// rank / dense_rank / lead), for Hopper (sm_90a).
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes), like
// csrc/groupby.cu. Every entry point launches on the caller's stream,
// allocates nothing (the wrapper passes the sort's scratch, sized by
// segscan_scratch_bytes), does not synchronise, and returns
// cudaGetLastError() of its launches.
//
// join_match replaces JoinRing._match_impl (ekuiper_tpu/ops/joinring.py:186):
//   mask[i, j] = slot_l[i] == slot_r[j] AND lo <= ts_l[i] - ts_r[j] <= hi
//                AND vl[i] AND vr[j] AND residual[i, j]
//   over the padded (PL, PR) candidate block, PL and PR powers of two,
//   written packed one bit a pair: row i is ceil(PR / 32) uint32 words,
//   bit j % 32 of word j / 32 is mask[i, j] (numpy's packbits with
//   bitorder "little" on a little-endian host; bits past PR are 0). The
//   event times are rebased int32 (a call's range at most 2^28, NULL rows
//   at the sentinels -2^30 / 2^30) and the band is clamped to +-2^28, so
//   dt is formed in int32 exactly as the reference forms it and never
//   overflows (the kernel subtracts modulo 2^32, as torch's int32 does).
//   The ON residual is the expression IR's bool result over the broadcast
//   (PL, 1) / (1, PR) columns, computed by torch before the launch as the
//   fold's WHERE closures are (ops/groupby.py); the kernel reads it
//   through its stride along i and a stride along j of 0 or 1 (the
//   wrapper makes any other layout contiguous), so a residual that
//   depends on one side only stays (PL, 1) or (1, PR).
//   Bound of the function (residual columns in, mask out): each side's
//   slot, time, validity and float32 residual columns read once, PL * PR
//   bits written (33.5 MB at 16,384 a side, 0.010 ms at 3.35 TB/s). A
//   (PL, PR) residual adds its PL * PR bytes to the kernel's own reads
//   (268 MB, 0.080 ms): torch's broadcast compare writes it before.
//   Design: a warp owns a strip of 1,024 columns (32 words). Lane l keeps
//   the right side's slot and time of columns j0 + 32k + l, k < 32, in
//   registers, loaded once a strip, and the validity of its own word's
//   32 columns as a word (a ballot a k). The warp walks a run of rows: a
//   row's slot, time and validity are loaded by one lane each, 32 rows at
//   a time, and passed round by shuffles. For each k, __ballot_sync of
//   "slot equal and dt in the band" is word k of the row, which lane k
//   keeps; two rows a pass, so that the scheduler has two independent
//   chains. The row's strip is then one 128-byte coalesced store. A (PL,
//   PR) residual is read as 32 bytes a lane (two 16-byte loads issued
//   before the pair's ballots, turned into a word by multiplies after
//   them) and ANDed into the lane's word. A persistent grid (the card's
//   SMs times the kernel's occupancy): work items of (strip, a run of at
//   least 8 rows) sized so that each warp takes about one, so a strip's
//   registers are loaded about once a warp. Each pair costs a lane about
//   five instructions (the compares, its share of the ballot, the select),
//   so without a (PL, PR) residual the kernel is bound by issue, not by
//   its store.

// segscan_shift replaces SegScan._shift_impl (ekuiper_tpu/ops/segscan.py:124):
//   a stable sort of one micro-batch by slot (arrival order within a slot),
//   then per row its row number continuing the carry's count, lag(1) (the
//   carry's last value at a segment head, else the previous row's), the
//   running sum (NULL = NaN rows add 0) from the carry's sum; each
//   segment's tail writes the carry back (count, last value, has, sum) and
//   each segment whose slot had a carry counts one continued partition.
//
// segscan_sort replaces SegScan._sort_impl (ekuiper_tpu/ops/segscan.py:165):
//   per collection, row_number and lead(1) in arrival order within a
//   segment, then rank and dense_rank in value order within a segment (NaN
//   keyed as +inf, as segscan.py:180-181 does; NULL ranks as NULL).
//
// Bound of both: the batch read once (9 bytes a row), the outputs written
// once (13 and 14 bytes a row), the shift's touched carry slots read and
// written: ~3 MB at 131,072 rows, about 1 us at 3.35 TB/s. What sets the
// time at these sizes is the chain of dependent launches and, inside each,
// a few round trips to L2.
//
// Design. A stable LSD radix sort of 8-bit digits over a packed 64-bit key
// (the segment in the high word; for the value order the value's
// order-preserving bits in the low word, NaN as +inf and -0 as +0, else 0)
// with the arrival index as the payload, so the order is the reference's
// lexsort order; then one segmented scan over the sorted order.
//  - radix_hist_kernel writes the keys and counts every digit place in one
//    read (as Onesweep does, Adinets & Merrill 2022). Its last block marks
//    the places whose real keys fall in more than one bin; a pass whose
//    place is unmarked returns at once on the card (no read-back to the
//    host). Pad rows (valid false) have no key: a flag in the payload's
//    top bit sends them to a 257th bin after every real key in each pass
//    that runs, so they make no place vary. Where no place varies but a
//    pad precedes a real row, one pass runs to move the pads behind.
//  - radix_pass_kernel: one stable scatter a place. A block of 256 threads
//    ranks a tile of 1,024 keys, warp-striped so that the ranks follow the
//    tile's order: per step, nine ballots find the lanes that share a bin,
//    and per-warp bin counts in shared memory carry the rank across steps.
//    The tile's offset in each bin comes from the tiles before it by
//    decoupled look-back (a flag | count word per tile and bin, 16 words
//    read at once; tiles numbered by an atomic ticket, so a tile waits only
//    on tiles that have started). The tile is put in bin order in shared
//    memory and written out from there, so that neighbouring threads write
//    neighbouring positions.
//  - seg_scan_kernel: each thread takes 4 consecutive sorted rows, warps
//    scan by __shfl_up_sync, warp totals go through shared memory, and
//    tiles of 1,024 rows chain by single-pass decoupled look-back (Merrill
//    & Garland 2016). The monoid is that of the reference's _seg_cumsum /
//    _seg_propagate over (flag, value) pairs reset at a segment head: the
//    last segment head, the last value group's head, and a segmented sum
//    (the shift's running sum in double, rounded once a row as the plain
//    version; the value order's count of new values). Each output is
//    written at the row's arrival index.
//  - carry_apply_kernel (shift only): each segment's tail writes the carry
//    back from the outputs in a launch after the scan, so no row of the
//    scan can read a carry slot that is being written.
// A spin on a look-back word gives up after SPIN_LIMIT polls (a fault then
// shows as a wrong output, never as a hung card). Launches: 8 for the shift
// (a memset of the scratch's counters, the histogram, four passes, the
// scan, the carry) and 16 for the sort (a memset, the histogram, four
// passes and the arrival scan, eight passes and the value scan). The tile
// sizes were chosen on the H100 among 1,024, 2,048 and 4,096 rows (PERF.md).

#include <math.h>

#include "radix_sort.cuh"

#define SCAN_ITEMS 4
#define SCAN_TILE (SEG_THREADS * SCAN_ITEMS)    // rows a scan's block takes

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// ------------------------------------------------------------------ #20
#define JM_THREADS 256
#define JM_WORDS 32  // words of 32 pairs a warp owns in a row: its strip
#define JM_STRIP (32 * JM_WORDS)

struct JoinArgs {
  const int32_t* slot_l;
  const int32_t* ts_l;
  const uint8_t* vl;
  const int32_t* slot_r;
  const int32_t* ts_r;
  const uint8_t* vr;
  const uint8_t* resid;  // null, or read at i * rs_i (+ j when rs_j is 1)
  long long rs_i;
  uint32_t* mask;        // (PL, words)
  int PL, PR, words, strips;
  int rows;              // rows a work item takes
  long long items;       // strips x ceil(PL / rows)
  int lo;
  uint32_t span;         // hi - lo; the band is empty when `empty`
  bool empty;
};

// Four bytes of 0 / 1 as four bits, byte b to bit b: each byte's bit is
// multiplied to bit 24 + b, and no two products share a bit.
__device__ __forceinline__ uint32_t nibble(uint32_t v) {
  return ((v & 0x01010101u) * 0x01020408u) >> 24;
}

// 32 residual bytes, loaded as two 16-byte halves, as a word.
__device__ __forceinline__ uint32_t word_of(uint4 a, uint4 b) {
  return nibble(a.x) | nibble(a.y) << 4 | nibble(a.z) << 8 |
         nibble(a.w) << 12 | nibble(b.x) << 16 | nibble(b.y) << 20 |
         nibble(b.z) << 24 | nibble(b.w) << 28;
}

// The residual's n (<= 32) bytes at p as a word, byte b to bit b.
__device__ __forceinline__ uint32_t resid_word(const uint8_t* p, int n) {
  if (n == 32 && (reinterpret_cast<uintptr_t>(p) & 15u) == 0)
    return word_of(__ldg(reinterpret_cast<const uint4*>(p)),
                   __ldg(reinterpret_cast<const uint4*>(p + 16)));
  uint32_t w = 0u;
  for (int b = 0; b < n; ++b) w |= (uint32_t)(p[b] != 0) << b;
  return w;
}

// The ballots of two rows (slot s0 / s1, time less lo dl0 / dl1) against
// the strip: word k of each row, kept by lane k. Two rows a pass give the
// scheduler two independent chains.
__device__ __forceinline__ void ballot_rows(const int32_t (&sr)[JM_WORDS],
                                            const int32_t (&tr)[JM_WORDS],
                                            int32_t s0, uint32_t dl0,
                                            int32_t s1, uint32_t dl1,
                                            uint32_t span, int lane,
                                            uint32_t* w0, uint32_t* w1) {
#pragma unroll
  for (int k = 0; k < JM_WORDS; ++k) {
    // ts_l - lo - ts_r = dt - lo, modulo 2^32: in [0, hi - lo] exactly
    // when lo <= dt <= hi
    const uint32_t b0 = __ballot_sync(
        FULL_MASK, s0 == sr[k] && dl0 - (uint32_t)tr[k] <= span);
    const uint32_t b1 = __ballot_sync(
        FULL_MASK, s1 == sr[k] && dl1 - (uint32_t)tr[k] <= span);
    if (lane == k) {
      *w0 = b0;
      *w1 = b1;
    }
  }
}

// RES: 0 no residual; 1 one value a row (stride 0 along j); 2 a row of
// values contiguous along j.
template <int RES>
__global__ void __launch_bounds__(JM_THREADS)
    join_match_kernel(const __grid_constant__ JoinArgs a) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * (JM_THREADS / 32);
  int loaded = -1;
  int32_t sr[JM_WORDS], tr[JM_WORDS];
  uint32_t vword = 0u;  // validity of this lane's word's 32 columns
  for (long long it = ((long long)blockIdx.x * JM_THREADS + threadIdx.x) >> 5;
       it < a.items; it += nwarps) {
    const int strip = (int)(it % a.strips);
    const int i0 = (int)(it / a.strips) * a.rows;
    const int i1 = min(i0 + a.rows, a.PL);
    const int j0 = strip * JM_STRIP;
    const int nk = min(JM_WORDS, a.words - strip * JM_WORDS);  // in strip
    if (strip != loaded) {  // columns past PR: invalid, never stored
#pragma unroll
      for (int k = 0; k < JM_WORDS; ++k) {
        const int j = j0 + 32 * k + lane;
        const bool in = j < a.PR;
        sr[k] = in ? __ldg(a.slot_r + j) : 0;
        tr[k] = in ? __ldg(a.ts_r + j) : 0;
        const uint32_t v = __ballot_sync(FULL_MASK, in && a.vr[j] != 0);
        if (lane == k) vword = v;
      }
      loaded = strip;
    }
    const int jw = j0 + 32 * lane;  // this lane's word's first column
    const int nj = max(0, min(32, a.PR - jw));
    const bool mine = lane < nk;  // this lane's word lies in the row
    uint32_t rconst = ~0u;  // a (1, PR) residual: the same word every row
    if (RES == 2 && a.rs_i == 0 && mine)
      rconst = resid_word(a.resid + jw, nj);
    // a (PL, PR) residual whose rows keep this lane's 32 bytes on a
    // 16-byte boundary: loaded raw before a pair's ballots and turned into
    // words after them, so the loads overlap the ballots
    const bool rvec =
        RES == 2 && mine && nj == 32 && a.rs_i != 0 &&
        ((reinterpret_cast<uintptr_t>(a.resid + jw) | (uintptr_t)a.rs_i) &
         15u) == 0;
    for (int ib = i0; ib < i1; ib += 32) {
      const int il = ib + lane;
      int32_t sl = 0;
      uint32_t tl = 0u;
      bool ok = false;
      if (il < i1) {
        sl = __ldg(a.slot_l + il);
        tl = (uint32_t)__ldg(a.ts_l + il) - (uint32_t)a.lo;
        ok = !a.empty && a.vl[il] != 0;
        if (RES == 1 && ok) ok = a.resid[il * a.rs_i] != 0;
      }
      const uint32_t rows_ok = __ballot_sync(FULL_MASK, ok);
      const int nrow = min(32, i1 - ib);
      for (int t = 0; t < nrow; t += 2) {
        const int t1 = t + 1 < nrow ? t + 1 : t;
        const long long r0 = ib + t, r1 = ib + t1;
        uint4 x0 = {}, x1 = {}, x2 = {}, x3 = {};
        if (rvec) {
          const uint4* p0 =
              reinterpret_cast<const uint4*>(a.resid + r0 * a.rs_i + jw);
          const uint4* p1 =
              reinterpret_cast<const uint4*>(a.resid + r1 * a.rs_i + jw);
          x0 = __ldcs(p0);
          x1 = __ldcs(p0 + 1);
          x2 = __ldcs(p1);
          x3 = __ldcs(p1 + 1);
        }
        uint32_t w0 = 0u, w1 = 0u;
        if ((rows_ok >> t) & 3u)  // the same branch in every lane
          ballot_rows(sr, tr, __shfl_sync(FULL_MASK, sl, t),
                      __shfl_sync(FULL_MASK, tl, t),
                      __shfl_sync(FULL_MASK, sl, t1),
                      __shfl_sync(FULL_MASK, tl, t1), a.span, lane, &w0,
                      &w1);
        if (!((rows_ok >> t) & 1u)) w0 = 0u;
        if (!((rows_ok >> t1) & 1u)) w1 = 0u;
        uint32_t q0 = ~0u, q1 = ~0u;  // the residual's words
        if (RES == 2 && mine) {
          if (a.rs_i == 0) {
            q0 = q1 = rconst;
          } else if (rvec) {
            q0 = word_of(x0, x1);
            q1 = word_of(x2, x3);
          } else {
            q0 = resid_word(a.resid + r0 * a.rs_i + jw, nj);
            q1 = resid_word(a.resid + r1 * a.rs_i + jw, nj);
          }
        }
        if (mine) {
          a.mask[r0 * a.words + strip * JM_WORDS + lane] = w0 & vword & q0;
          if (t1 != t) a.mask[r1 * a.words + strip * JM_WORDS + lane] =
              w1 & vword & q1;
        }
      }
    }
  }
}

// Blocks of #20's persistent grid: as many as the current card holds at
// once (its SMs times the kernel's occupancy, cached a device and a
// residual form), -1 on an error of the runtime.
static int join_blocks(int res) {
  static int cached[64][3] = {{0}};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  int most = dev >= 0 && dev < 64 ? cached[dev][res] : 0;
  if (most == 0) {
    const void* k = res == 0   ? (const void*)join_match_kernel<0>
                    : res == 1 ? (const void*)join_match_kernel<1>
                               : (const void*)join_match_kernel<2>;
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, JM_THREADS,
                                                      0) != cudaSuccess)
      return -1;
    most = sms * (per_sm > 0 ? per_sm : 1);
    if (dev >= 0 && dev < 64) cached[dev][res] = most;
  }
  return most;
}


// A float's bits, mapped so that unsigned order is numeric order.
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The value order's key: NaN (NULL) as +inf and -0 as +0, so that equal
// keys are the reference's equal values and ties keep arrival order.
__device__ __forceinline__ uint32_t value_bits(float v) {
  return ordered_bits(isnan(v) ? INFINITY : (v == 0.f ? 0.f : v));
}

// The sort's rows: a segment id, a pad flag (valid false) and, for the
// value order, the value's bits.
template <bool VALUE>
struct SegSrc {
  const int32_t* seg;
  const float* vals;
  const uint8_t* valid;
  __device__ __forceinline__ void row(long long i, bool* pad, uint32_t* s,
                                      uint32_t* vb) const {
    *pad = valid[i] == 0;
    *s = (uint32_t)seg[i];
    if (VALUE) *vb = value_bits(vals[i]);
  }
};




// ------------------------------------------------------------- the scan
enum { SHIFT = 0, ARRIVAL = 1, VALUE = 2 };

// The segmented scan's element: `hf` a segment head in the span, `start`
// the last segment head's position, `vstart` the last value group's head
// (value order), `sum` the sum since the last segment head.
struct Agg {
  double sum;
  int start;
  int vstart;
  bool hf;
};

__device__ __forceinline__ Agg ident() {
  Agg a;
  a.sum = 0.0;
  a.start = -1;
  a.vstart = -1;
  a.hf = false;
  return a;
}

// a, then b
__device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {
  Agg r;
  r.hf = a.hf || b.hf;
  r.sum = b.hf ? b.sum : a.sum + b.sum;
  r.start = a.start > b.start ? a.start : b.start;
  r.vstart = a.vstart > b.vstart ? a.vstart : b.vstart;
  return r;
}

__device__ __forceinline__ Agg shfl_up(const Agg& a, int o) {
  Agg r;
  r.sum = __shfl_up_sync(FULL_MASK, a.sum, o);
  r.start = __shfl_up_sync(FULL_MASK, a.start, o);
  r.vstart = __shfl_up_sync(FULL_MASK, a.vstart, o);
  r.hf = __shfl_up_sync(FULL_MASK, (int)a.hf, o) != 0;
  return r;
}

template <int MODE>
__device__ __forceinline__ Agg element(long long p, bool head, bool newv,
                                       float v) {
  Agg e;
  e.hf = head;
  e.start = head ? (int)p : -1;
  e.vstart = newv ? (int)p : -1;
  e.sum = MODE == SHIFT ? (isnan(v) ? 0.0 : (double)v)
                        : (MODE == VALUE && newv ? 1.0 : 0.0);
  return e;
}

// A tile's look-back record: `flag` set after the rest is written.
struct ScanRec {
  double sum;
  int start;
  int vstart;
  uint32_t hf;
  uint32_t flag;
};

__device__ __forceinline__ void publish_rec(ScanRec* r, const Agg& a) {
  r->sum = a.sum;
  r->start = a.start;
  r->vstart = a.vstart;
  r->hf = a.hf ? 1u : 0u;
  publish_word(&r->flag, 1u);
}

__device__ __forceinline__ Agg read_rec(const ScanRec* r) {
  Agg a;
  a.sum = __ldcg(&r->sum);
  a.start = __ldcg(&r->start);
  a.vstart = __ldcg(&r->vstart);
  a.hf = __ldcg(&r->hf) != 0;
  return a;
}

// The combined records of the tiles before `tile` back to the nearest that
// holds a segment head or has its inclusive record; the flags of LB_BATCH
// tiles are read at once, nearest first.
__device__ Agg look_back(const ScanRec* recs, int tile) {
  Agg pre = ident();
  int spins = 0;
  for (int q = tile - 1; q >= 0;) {
    uint32_t fi[LB_BATCH], fa[LB_BATCH];
#pragma unroll
    for (int i = 0; i < LB_BATCH; ++i) {
      fi[i] = fa[i] = 0u;
      if (q - i >= 0) {
        const ScanRec* r = recs + 2 * (long long)(q - i);
        fi[i] = read_word(&r[1].flag);
        fa[i] = read_word(&r[0].flag);
      }
    }
    __threadfence();
    int used = 0;
    bool done = false, stall = false;
#pragma unroll
    for (int i = 0; i < LB_BATCH; ++i) {
      if (done || stall || q - i < 0) continue;
      if (fi[i] == 0 && fa[i] == 0) {
        stall = true;
        continue;
      }
      const Agg g = read_rec(recs + 2 * (long long)(q - i) + (fi[i] ? 1 : 0));
      pre = combine(g, pre);
      ++used;
      done = fi[i] != 0 || g.hf;
    }
    if (done || (stall && !wait_more(&spins))) break;
    q -= used;
  }
  return pre;
}

struct ScanArgs {
  SortBufs sb;
  int B;
  const SortPlan* sp;
  int sort;              // whose plan: 0 arrival order, 1 value order
  ScanRec* recs;         // (tiles, 2): aggregate, inclusive; zeroed
  uint32_t* ticket;
  const float* vals;
  const int32_t* cnt;    // the shift's carry, read only here
  const float* last;
  const uint8_t* has;
  const float* acc;
  int C;
  int32_t* continued;
  int32_t* rn;           // row number (shift, arrival order)
  float* f1;             // lag (shift) / lead (arrival order)
  uint8_t* b1;           // its flag
  float* run;            // running sum (shift)
  int32_t* rank;         // value order
  int32_t* dense;
  uint8_t* rank_has;
};

template <int MODE>
__global__ void __launch_bounds__(SEG_THREADS)
    seg_scan_kernel(const ScanArgs a) {
  __shared__ Agg s_warp[SEG_WARPS];
  __shared__ Agg s_pre;
  __shared__ int s_tile, s_cont;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const uint32_t plan = a.sp->plan[a.sort];
  const long long n_real = a.sp->n_real;
  if (tid == 0) {
    s_tile = (int)atomicAdd(a.ticket, 1u);
    s_cont = 0;
  }
  __syncthreads();
  const int tile = s_tile;
  const unsigned long long* keys;
  const uint32_t* pays;
  sorted_by(a.sb, __popc(plan), &keys, &pays);
  const long long p0 =
      (long long)tile * SCAN_TILE + (long long)tid * SCAN_ITEMS;
  unsigned long long key[SCAN_ITEMS];
  uint32_t ord[SCAN_ITEMS];
  float v[SCAN_ITEMS];
  uint32_t heads = 0, newvs = 0;
  Agg t = ident();
  unsigned long long pk = 0ull;
  float pv = 0.f;  // the row before p0's value (the shift's lag)
  if (p0 > 0 && p0 < n_real) {
    pk = keys[p0 - 1];
    if (MODE == SHIFT) pv = a.vals[pays[p0 - 1] & ~PAD_BIT];
  }
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long p = p0 + i;
    key[i] = 0ull;
    ord[i] = 0u;
    v[i] = 0.f;
    if (p < n_real) {
      key[i] = keys[p];
      ord[i] = pays[p] & ~PAD_BIT;
      v[i] = a.vals[ord[i]];
      const bool h = p == 0 || (pk >> 32) != (key[i] >> 32);
      const bool nv = p == 0 || pk != key[i];
      heads |= (uint32_t)h << i;
      newvs |= (uint32_t)nv << i;
      t = combine(t, element<MODE>(p, h, nv, v[i]));
      pk = key[i];
    } else if (p < a.B) {
      ord[i] = pays[p] & ~PAD_BIT;
    }
  }
  Agg x = t;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Agg y = shfl_up(x, o);
    if (lane >= o) x = combine(y, x);
  }
  Agg ex = shfl_up(x, 1);
  if (lane == 0) ex = ident();
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  if (tid == 0) {
    Agg tot = ident();
    for (int i = 0; i < SEG_WARPS; ++i) {
      const Agg wt = s_warp[i];
      s_warp[i] = tot;
      tot = combine(tot, wt);
    }
    ScanRec* rec = a.recs + 2 * (long long)tile;
    Agg pre = ident();
    if (tile == 0) {
      publish_rec(rec + 1, tot);
    } else {
      publish_rec(rec, tot);
      pre = look_back(a.recs, tile);
      publish_rec(rec + 1, combine(pre, tot));
    }
    s_pre = pre;
  }
  __syncthreads();
  Agg run = combine(combine(s_pre, s_warp[w]), ex);
  int cont = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long p = p0 + i;
    if (p >= a.B) break;
    const uint32_t o = ord[i];
    if (p >= n_real) {  // pad rows: the defaults
      if (MODE == SHIFT) {
        a.rn[o] = 0;
        a.f1[o] = qnan();
        a.b1[o] = 0;
        a.run[o] = 0.f;
      } else if (MODE == ARRIVAL) {
        a.rn[o] = 0;
        a.f1[o] = qnan();
        a.b1[o] = 0;
      } else {
        a.rank[o] = 0;
        a.dense[o] = 0;
        a.rank_has[o] = 0;
      }
      continue;
    }
    const bool h = (heads >> i) & 1u;
    const bool nv = (newvs >> i) & 1u;
    run = combine(run, element<MODE>(p, h, nv, v[i]));
    const int pos = (int)(p - run.start) + 1;
    if (MODE == SHIFT) {
      const uint32_t s = (uint32_t)(key[i] >> 32);
      const bool in = s < (uint32_t)a.C;
      const int32_t c0 = in ? a.cnt[s] : 0;
      const float a0 = in ? a.acc[s] : 0.f;
      a.rn[o] = c0 + pos;
      if (h) {
        const bool h0 = in && a.has[s] != 0;
        a.f1[o] = h0 ? a.last[s] : qnan();
        a.b1[o] = h0 ? 1 : 0;
        cont += h0 ? 1 : 0;
      } else {
        a.f1[o] = i > 0 ? v[i - 1] : pv;
        a.b1[o] = 1;
      }
      a.run[o] = a0 + (float)run.sum;
    } else if (MODE == ARRIVAL) {
      a.rn[o] = pos;
      bool same = false;
      float nxt = 0.f;
      if (p + 1 < n_real) {
        unsigned long long nk;
        if (i + 1 < SCAN_ITEMS) {
          nk = key[i + 1];
          nxt = v[i + 1];
        } else {
          nk = keys[p + 1];
          nxt = a.vals[pays[p + 1] & ~PAD_BIT];
        }
        same = (nk >> 32) == (key[i] >> 32);
      }
      a.f1[o] = same ? nxt : qnan();
      a.b1[o] = same ? 1 : 0;
    } else {
      const bool real = !isnan(v[i]);
      a.rank[o] = real ? run.vstart - run.start + 1 : 0;
      a.dense[o] = real ? (int32_t)run.sum : 0;
      a.rank_has[o] = real ? 1 : 0;
    }
  }
  if (MODE == SHIFT) {
    if (cont) atomicAdd(&s_cont, cont);
    __syncthreads();
    if (tid == 0 && s_cont) atomicAdd(a.continued, s_cont);
  }
}

// The shift's segment tails write the carry back: count, last value, has,
// running sum, from the row's outputs.
__global__ void carry_apply_kernel(const SortBufs sb, int B,
                                   const SortPlan* __restrict__ sp,
                                   const float* __restrict__ vals,
                                   const int32_t* __restrict__ rn,
                                   const float* __restrict__ run,
                                   int32_t* __restrict__ cnt,
                                   float* __restrict__ last,
                                   uint8_t* __restrict__ has,
                                   float* __restrict__ acc, int C) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_real = sp->n_real;
  if (p >= n_real) return;
  const unsigned long long* keys;
  const uint32_t* pays;
  sorted_by(sb, __popc(sp->plan[0]), &keys, &pays);
  const uint32_t s = (uint32_t)(keys[p] >> 32);
  if (s >= (uint32_t)C) return;
  if (p + 1 < n_real && (uint32_t)(keys[p + 1] >> 32) == s) return;
  const uint32_t o = pays[p] & ~PAD_BIT;
  cnt[s] = rn[o];
  last[s] = vals[o];
  has[s] = 1;
  acc[s] = run[o];
}

// ------------------------------------------------------------------ host

static inline bool pow2(int b) { return b > 0 && (b & (b - 1)) == 0; }

static inline size_t up16(size_t x) { return (x + 15) & ~(size_t)15; }

// The scratch of a call over B rows with `sorts` sorts (1: the shift, 2:
// segscan_sort): three key and payload buffers, then the zeroed part (the
// plan, the passes' look-back words, the scans' records).
struct Layout {
  size_t k[3], p[3], plan, status, recs, zero, zero_bytes, total;
  int rtiles, stiles, slots;  // a pass's tiles, a scan's tiles
};

static Layout layout(int B, int sorts) {
  Layout L;
  L.rtiles = blocks_of(B, RADIX_TILE);
  L.stiles = blocks_of(B, SCAN_TILE);
  L.slots = sorts == 1 ? 4 : 12;
  size_t off = 0;
  for (int i = 0; i < 3; ++i) {
    L.k[i] = off;
    off += (size_t)B * sizeof(unsigned long long);
  }
  for (int i = 0; i < 3; ++i) {
    L.p[i] = off;
    off += (size_t)B * sizeof(uint32_t);
  }
  L.zero = L.plan = up16(off);
  L.status = up16(L.plan + sizeof(SortPlan));
  L.recs = up16(L.status +
                (size_t)L.slots * L.rtiles * BINS * sizeof(uint32_t));
  L.total = up16(L.recs + (size_t)sorts * L.stiles * 2 * sizeof(ScanRec));
  L.zero_bytes = L.total - L.zero;
  return L;
}

static SortBufs bufs_of(char* s, const Layout& L) {
  SortBufs sb;
  sb.k0 = (const unsigned long long*)(s + L.k[0]);
  sb.p0 = (const uint32_t*)(s + L.p[0]);
  for (int i = 0; i < 2; ++i) {
    sb.k[i] = (unsigned long long*)(s + L.k[i + 1]);
    sb.p[i] = (uint32_t*)(s + L.p[i + 1]);
  }
  return sb;
}


extern "C" {

// slot_* / ts_*: device int32 (P*,); v*: device bool (P*,); resid:
// device bool read at i * rs_i + j * rs_j (rs_j 0 or 1), or null; mask:
// device uint32 (PL, ceil(PR / 32)), the packed mask.
int join_match(const int32_t* slot_l, const int32_t* ts_l, const uint8_t* vl,
               int PL, const int32_t* slot_r, const int32_t* ts_r,
               const uint8_t* vr, int PR, int lo, int hi, const uint8_t* resid,
               long long rs_i, long long rs_j, uint32_t* mask, void* stream) {
  if (PL < 0 || PR < 0 || rs_i < 0 || (rs_j != 0 && rs_j != 1))
    return (int)cudaErrorInvalidValue;
  if (PL == 0 || PR == 0) return (int)cudaSuccess;
  JoinArgs a;
  a.slot_l = slot_l;
  a.ts_l = ts_l;
  a.vl = vl;
  a.slot_r = slot_r;
  a.ts_r = ts_r;
  a.vr = vr;
  a.resid = resid;
  a.rs_i = rs_i;
  a.mask = mask;
  a.PL = PL;
  a.PR = PR;
  a.words = (PR + 31) / 32;
  a.strips = (a.words + JM_WORDS - 1) / JM_WORDS;
  a.lo = lo;
  a.empty = lo > hi;
  a.span = (uint32_t)hi - (uint32_t)lo;
  const int res = resid == nullptr ? 0 : rs_j == 0 ? 1 : 2;
  const int most = join_blocks(res);
  if (most < 0) return (int)cudaGetLastError();
  // rows a work item: each warp of the grid about one item
  const long long warps = (long long)most * (JM_THREADS / 32);
  long long per_strip = warps / a.strips;
  if (per_strip < 1) per_strip = 1;
  // (at least 8 rows, so that loading a strip stays a small part of it)
  long long rows = (PL + per_strip - 1) / per_strip;
  if (rows < 8) rows = 8;
  a.rows = (int)rows;
  a.items = (long long)a.strips * ((PL + rows - 1) / rows);
  const long long need = (a.items * 32 + JM_THREADS - 1) / JM_THREADS;
  const int blocks = (int)(need < most ? need : most);
  cudaStream_t st = (cudaStream_t)stream;
  if (res == 0)
    join_match_kernel<0><<<blocks, JM_THREADS, 0, st>>>(a);
  else if (res == 1)
    join_match_kernel<1><<<blocks, JM_THREADS, 0, st>>>(a);
  else
    join_match_kernel<2><<<blocks, JM_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Bytes of scratch segscan_shift (sorts 1) or segscan_sort (sorts 2) takes
// over B rows; -1 for a B they refuse.
long long segscan_scratch_bytes(int B, int sorts) {
  if (!pow2(B) || B > MAX_B || sorts < 1 || sorts > 2) return -1;
  return (long long)layout(B, sorts).total;
}

// slots / vals / valid: device (B,) int32 / float32 / bool, B a power of
// two; cnt / last / has / acc: the carry, device (C,), updated in place;
// scratch: segscan_scratch_bytes(B, 1) device bytes; rn / lag / lhas /
// run: outputs (B,); continued: one device int32.
int segscan_shift(const int32_t* slots, const float* vals,
                  const uint8_t* valid, int B, int32_t* cnt, float* last,
                  uint8_t* has, float* acc, int C, void* scratch, int32_t* rn,
                  float* lag, uint8_t* lhas, float* run, int32_t* continued,
                  void* stream) {
  if (!pow2(B) || B > MAX_B || C < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Layout L = layout(B, 1);
  char* s = (char*)scratch;
  cudaError_t err = cudaMemsetAsync(s + L.zero, 0, L.zero_bytes, st);
  if (err != cudaSuccess) return (int)err;
  const SortBufs sb = bufs_of(s, L);
  SortPlan* sp = (SortPlan*)(s + L.plan);
  radix_hist_kernel<false><<<hist_blocks(B), SEG_THREADS, 0, st>>>(
      SegSrc<false>{slots, vals, valid}, B,
      (unsigned long long*)(s + L.k[0]), (uint32_t*)(s + L.p[0]), sp,
      continued);
  radix_passes(sb, B, sp, (uint32_t*)(s + L.status), L.rtiles, 0, 4,
               PLACES, 0, st);
  ScanArgs a = {};
  a.sb = sb;
  a.B = B;
  a.sp = sp;
  a.sort = 0;
  a.recs = (ScanRec*)(s + L.recs);
  a.ticket = &sp->scan_ticket[0];
  a.vals = vals;
  a.cnt = cnt;
  a.last = last;
  a.has = has;
  a.acc = acc;
  a.C = C;
  a.continued = continued;
  a.rn = rn;
  a.f1 = lag;
  a.b1 = lhas;
  a.run = run;
  seg_scan_kernel<SHIFT><<<L.stiles, SEG_THREADS, 0, st>>>(a);
  carry_apply_kernel<<<blocks_of(B, 256), 256, 0, st>>>(
      sb, B, sp, vals, rn, run, cnt, last, has, acc, C);
  return (int)cudaGetLastError();
}

// seg / vals / valid: device (B,) int32 / float32 / bool, B a power of
// two; scratch: segscan_scratch_bytes(B, 2) device bytes; outputs (B,):
// rn int32, lead float32, lead_has bool, rank int32, dense int32,
// rank_has bool.
int segscan_sort(const int32_t* seg, const float* vals, const uint8_t* valid,
                 int B, void* scratch, int32_t* rn, float* lead,
                 uint8_t* lead_has, int32_t* rank, int32_t* dense,
                 uint8_t* rank_has, void* stream) {
  if (!pow2(B) || B > MAX_B) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Layout L = layout(B, 2);
  char* s = (char*)scratch;
  cudaError_t err = cudaMemsetAsync(s + L.zero, 0, L.zero_bytes, st);
  if (err != cudaSuccess) return (int)err;
  const SortBufs sb = bufs_of(s, L);
  SortPlan* sp = (SortPlan*)(s + L.plan);
  uint32_t* status = (uint32_t*)(s + L.status);
  ScanRec* recs = (ScanRec*)(s + L.recs);
  radix_hist_kernel<true><<<hist_blocks(B), SEG_THREADS, 0, st>>>(
      SegSrc<true>{seg, vals, valid}, B, (unsigned long long*)(s + L.k[0]),
      (uint32_t*)(s + L.p[0]), sp, nullptr);
  // arrival order: the segment's places only
  radix_passes(sb, B, sp, status, L.rtiles, 0, 4, PLACES, 0, st);
  ScanArgs a = {};
  a.sb = sb;
  a.B = B;
  a.sp = sp;
  a.sort = 0;
  a.recs = recs;
  a.ticket = &sp->scan_ticket[0];
  a.vals = vals;
  a.rn = rn;
  a.f1 = lead;
  a.b1 = lead_has;
  seg_scan_kernel<ARRIVAL><<<L.stiles, SEG_THREADS, 0, st>>>(a);
  // value order: the value's places, then the segment's
  radix_passes(sb, B, sp, status, L.rtiles, 1, 0, PLACES, 4, st);
  a.sort = 1;
  a.recs = recs + 2 * (size_t)L.stiles;
  a.ticket = &sp->scan_ticket[1];
  a.rank = rank;
  a.dense = dense;
  a.rank_has = rank_has;
  seg_scan_kernel<VALUE><<<L.stiles, SEG_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
