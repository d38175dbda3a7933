// Sharded group-by kernels of a rule on a (rows, keys) device mesh, for
// Hopper (sm_90a), where every device of the mesh is one card.
//
// Built by ekuiper_tpu_torch/ops/kernels.py into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes). Every entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launch.
//
// They replace the reference's two shard_map fold programs
// (ekuiper_tpu/parallel/sharded.py):
//
// sharded_fold        replaces _build_fold -> local_fold (208, 221-331):
//                     row shard r (rows [r·m, (r+1)·m) of the micro-batch,
//                     m = micro_batch / R) folds its rows whose slot lies
//                     in key shard k's range [k·c, (k+1)·c) into a fresh
//                     identity partial: act, n, s1, s2, mn, mx, the touch
//                     column's uint32 count and the hll (rho max into
//                     register h1 & 255) and hist (log-bin add) branches
//                     (299-314), every shard and column in ONE launch
//                     (csrc/fold.cuh); with a per-row pane vector,
//                     _build_fold_vec -> local_fold (353, 371-474)
// shard_merge         the psum / pmin / pmax of every component over the
//                     "rows" axis and its add / min / max into the state
//                     (313-323, 403-407, 452-460)
//
// Layout on one card. The state is the single-chip layout (csrc/
// groupby_common.cuh): comp (P, C, K_c[, W]), act (P, C), touch (C,)
// uint32, C = K·c. Key shard k's slice of it is the contiguous slot run
// [k·c, (k+1)·c), so a row's global slot indexes its key shard's partial
// directly: no key axis of its own. The partials hold one copy per row
// shard: comp (R·P', C, K_c[, W]), act (R·P', C), touch (R, C), P' = 1
// for the scalar pane or P for the pane vector, row shard r's block at
// r·P'. They start at each component's identity (0; +inf for mn, -inf
// for mx), and shard_merge writes them back to it, so the next chunk
// needs no fill. All the (r, k) shards of a chunk fold in ONE launch, and
// merge in one more: not R·K launches. The partial-then-merge structure
// is the reference's (one card could add straight into the state): its
// merge adds the R partials in r order, so the sums round as it shows,
// and the partials are what a cross-card version would all-reduce.
//
// Bound on an H100: bytes. At the flagship shape (2x4 mesh, 16,384 slots,
// 65,536 rows, four scalar columns and a touch column) the fold moves
// ~3 MB (each row's values, masks and slot, the touched partial lines),
// ~0.9 us at 3.35 TB/s; each row also makes one atomic update per state
// column, as the single-chip fold does (csrc/fold.cuh). The merge reads the
// R partials once and reads and writes one pane of the state (all P panes
// for the pane vector): (R + 2)·P'·C·width floats, plus the partials it
// writes back to the identity (only the touched elements). Its design:
// every component's merged elements (P'·C·K_c[·W] floats) and the touch
// column's C counts form one flat index space of 16-byte units, each
// component's run of blocks starting at an offset in the launch's table
// (a block finds its component there), so the components merge in
// parallel, in one launch sized to the space. A thread takes one unit
// (four floats, or four uint32 counts), with the R partials' loads issued
// together (eight at a time) and merged in r order, as the reference's
// psum adds them; a unit that a pointer's 16-byte phase or a length cuts
// (the run's head and tail, or a component whose partials lie at another
// phase than its state) is merged element by element, by the same ops.

#include <string.h>

#include <type_traits>

#include "fold.cuh"
#include "groupby_common.cuh"
#include "sketch_common.cuh"
#include "slot_type.cuh"

#define MAX_MERGE 16
#define MERGE_THREADS 256
#define MERGE_LOADS 8  // partials a thread loads at once
enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2, OP_TOUCH = 3 };

// Every component of one merge, the touch column last: where its merged
// elements go in the state and its row shard 0's partial (shard r's at r
// · len), the elements a row shard holds, its first block in the flat
// space, the state's phase in elements past a 16-byte boundary (unit u
// is elements [4u - head, 4u - head + 4), so a whole unit is aligned),
// whether the partials share the state's phase (then a whole unit is one
// float4 each), its op and its identity's bits.
struct MergeTab {
  int n;
  void* state[MAX_MERGE + 1];
  void* part[MAX_MERGE + 1];
  long long len[MAX_MERGE + 1];
  long long block0[MAX_MERGE + 2];
  int head[MAX_MERGE + 1];
  int vec[MAX_MERGE + 1];
  int op[MAX_MERGE + 1];
  uint32_t ident[MAX_MERGE + 1];
};

// The one-launch sharded fold (#23, #24): csrc/fold.cuh fold_body over
// the partials, row i in row shard i / m, its partial pane r·P' + its pane
// (pane_vec[i], or 0), its partial slot its global slot; a slot outside
// the mesh's K·c slots is in no key shard and is dropped (the reference's
// in_range mask); touch counts per row shard, pane-independent.
template <typename SlotT>
__global__ void __launch_bounds__(FOLD_THREADS)
    sharded_fold_kernel(const __grid_constant__ FoldChunk a) {
  fold_body<SlotT>(a);
}

__device__ __forceinline__ float merge_op(int op, float a, float b) {
  if (op == OP_MIN) return fminf(a, b);
  if (op == OP_MAX) return fmaxf(a, b);
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 merge4(int op, float4 a, float4 b) {
  return make_float4(merge_op(op, a.x, b.x), merge_op(op, a.y, b.y),
                     merge_op(op, a.z, b.z), merge_op(op, a.w, b.w));
}

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One element e of component j: the R partials in r order (a float's by
// its op, the touch counts added modulo 2^32), combined into the state,
// each partial that left the identity written back to it.
__device__ __forceinline__ void merge_one(const MergeTab& mt, int j, int R,
                                          long long e) {
  const long long len = mt.len[j];
  const uint32_t id = mt.ident[j];
  uint32_t* part = (uint32_t*)mt.part[j] + e;
  uint32_t* dst = (uint32_t*)mt.state[j] + e;
  if (mt.op[j] == OP_TOUCH) {
    uint32_t add = 0u;
    for (int r = 0; r < R; ++r) {
      const uint32_t v = part[r * len];
      if (v != 0u) {
        add += v;
        part[r * len] = 0u;
      }
    }
    if (add != 0u) *dst += add;
    return;
  }
  const int op = mt.op[j];
  float acc = 0.f;
  for (int r = 0; r < R; ++r) {
    const uint32_t v = part[r * len];
    if (v != id) part[r * len] = id;
    acc = r == 0 ? __uint_as_float(v) : merge_op(op, acc, __uint_as_float(v));
  }
  *dst = __float_as_uint(merge_op(op, __uint_as_float(*dst), acc));
}

__device__ __forceinline__ bool same4(float4 v, uint32_t b) {
  return __float_as_uint(v.x) == b && __float_as_uint(v.y) == b &&
         __float_as_uint(v.z) == b && __float_as_uint(v.w) == b;
}

// One 16-byte unit of a float component at element e (past the state's
// head, so every pointer is on a 16-byte boundary): merge_one's ops four
// elements at a time, the R partials' loads issued MERGE_LOADS at a time.
__device__ __forceinline__ void merge_unit(const MergeTab& mt, int j, int R,
                                           long long e) {
  const int op = mt.op[j];
  const uint32_t id = mt.ident[j];
  const float fid = __uint_as_float(id);
  const long long step = mt.len[j] / 4;  // a row shard, in units
  float4* part = reinterpret_cast<float4*>((float*)mt.part[j] + e);
  float4* dst = reinterpret_cast<float4*>((float*)mt.state[j] + e);
  const float4 d = *dst;
  float4 acc = make_float4(fid, fid, fid, fid);
  for (int r0 = 0; r0 < R; r0 += MERGE_LOADS) {
    float4 v[MERGE_LOADS];
#pragma unroll
    for (int q = 0; q < MERGE_LOADS; ++q)
      if (r0 + q < R) v[q] = __ldcs(part + (r0 + q) * step);
#pragma unroll
    for (int q = 0; q < MERGE_LOADS; ++q) {
      if (r0 + q < R) {
        if (!same4(v[q], id))
          part[(r0 + q) * step] = make_float4(fid, fid, fid, fid);
        acc = r0 + q == 0 ? v[q] : merge4(op, acc, v[q]);
      }
    }
  }
  *dst = merge4(op, d, acc);
}

// The touch column's unit: four slots' R counts added, zeroed, and added
// into the state where any is not 0.
__device__ __forceinline__ void touch_unit(const MergeTab& mt, int R,
                                           int j, long long e) {
  const long long step = mt.len[j] / 4;
  uint4* part = reinterpret_cast<uint4*>((uint32_t*)mt.part[j] + e);
  uint4* dst = reinterpret_cast<uint4*>((uint32_t*)mt.state[j] + e);
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int r0 = 0; r0 < R; r0 += MERGE_LOADS) {
    uint4 v[MERGE_LOADS];
#pragma unroll
    for (int q = 0; q < MERGE_LOADS; ++q)
      if (r0 + q < R) v[q] = __ldcs(part + (r0 + q) * step);
#pragma unroll
    for (int q = 0; q < MERGE_LOADS; ++q) {
      if (r0 + q < R && (v[q].x | v[q].y | v[q].z | v[q].w) != 0u) {
        part[(r0 + q) * step] = make_uint4(0u, 0u, 0u, 0u);
        acc = add4(acc, v[q]);
      }
    }
  }
  if ((acc.x | acc.y | acc.z | acc.w) != 0u) *dst = add4(*dst, acc);
}

// The merge of every component (#23's psum / pmin / pmax and the pane
// combine, #24's over every pane): a thread a 16-byte unit of the flat
// space, its block's component from the table.
__global__ void __launch_bounds__(MERGE_THREADS)
    shard_merge_kernel(const __grid_constant__ MergeTab mt, int R) {
  int j = 0;
  while (j + 1 < mt.n && mt.block0[j + 1] <= (long long)blockIdx.x) ++j;
  const long long u =
      ((long long)blockIdx.x - mt.block0[j]) * MERGE_THREADS + threadIdx.x;
  const long long e = 4 * u - mt.head[j];
  const long long len = mt.len[j];
  if (e >= len) return;
  if (mt.vec[j] && e >= 0 && e + 4 <= len) {
    if (mt.op[j] == OP_TOUCH)
      touch_unit(mt, R, j, e);
    else
      merge_unit(mt, j, R, e);
    return;
  }
  for (long long x = e < 0 ? 0 : e; x < e + 4 && x < len; ++x)
    merge_one(mt, j, R, x);
}

extern "C" {

// base: device uint8 (N,); V / M: device (S, N); slots: device (N,) of
// uint16 if slot_u16, else int32; m: rows a row shard holds; R: row
// shards; pane_vec: device uint8 (N,) per-row panes, or null for pane 0 of
// each row shard's block; P: panes a block holds (P'); c: slots a key
// shard holds; K: key shards. colmap, widemap: as groupby_fold's (no hh
// columns: the mesh refuses heavy_hitters), over the partials
// (R·P', K·c, k[, W]); comp_ptrs / comp_k, wide_ptrs / wide_k: the
// partials' components; act: the partials' act (R·P', K·c); touch: the
// touch partial (R, K·c), or null.
int sharded_fold(const uint8_t* base, const float* V, const uint8_t* M,
                 const void* slots, int slot_u16, int N, int m, int R,
                 const uint8_t* pane_vec, int P, int c, int K,
                 const int32_t* colmap, int ncols, const int32_t* widemap,
                 int nwide, float* const* comp_ptrs, const int32_t* comp_k,
                 float* act, unsigned int* touch, float* const* wide_ptrs,
                 const int32_t* wide_k, const float* hist_consts,
                 void* stream) {
  FoldChunk a{};
  if (!fold_cols(colmap, ncols, widemap, nwide, comp_k[C_N], &a) ||
      a.hh.n > 0 || N < 0 ||
      m < 1 || R < 1 || P < 1 || c < 1 || K < 1 ||
      (long long)c * K * R > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  a.base = base;
  a.V = V;
  a.M = M;
  a.slots = slots;
  a.pane_vec = pane_vec;
  a.N = N;
  a.m = m;
  a.R_sh = R;
  a.pane = 0;
  a.Pp = P;
  a.C = c * K;
  a.cp = make_comps(comp_ptrs, comp_k);
  a.act = act;
  a.touch = touch;
  a.w = make_wide(wide_ptrs, wide_k);
  a.hc = make_hc(hist_consts);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  with_slot_type(slots, slot_u16, [&](auto s) {
    using SlotT = std::remove_const_t<std::remove_pointer_t<decltype(s)>>;
    err = launch_fold(sharded_fold_kernel<SlotT>, a, st);
  });
  return (int)err;
}

// state_ptrs / part_ptrs / lens / ops / idents: host arrays of n
// components (the state's and the partials' device pointers, the floats
// of one pane, OP_ADD / OP_MIN / OP_MAX, the identity). R: row shards; P:
// panes a partial block holds (P'); pane: the state pane of a P' = 1
// merge. touch / touch_part: the state's uint32 (C,) touch column and
// its (R, C) partial, or null.
int shard_merge(float* const* state_ptrs, float* const* part_ptrs,
                const long long* lens, const int32_t* ops,
                const float* idents, int n, int R, int P, int pane,
                unsigned int* touch, unsigned int* touch_part, int C,
                void* stream) {
  if (n < 0 || n > MAX_MERGE || R < 1 || P < 1 || C < 0 ||
      (touch == nullptr) != (touch_part == nullptr))
    return (int)cudaErrorInvalidValue;
  MergeTab mt;
  mt.n = 0;
  long long blocks = 0;
  for (int j = 0; j <= n; ++j) {
    void* dst;
    void* part;
    long long len;
    int op;
    uint32_t ident;
    if (j < n) {
      len = (long long)P * lens[j];
      dst = state_ptrs[j] + (P == 1 ? (long long)pane * lens[j] : 0);
      part = part_ptrs[j];
      op = ops[j];
      ident = 0u;
      memcpy(&ident, &idents[j], sizeof ident);
    } else {
      if (touch == nullptr) break;
      len = C;
      dst = touch;
      part = touch_part;
      op = OP_TOUCH;
      ident = 0u;
    }
    if (len <= 0) continue;
    const uintptr_t d = (uintptr_t)dst, p = (uintptr_t)part;
    const int k = mt.n++;
    mt.state[k] = dst;
    mt.part[k] = part;
    mt.len[k] = len;
    mt.op[k] = op;
    mt.ident[k] = ident;
    // float4 units where every partial shares the state's 16-byte phase
    mt.vec[k] = (d & 15u) == (p & 15u) && (R == 1 || len % 4 == 0);
    mt.head[k] = mt.vec[k] ? (int)((d & 15u) / 4u) : 0;
    mt.block0[k] = blocks;
    const long long units = (len + mt.head[k] + 3) / 4;
    blocks += (units + MERGE_THREADS - 1) / MERGE_THREADS;
  }
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mt.block0[mt.n] = blocks;
  shard_merge_kernel<<<(int)blocks, MERGE_THREADS, 0,
                       (cudaStream_t)stream>>>(mt, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
