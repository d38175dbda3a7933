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
// writes back to the identity (only the touched elements).

#include <type_traits>

#include "fold.cuh"
#include "groupby_common.cuh"
#include "sketch_common.cuh"
#include "slot_type.cuh"

#define MAX_MERGE 16
enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };

struct MergeTab {  // every component: state, partials, one pane's floats
  int n;
  float* state[MAX_MERGE];
  float* part[MAX_MERGE];
  long long len[MAX_MERGE];
  int op[MAX_MERGE];
  float ident[MAX_MERGE];
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

// One thread per element of one pane's worth of partials (P' panes of
// C·K_c·W floats), grid-stride, each component in turn: the R row
// shards' partials reduced in r order by the component's op, combined
// into the state (pane `pane` when P' = 1, pane p for p < P' otherwise),
// and every partial element that left the identity written back to it.
// The touch counts: the R uint32 counts of a slot summed into touch[slot]
// (wrapping modulo 2^32, as the fold's atomicAdd does) and zeroed.
__global__ void shard_merge_kernel(MergeTab mt, int R, int P, int pane,
                                   unsigned int* __restrict__ touch,
                                   unsigned int* __restrict__ touch_part,
                                   int C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int j = 0; j < mt.n; ++j) {
    const int64_t total = (int64_t)P * mt.len[j];
    float* part = mt.part[j];
    float* dst = mt.state[j] + (P == 1 ? (int64_t)pane * mt.len[j] : 0);
    const int op = mt.op[j];
    const unsigned int ident = __float_as_uint(mt.ident[j]);
    for (int64_t e = first; e < total; e += stride) {
      float acc = part[e];
      if (__float_as_uint(acc) != ident) part[e] = mt.ident[j];
      for (int r = 1; r < R; ++r) {
        const float v = part[(int64_t)r * total + e];
        if (__float_as_uint(v) != ident) part[(int64_t)r * total + e] =
            mt.ident[j];
        acc = merge_op(op, acc, v);
      }
      dst[e] = merge_op(op, dst[e], acc);
    }
  }
  if (touch == nullptr) return;
  for (int64_t s = first; s < C; s += stride) {
    unsigned int add = 0u;
    for (int r = 0; r < R; ++r) {
      const unsigned int v = touch_part[(int64_t)r * C + s];
      if (v != 0u) {
        add += v;
        touch_part[(int64_t)r * C + s] = 0u;
      }
    }
    if (add != 0u) touch[s] += add;
  }
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
  mt.n = n;
  long long most = touch != nullptr ? C : 0;
  for (int j = 0; j < n; ++j) {
    mt.state[j] = state_ptrs[j];
    mt.part[j] = part_ptrs[j];
    mt.len[j] = lens[j];
    mt.op[j] = ops[j];
    mt.ident[j] = idents[j];
    if ((long long)P * lens[j] > most) most = (long long)P * lens[j];
  }
  if (most == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (most + threads - 1) / threads;
  shard_merge_kernel<<<blocks < 8192 ? (int)blocks : 8192, threads, 0,
                       (cudaStream_t)stream>>>(mt, R, P, pane, touch,
                                               touch_part, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
