// Routes for the scalar body of the one-launch fold (#1, csrc/fold.cuh),
// timed against each other by fold_routes.py on a card. Not part of the
// port: the port's kernels live in ekuiper_tpu_torch/csrc/.
//
//   probe_packed   the port's fold body (csrc/fold.cuh) as it was with
//                  the column table as a device array of packed words,
//                  copied into shared memory by each block, and one
//                  atomic a count column (the port now passes the maps
//                  in the launch's parameters and adds a slot's counts as
//                  vector atomics)
//   probe_scan     scan-and-keep-range: CTA b owns slots [b NS, (b+1) NS)
//                  of the pane, reads every row's slot, accumulates the
//                  rows of its range with shared-memory atomics and writes
//                  each touched state word once (no global atomic)
//   probe_cluster  the same ownership across a thread-block cluster of CL
//                  CTAs: the cluster owns CL NS slots, each CTA scans 1/CL
//                  of the rows and adds a row into its owner's shared
//                  memory through distributed shared memory
//
// The two owner routes fold act and the scalar columns into one scalar
// pane (no touch column, no pane vector, no sketch column). Semantics are
// the atomic route's: a row off `base` or with a slot outside [0, C) is
// dropped; n and act are exact counts; mn / mx keep -0 below +0; s1 / s2
// round in another order.
//
// Build (fold_routes.py does it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I ekuiper_tpu_torch/csrc -o lib.so fold_routes.cu

#include <cooperative_groups.h>

#include <type_traits>

#include "fold.cuh"
#include "slot_type.cuh"

namespace cg = cooperative_groups;

#define OWN_THREADS 512

// The removed packed column table: one word a column, comp | k << 8 |
// spec << 16, in a device array that each block copies into shared
// memory; the launch's parameters (FoldChunkP, ~250 bytes) carry its
// pointer instead of the column maps; one atomic a column, counts too.
// Otherwise csrc/fold.cuh's body.
struct PackedCols {
  const uint32_t* c;
  int n;
  __device__ int comp(int j) const { return (int)(c[j] & 0xffu); }
  __device__ int k(int j) const { return (int)((c[j] >> 8) & 0xffu); }
  __device__ int spec(int j) const { return (int)(c[j] >> 16); }
};

struct FoldChunkP {
  const uint8_t* base;
  const float* V;
  const uint8_t* M;
  const void* slots;
  const uint8_t* pane_vec;
  int N, m, R_sh, pane, Pp, C;
  const uint32_t* cols;
  int n_scalar, n_wide, n_hh;
  Comps cp;
  float* act;
  unsigned int* touch;
  Wide w;
  HistConsts hc;
  int nb_s, nb_w, nb_h;
};

__device__ __forceinline__ int packed_pane(const FoldChunkP& a, int i) {
  const int p = a.pane_vec != nullptr ? (int)a.pane_vec[i] : a.pane;
  return (p < 0 || p >= a.Pp) ? -1 : p;
}

template <typename SlotT>
__global__ void __launch_bounds__(FOLD_THREADS)
    probe_packed_kernel(const __grid_constant__ FoldChunkP a) {
  __shared__ uint32_t s_cols[2 * MAX_COLS];
  for (int j = threadIdx.x; j < a.n_scalar + a.n_wide + a.n_hh;
       j += FOLD_THREADS)
    s_cols[j] = a.cols[j];
  __syncthreads();
  const PackedCols sc{s_cols, a.n_scalar};
  const PackedCols wc{s_cols + a.n_scalar, a.n_wide};
  const PackedCols hc{s_cols + a.n_scalar + a.n_wide, a.n_hh};
  const SlotT* slots = static_cast<const SlotT*>(a.slots);
  const int b = blockIdx.x;
  if (b < a.nb_s) {
    for (int i = b * FOLD_THREADS + threadIdx.x; i < a.N;
         i += a.nb_s * FOLD_THREADS) {
      if (!a.base[i]) continue;
      const int r = i / a.m;
      const int slot = (int)slots[i];
      if (r >= a.R_sh || slot < 0 || slot >= a.C) continue;
      if (a.touch != nullptr)
        atomicAdd(a.touch + (int64_t)r * a.C + slot, 1u);
      const int p = packed_pane(a, i);
      if (p < 0) continue;
      const int64_t pc = ((int64_t)r * a.Pp + p) * a.C + slot;
      atomicAdd(a.act + pc, 1.0f);
      for (int j = 0; j < sc.n; ++j) {
        const int64_t at = (int64_t)sc.spec(j) * a.N + i;
        if (!a.M[at]) continue;
        const int comp = sc.comp(j);
        float* dst = a.cp.p[comp] + pc * a.cp.k[comp] + sc.k(j);
        const float v = a.V[at];
        switch (comp) {
          case C_N: atomicAdd(dst, 1.0f); break;
          case C_S1: atomicAdd(dst, v); break;
          case C_S2: atomicAdd(dst, __fmul_rn(v, v)); break;
          case C_MN: atomic_min_f32(dst, v); break;
          default: atomic_max_f32(dst, v); break;
        }
      }
    }
    return;
  }
  if (b < a.nb_s + a.nb_w) {
    const int first = (b - a.nb_s) * FOLD_THREADS + threadIdx.x;
    for (int i = first; i < a.N; i += a.nb_w * FOLD_THREADS) {
      const int r = i / a.m;
      const int slot = (int)slots[i];
      const int p = packed_pane(a, i);
      if (r >= a.R_sh || slot < 0 || slot >= a.C || p < 0) continue;
      const int64_t pc = ((int64_t)r * a.Pp + p) * a.C + slot;
      for (int j = 0; j < wc.n; ++j) {
        const int64_t at = (int64_t)wc.spec(j) * a.N + i;
        if (!a.M[at]) continue;
        const int comp = wc.comp(j);
        const int W = kWideW[comp];
        float* dst = a.w.p[comp] + (pc * a.w.k[comp] + wc.k(j)) * W;
        const float v = a.V[at];
        if (comp == W_HLL) {
          float rho;
          const int reg = hll_reg_rho(v, &rho);
          if (rho > 0.0f) atomic_max_f32(dst + reg, rho);
        } else if (comp == W_HIST) {
          atomicAdd(dst + hist_bin(v, a.hc), 1.0f);
        }
      }
    }
    return;
  }
  const unsigned n = 2u * (unsigned)a.N;
  const unsigned first = (unsigned)(b - a.nb_s - a.nb_w) * FOLD_THREADS +
                         threadIdx.x;
  for (unsigned q = first; q < n; q += (unsigned)a.nb_h * FOLD_THREADS) {
    const int i = (int)(q >> 1), d = (int)(q & 1u);
    const int slot = (int)slots[i];
    const int p = packed_pane(a, i);
    if (slot < 0 || slot >= a.C || p < 0) continue;
    const long long key = (long long)p * a.C + slot;
    for (int j = 0; j < hc.n; ++j) {
      const int64_t at = (int64_t)hc.spec(j) * a.N + i;
      if (!a.M[at]) continue;
      fold_hh_cell(a.w.p[W_HH], key, a.w.k[W_HH], hc.k(j), d,
                   (uint32_t)(long long)a.V[at]);
    }
  }
}

struct OwnArgs {
  const uint8_t* base;
  const float* V;
  const uint8_t* M;
  const void* slots;
  int R, pane, C;
  ColMap cm;
  Comps cp;
  float* act;
  // the staged routes' phases, or null: a CTA's six ns counts (init,
  // scans and appends, row adds, the wait after them, the write-back,
  // all), from thread 0's %globaltimer
  unsigned long long* phase;
};

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// min / max order with -0 below +0: the float's bits as a monotone int
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float init_of(int comp) {
  return comp == C_MN ? f32_inf() : (comp == C_MX ? -f32_inf() : 0.0f);
}

// Shared-memory layout of an owner of ns slots: act (ns floats), then one
// run of ns floats a column, then one touched byte a (column, slot).
template <int NS>
__device__ __forceinline__ void own_init(float* acc, uint8_t* touched,
                                         const ColMap& cm) {
  for (int d = threadIdx.x; d < NS; d += blockDim.x) acc[d] = 0.0f;
  for (int q = threadIdx.x; q < cm.n * NS; q += blockDim.x) {
    acc[NS + q] = init_of(cm.comp[q / NS]);
    touched[q] = 0;
  }
}

// Row i into an owner's accumulators at offset d (acc / touched: local or
// another CTA's shared memory).
template <int NS>
__device__ __forceinline__ void own_add(const OwnArgs& s, int i, int d,
                                        float* acc, uint8_t* touched) {
  atomicAdd(acc + d, 1.0f);
  for (int j = 0; j < s.cm.n; ++j) {
    const int64_t at = (int64_t)s.cm.spec[j] * s.R + i;
    if (!s.M[at]) continue;
    const float v = s.V[at];
    float* dst = acc + (1 + j) * NS + d;
    touched[j * NS + d] = 1;
    switch (s.cm.comp[j]) {
      case C_N: atomicAdd(dst, 1.0f); break;
      case C_S1: atomicAdd(dst, v); break;
      case C_S2: atomicAdd(dst, __fmul_rn(v, v)); break;
      case C_MN: atomic_min_f32(dst, v); break;
      default: atomic_max_f32(dst, v); break;
    }
  }
}

// Each touched state word of slots [lo, lo + NS) written once.
template <int NS>
__device__ __forceinline__ void own_write(const OwnArgs& s, int lo,
                                          const float* acc,
                                          const uint8_t* touched) {
  for (int d = threadIdx.x; d < NS; d += blockDim.x) {
    const int slot = lo + d;
    if (slot >= s.C || acc[d] == 0.0f) continue;
    const int64_t pc = (int64_t)s.pane * s.C + slot;
    s.act[pc] += acc[d];
    for (int j = 0; j < s.cm.n; ++j) {
      if (!touched[j * NS + d]) continue;
      const int comp = s.cm.comp[j];
      float* dst = s.cp.p[comp] + pc * s.cp.k[comp] + s.cm.k[j];
      const float a = acc[(1 + j) * NS + d], o = *dst;
      if (comp == C_MN)
        *dst = order_key(a) < order_key(o) ? a : o;
      else if (comp == C_MX)
        *dst = order_key(a) > order_key(o) ? a : o;
      else
        *dst = o + a;
    }
  }
}

// Calls take(i, slot) for every row of [v0 * VEC, v1 * VEC) (and of the
// tail past the last whole vector when `tail`), slots read 16 bytes a load.
template <typename SlotT, typename Take>
__device__ __forceinline__ void scan_rows(const SlotT* slots, int R, int v0,
                                          int v1, bool tail, Take take) {
  constexpr int VEC = 16 / sizeof(SlotT);
  const uint4* vs = reinterpret_cast<const uint4*>(slots);
  for (int v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
    const uint4 raw = vs[v];
    const SlotT* sl = reinterpret_cast<const SlotT*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) take(v * VEC + e, (int)sl[e]);
  }
  if (tail)
    for (int i = (R / VEC) * VEC + threadIdx.x; i < R; i += blockDim.x)
      take(i, (int)slots[i]);
}

template <typename SlotT, int NS>
__global__ void __launch_bounds__(OWN_THREADS)
    probe_scan_kernel(const __grid_constant__ OwnArgs s) {
  extern __shared__ __align__(16) unsigned char own_smem[];
  float* acc = reinterpret_cast<float*>(own_smem);
  uint8_t* touched =
      own_smem + sizeof(float) * (size_t)(1 + s.cm.n) * NS;
  const int lo = blockIdx.x * NS;
  own_init<NS>(acc, touched, s.cm);
  __syncthreads();
  constexpr int VEC = 16 / sizeof(SlotT);
  scan_rows(static_cast<const SlotT*>(s.slots), s.R, 0, s.R / VEC, true,
            [&](int i, int slot) {
              const unsigned d = (unsigned)(slot - lo);
              if (d < (unsigned)NS && slot < s.C && s.base[i])
                own_add<NS>(s, i, (int)d, acc, touched);
            });
  __syncthreads();
  own_write<NS>(s, lo, acc, touched);
}

template <typename SlotT, int NS, int CL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(OWN_THREADS)
    probe_cluster_kernel(const __grid_constant__ OwnArgs s) {
  extern __shared__ __align__(16) unsigned char own_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  float* acc = reinterpret_cast<float*>(own_smem);
  const size_t acc_bytes = sizeof(float) * (size_t)(1 + s.cm.n) * NS;
  uint8_t* touched = own_smem + acc_bytes;
  const int rank = (int)cluster.block_rank();
  const int c_lo = (blockIdx.x / CL) * CL * NS;
  own_init<NS>(acc, touched, s.cm);
  cluster.sync();
  constexpr int VEC = 16 / sizeof(SlotT);
  const int nvec = s.R / VEC;
  const int per = (nvec + CL - 1) / CL;
  const int v0 = min(rank * per, nvec), v1 = min(v0 + per, nvec);
  scan_rows(static_cast<const SlotT*>(s.slots), s.R, v0, v1, rank == CL - 1,
            [&](int i, int slot) {
              const unsigned d = (unsigned)(slot - c_lo);
              if (d < (unsigned)(CL * NS) && slot < s.C && s.base[i]) {
                unsigned char* owner = cluster.map_shared_rank(
                    own_smem, d / NS);
                own_add<NS>(s, i, (int)(d % NS),
                            reinterpret_cast<float*>(owner),
                            owner + acc_bytes);
              }
            });
  cluster.sync();
  own_write<NS>(s, c_lo + rank * NS, acc, touched);
}

// The staged owner routes: rows are taken in rounds of OWN_THREADS *
// STAGE_VECS slot vectors. A round's loads are issued together; the rows
// of the owner's range are appended to a list in shared memory (row <<
// 10 | offset); then each thread takes list entries, loads the row's
// base, masks and values together (at most OWN_COLS columns) and adds
// them into the owner's accumulators. A warp appends its rows with one
// shared-memory atomic. The inline routes above load a row's masks and
// values one after another inside the warp that found it, so a warp
// waits on those loads once for each such row.
#define STAGE_VECS 2
#define OWN_COLS 16

// Appends val to list where hit, a warp at a time: one shared-memory
// atomic on the count a warp. Every lane of the warp calls it.
__device__ __forceinline__ void warp_append(bool hit, int val, int* list,
                                            int* count) {
  const unsigned mask = __ballot_sync(0xffffffffu, hit);
  if (mask == 0u) return;
  const int lane = (int)(threadIdx.x & 31u), leader = __ffs(mask) - 1;
  int pos = 0;
  if (lane == leader) pos = atomicAdd(count, __popc(mask));
  pos = __shfl_sync(0xffffffffu, pos, leader);
  if (hit) list[pos + __popc(mask & ((1u << lane) - 1u))] = val;
}

template <typename SlotT, int NS, int CL, typename Owner>
__device__ __forceinline__ void staged_rows(const OwnArgs& s, int v0, int v1,
                                            bool tail, int c_lo,
                                            int* list, int* count,
                                            size_t acc_bytes, Owner owner,
                                            unsigned long long* t) {
  constexpr int VEC = 16 / sizeof(SlotT);
  constexpr int ROUND = OWN_THREADS * STAGE_VECS;
  const SlotT* slots = static_cast<const SlotT*>(s.slots);
  const uint4* vs = reinterpret_cast<const uint4*>(slots);
  const int n = s.cm.n;
  const int tail_lo = tail ? (s.R / VEC) * VEC : s.R;
  // rounds of vectors; the tail's rows ride in the last round
  for (int r0 = v0;; r0 += ROUND) {
    const bool last = r0 + ROUND >= v1;
    const unsigned long long ta = gtime();
    if (threadIdx.x == 0) *count = 0;
    __syncthreads();
    uint4 raw[STAGE_VECS];
#pragma unroll
    for (int u = 0; u < STAGE_VECS; ++u) {
      const int v = r0 + u * OWN_THREADS + (int)threadIdx.x;
      raw[u] = v < v1 ? vs[v] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < STAGE_VECS; ++u) {
      const int v = r0 + u * OWN_THREADS + (int)threadIdx.x;
      const SlotT* sl = reinterpret_cast<const SlotT*>(&raw[u]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int slot = (int)sl[e];
        const unsigned d = (unsigned)(slot - c_lo);
        warp_append(v < v1 && d < (unsigned)(CL * NS) && slot < s.C,
                    ((v * VEC + e) << 10) | (int)d, list, count);
      }
    }
    if (last)
      for (int i = tail_lo + (int)threadIdx.x; i < s.R; i += OWN_THREADS) {
        const int slot = (int)slots[i];
        const unsigned d = (unsigned)(slot - c_lo);
        if (d < (unsigned)(CL * NS) && slot < s.C)
          list[atomicAdd(count, 1)] = (i << 10) | (int)d;
      }
    __syncthreads();
    const unsigned long long tb = gtime();
    t[0] += tb - ta;
    const int len = *count;
    for (int q = threadIdx.x; q < len; q += OWN_THREADS) {
      const int i = list[q] >> 10, d = list[q] & 1023;
      const bool b = s.base[i] != 0;
      bool m[OWN_COLS];
      float x[OWN_COLS];
#pragma unroll
      for (int j = 0; j < OWN_COLS; ++j)
        if (j < n) {
          const int64_t at = (int64_t)s.cm.spec[j] * s.R + i;
          m[j] = s.M[at] != 0;
          x[j] = s.V[at];
        }
      if (!b) continue;
      unsigned char* o = owner(d / NS);
      float* acc = reinterpret_cast<float*>(o);
      uint8_t* touched = o + acc_bytes;
      const int dd = d % NS;
      atomicAdd(acc + dd, 1.0f);
#pragma unroll
      for (int j = 0; j < OWN_COLS; ++j) {
        if (j >= n || !m[j]) continue;
        float* dst = acc + (1 + j) * NS + dd;
        touched[j * NS + dd] = 1;
        switch (s.cm.comp[j]) {
          case C_N: atomicAdd(dst, 1.0f); break;
          case C_S1: atomicAdd(dst, x[j]); break;
          case C_S2: atomicAdd(dst, __fmul_rn(x[j], x[j])); break;
          case C_MN: atomic_min_f32(dst, x[j]); break;
          default: atomic_max_f32(dst, x[j]); break;
        }
      }
    }
    __syncthreads();
    t[1] += gtime() - tb;
    if (last) break;
  }
}

// Thread 0's phases into s.phase (t: init, scans, adds, then the time the
// wait after the rows ended; tw: when the rows ended).
__device__ __forceinline__ void staged_phases(const OwnArgs& s,
                                              unsigned long long* t,
                                              unsigned long long tw) {
  if (s.phase == nullptr || threadIdx.x != 0) return;
  const unsigned long long te = gtime();
  unsigned long long* out = s.phase + 6 * (size_t)blockIdx.x;
  out[0] = t[0];
  out[1] = t[1];
  out[2] = t[2];
  out[3] = t[3] - tw;
  out[4] = te - t[3];
  out[5] = t[0] + t[1] + t[2] + (te - tw);
}

template <int NS>
__host__ __device__ constexpr size_t staged_acc_bytes(int n) {
  return sizeof(float) * (size_t)(1 + n) * NS + (size_t)n * NS;
}

// scan-and-keep-range, staged: CTA b owns [b NS, (b+1) NS) and takes
// every row
template <typename SlotT, int NS>
__global__ void __launch_bounds__(OWN_THREADS)
    probe_staged_scan_kernel(const __grid_constant__ OwnArgs s) {
  extern __shared__ __align__(16) unsigned char own_smem[];
  __shared__ int count;
  const size_t acc_bytes = sizeof(float) * (size_t)(1 + s.cm.n) * NS;
  int* list = reinterpret_cast<int*>(
      own_smem + ((staged_acc_bytes<NS>(s.cm.n) + 15) & ~(size_t)15));
  const int lo = blockIdx.x * NS;
  unsigned long long t[6] = {gtime(), 0, 0, 0, 0, 0};
  own_init<NS>(reinterpret_cast<float*>(own_smem), own_smem + acc_bytes,
               s.cm);
  __syncthreads();
  t[0] = gtime() - t[0];
  constexpr int VEC = 16 / sizeof(SlotT);
  staged_rows<SlotT, NS, 1>(s, 0, s.R / VEC, true, lo, list, &count,
                            acc_bytes, [&](int) { return own_smem; }, t + 1);
  const unsigned long long tw = gtime();
  __syncthreads();
  t[3] = gtime();
  own_write<NS>(s, lo, reinterpret_cast<const float*>(own_smem),
                own_smem + acc_bytes);
  staged_phases(s, t, tw);
}

// the cluster's ownership, staged: each CTA takes 1/CL of the rows and
// adds them into their owner's shared memory through distributed shared
// memory
template <typename SlotT, int NS, int CL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(OWN_THREADS)
    probe_staged_cluster_kernel(const __grid_constant__ OwnArgs s) {
  extern __shared__ __align__(16) unsigned char own_smem[];
  __shared__ int count;
  cg::cluster_group cluster = cg::this_cluster();
  const size_t acc_bytes = sizeof(float) * (size_t)(1 + s.cm.n) * NS;
  int* list = reinterpret_cast<int*>(
      own_smem + ((staged_acc_bytes<NS>(s.cm.n) + 15) & ~(size_t)15));
  const int rank = (int)cluster.block_rank();
  const int c_lo = (blockIdx.x / CL) * CL * NS;
  unsigned long long t[6] = {gtime(), 0, 0, 0, 0, 0};
  own_init<NS>(reinterpret_cast<float*>(own_smem), own_smem + acc_bytes,
               s.cm);
  cluster.sync();
  t[0] = gtime() - t[0];
  constexpr int VEC = 16 / sizeof(SlotT);
  const int nvec = s.R / VEC;
  const int per = (nvec + CL - 1) / CL;
  const int v0 = min(rank * per, nvec), v1 = min(v0 + per, nvec);
  staged_rows<SlotT, NS, CL>(s, v0, v1, rank == CL - 1, c_lo, list, &count,
                             acc_bytes, [&](int r) {
                               return cluster.map_shared_rank(own_smem, r);
                             }, t + 1);
  const unsigned long long tw = gtime();
  cluster.sync();
  t[3] = gtime();
  own_write<NS>(s, c_lo + rank * NS, reinterpret_cast<const float*>(own_smem),
                own_smem + acc_bytes);
  staged_phases(s, t, tw);
}

template <typename SlotT, int NS>
static cudaError_t launch_scan(const OwnArgs& s, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)(1 + s.cm.n) * NS +
                      (size_t)s.cm.n * NS;
  const int grid = (s.C + NS - 1) / NS;
  probe_scan_kernel<SlotT, NS><<<grid, OWN_THREADS, smem, st>>>(s);
  return cudaGetLastError();
}

template <typename SlotT, int NS, int CL>
static cudaError_t launch_cluster(const OwnArgs& s, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)(1 + s.cm.n) * NS +
                      (size_t)s.cm.n * NS;
  const int grid = ((s.C + CL * NS - 1) / (CL * NS)) * CL;
  probe_cluster_kernel<SlotT, NS, CL><<<grid, OWN_THREADS, smem, st>>>(s);
  return cudaGetLastError();
}

template <typename SlotT, int NS, int CL>
static cudaError_t launch_staged(const OwnArgs& s, cudaStream_t st) {
  if (s.cm.n > OWN_COLS || (long long)s.R << 10 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = ((staged_acc_bytes<NS>(s.cm.n) + 15) & ~(size_t)15) +
                      sizeof(int) * (OWN_THREADS * STAGE_VECS + 1) *
                          (16 / sizeof(SlotT));
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int grid = ((s.C + CL * NS - 1) / (CL * NS)) * CL;
  if (CL == 1)
    probe_staged_scan_kernel<SlotT, NS><<<grid, OWN_THREADS, smem, st>>>(s);
  else
    probe_staged_cluster_kernel<SlotT, NS, CL>
        <<<grid, OWN_THREADS, smem, st>>>(s);
  return cudaGetLastError();
}

extern "C" {

// The packed form of groupby_fold (csrc/groupby.cu): the same arguments,
// the column maps packed into `cols` (device uint32: n_scalar scalar,
// then n_wide hll / hist, then n_hh hh columns).
int probe_packed(const uint8_t* base, const float* V, const uint8_t* M,
                 const void* slots, int slot_u16, int R, int pane,
                 const uint8_t* pane_vec, int P, int C, const uint32_t* cols,
                 int n_scalar, int n_wide, int n_hh, float* const* comp_ptrs,
                 const int32_t* comp_k, float* act, unsigned int* touch,
                 float* const* wide_ptrs, const int32_t* wide_k,
                 const float* hist_consts, void* stream) {
  if (n_scalar < 0 || n_wide < 0 || n_hh < 0 || n_scalar > MAX_COLS ||
      n_wide + n_hh > MAX_COLS || R <= 0)
    return (int)cudaErrorInvalidValue;
  FoldChunkP a{};
  a.base = base;
  a.V = V;
  a.M = M;
  a.slots = slots;
  a.pane_vec = pane_vec;
  a.N = R;
  a.m = R;
  a.R_sh = 1;
  a.pane = pane;
  a.Pp = P;
  a.C = C;
  a.cols = cols;
  a.n_scalar = n_scalar;
  a.n_wide = n_wide;
  a.n_hh = n_hh;
  a.cp = make_comps(comp_ptrs, comp_k);
  a.act = act;
  a.touch = touch;
  a.w = make_wide(wide_ptrs, wide_k);
  a.hc = make_hc(hist_consts);
  const long long rows = (R + FOLD_THREADS - 1) / FOLD_THREADS;
  a.nb_s = (int)(rows < 65535 ? rows : 65535);
  a.nb_w = n_wide > 0 ? a.nb_s : 0;
  a.nb_h = n_hh > 0 ? (int)(2 * rows < 65535 ? 2 * rows : 65535) : 0;
  cudaStream_t st = (cudaStream_t)stream;
  with_slot_type(slots, slot_u16, [&](auto p) {
    using SlotT = std::remove_const_t<std::remove_pointer_t<decltype(p)>>;
    probe_packed_kernel<SlotT>
        <<<a.nb_s + a.nb_w + a.nb_h, FOLD_THREADS, 0, st>>>(a);
  });
  return (int)cudaGetLastError();
}

// route 0: probe_scan (ns 64); route 1: probe_cluster (ns 128, cl 8);
// route 2: the staged routes (cl 1: probe_staged_scan, ns 128; else
// probe_staged_cluster, (ns, cl) in (128, 4), (128, 8), (64, 8)).
// colmap: host int32 (ncols, 3). slots must be 16-byte aligned. phase:
// device uint64 (grid, 6) for the staged routes' phases, or null.
int probe_own(int route, int ns, int cl, const uint8_t* base, const float* V,
              const uint8_t* M, const void* slots, int slot_u16, int R,
              int pane, int C, const int32_t* colmap, int ncols,
              float* const* comp_ptrs, const int32_t* comp_k, float* act,
              unsigned long long* phase, void* stream) {
  OwnArgs s{};
  if (!make_colmap(colmap, ncols, &s.cm) || R <= 0 || C <= 0 ||
      (reinterpret_cast<uintptr_t>(slots) & 15u))
    return (int)cudaErrorInvalidValue;
  s.base = base;
  s.V = V;
  s.M = M;
  s.slots = slots;
  s.R = R;
  s.pane = pane;
  s.C = C;
  s.cp = make_comps(comp_ptrs, comp_k);
  s.act = act;
  s.phase = phase;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  with_slot_type(slots, slot_u16, [&](auto p) {
    using SlotT = std::remove_const_t<std::remove_pointer_t<decltype(p)>>;
    if (route == 0 && ns == 64) err = launch_scan<SlotT, 64>(s, st);
    if (route == 1 && ns == 128 && cl == 8)
      err = launch_cluster<SlotT, 128, 8>(s, st);
    if (route == 2 && ns == 128 && cl == 1)
      err = launch_staged<SlotT, 128, 1>(s, st);
    if (route == 2 && ns == 128 && cl == 4)
      err = launch_staged<SlotT, 128, 4>(s, st);
    if (route == 2 && ns == 128 && cl == 8)
      err = launch_staged<SlotT, 128, 8>(s, st);
    if (route == 2 && ns == 64 && cl == 8)
      err = launch_staged<SlotT, 64, 8>(s, st);
  });
  return (int)err;
}

}  // extern "C"
