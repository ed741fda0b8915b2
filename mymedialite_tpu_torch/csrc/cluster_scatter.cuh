// The thread-block cluster walk of the epoch kernels (sgd_epoch.cu,
// bpr_epoch.cu, svdpp_epoch.cu): a chunk's slots spread over the N CTAs
// of one cluster, its owner scatter's stage over their shared memory, and
// the launch of that one cluster.
//
// CTA r of a cluster of N takes slots [r cs, (r + 1) cs), cs = ceil(C /
// N), of each chunk (or step) and runs phase 1 on them (the gathers, the
// gradient, the deltas). The values that phase 1 hands to the owner
// scatter (owner_scatter.cuh: row + d for a run's first entry, d for the
// others) go to the chunk's stage by compact index: float4 o of the stage
// lies in CTA o / S at o % S, S = ceil(total / N), through the generic
// pointers that cooperative_groups' map_shared_rank gives. Phase 2: CTA r
// sums the runs whose first value lies in its part, each (run, piece) one
// thread's left fold in list order, and reads the tail of a run that
// crosses into the next parts remotely; the order of every sum is
// owner_scatter.cuh's. Where S exceeds a CTA's stage the values go to the
// global scratch and CTA 0 sums them with owner_chain, as one block does;
// a cluster of one sums with owner_chain too.
//
// Ordering. barrier.cluster.arrive (release semantics by default) and
// barrier.cluster.wait (acquire by default), executed by every thread of
// every CTA, order each thread's prior global and shared-memory accesses,
// the distributed shared memory included, before every access that
// follows the wait in any thread of the cluster (PTX ISA, barrier.cluster
// and the memory consistency model's release and acquire patterns at
// cluster scope). The kernels split it: cluster_arrive after a thread's
// part, cluster_wait where it needs the others'. With N = 1 the wait is
// bar.sync, which orders the block's accesses the same way within the
// block. Global stores (st.global.cg) and gathers (ld.global.cg) act at
// L2, not through a stale L1 line. A cp.async copy into shared memory is
// a write of the thread that issued it only once that thread's
// cp.async.wait_group has returned, and an arrive releases only what
// precedes it; so a thread finishes its copies before its arrive after
// phase 1 (arrive_copied), and the chunk buffers it fills (and the
// schedule entries thread 0 copies with them) are read by other threads
// only past the wait that follows.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "owner_scatter.cuh"

namespace mml_cluster {

// the largest cluster the launcher takes (H100's non-portable limit)
constexpr int kMaxCluster = 16;
// what the launchers return where the card cannot place the cluster
constexpr int kClusterUnplaced = -2;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The barrier of the cluster's n CTAs, called by every thread, in two
// halves: cluster_arrive after a thread's part (a no-op in a cluster of
// one), cluster_wait where it needs the others' (bar.sync in a cluster of
// one); cluster_barrier is both at once.
__device__ __forceinline__ void cluster_arrive(int n) {
  if (n > 1) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait(int n) {
  if (n > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  } else {
    asm volatile("bar.sync 0;\n" ::: "memory");
  }
}

__device__ __forceinline__ void cluster_barrier(int n) {
  cluster_arrive(n);
  cluster_wait(n);
}

// A thread's arrive after its phase 1 (and before the first step): its
// cp.async copies complete first, so that the arrive publishes them with
// its other writes. They were issued a step (or a phase) before.
__device__ __forceinline__ void arrive_copied(int n) {
  cp_async_wait_all();
  cluster_arrive(n);
}

// floor(o / S) for 0 <= o < 2^23 and S >= 1, from rS = 1 / S: the float
// quotient is off by at most one, and one step each way corrects it
__device__ __forceinline__ int quot(int o, int S, float rS) {
  int q = __float2int_rz((float)o * rS);
  q -= q * S > o;
  q += (q + 1) * S <= o;
  return q;
}

// A chunk's stage over the cluster: the values of the entries in runs of
// two or more by compact index (table 0's at w0 float4s an entry, then
// table 1's at w1 from off1; only the tables of the step's `sides`, as
// mml_owner::make_stage), float4 o in CTA o / S at o % S (part[q]: CTA
// q's stage; rank this CTA), or in the global scratch at o. `base` is
// this CTA's stage where the values are on chip, else the scratch, so
// that a cluster of one keeps one pointer, as one block's Stage does.
struct ClusterStage {
  float4* const* part;
  float4* base;
  int w0, w1, n0, off1, S, rank;
  float rS;
  bool on_chip, one;          // one: a cluster of one CTA
  __device__ int off(int idx) const {
    return idx < n0 ? idx * w0 : off1 + (idx - n0) * w1;
  }
  __device__ float4* at(int o) const {
    if (one || !on_chip) return base + o;
    const int q = quot(o, S, rS);
    return q == rank ? base + (o - q * S) : part[q] + (o - q * S);
  }
  // the same stage as one block's owner_chain reads it: this CTA's
  // shared memory where the values are on chip, else the scratch
  __device__ mml_owner::Stage block() const {
    mml_owner::Stage gs;
    gs.base = base;
    gs.w0 = w0;
    gs.w1 = w1;
    gs.n0 = n0;
    gs.off1 = off1;
    gs.smem = on_chip;
    return gs;
  }
};

// The stage of a step with runs block `runs` over a cluster of ncta CTAs,
// each with stage_f4 float4s of stage at `local` (part: every CTA's).
__device__ __forceinline__ ClusterStage cluster_stage(
    const uint16_t* runs, unsigned sides, int w0, int w1, int ncta, int rank,
    float4* const* part, float4* local, float4* scratch, int stage_f4) {
  ClusterStage st;
  st.part = part;
  st.rank = rank;
  st.w0 = w0;
  st.w1 = w1;
  st.n0 = runs[2];
  st.off1 = (sides & 1) ? st.n0 * w0 : 0;
  const int total = st.off1 + ((sides & 2) ? (int)runs[3] * w1 : 0);
  st.one = ncta == 1;
  st.S = max(1, st.one ? total : (total + ncta - 1) / ncta);
  st.rS = st.one ? 1.f : 1.f / (float)st.S;
  st.on_chip = st.S <= stage_f4;
  st.base = st.on_chip ? local : scratch;
  return st;
}

// The runs [k_lo, k_hi) of the step's `sides` (table 0's runs first)
__device__ __forceinline__ int runs_lo(const uint16_t* runs, unsigned sides) {
  return (sides & 1) ? 0 : (int)runs[0];
}

__device__ __forceinline__ int runs_hi(const uint16_t* runs, unsigned sides) {
  return (sides & 2) ? (int)runs[0] + (int)runs[1] : (int)runs[0];
}

// out[e], e = 0, 1: the first of the runs [k_lo, k_hi) whose first value
// lies at or past (rank + e) S, by binary search (the runs' first values
// ascend): this CTA's runs of phase 2 are [out[0], out[1]).
__device__ __forceinline__ void find_runs(const uint16_t* runs,
                                          const ClusterStage& st, int k_lo,
                                          int k_hi, int* out) {
  const uint16_t* run = runs + 4;
  for (int e = 0; e < 2; ++e) {
    const int at = (st.rank + e) * st.S;
    int lo = k_lo, hi = k_hi;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (st.off(run[3 * mid + 1]) < at) lo = mid + 1;
      else hi = mid;
    }
    out[e] = lo;
  }
}

// What phase 1 does with one entry's piece li, by its code (as
// mml_owner::put): row + d into the table for an entry alone in its run,
// else row + d (a run's first entry) or d into the stage.
__device__ __forceinline__ void put(uint16_t code, const ClusterStage& st,
                                    int li, float4* row, float4 row_val,
                                    float4 d) {
  if (code == mml_owner::kDead) {
    __stcg(row, mml_owner::f4_add(row_val, d));
    return;
  }
  if (code & mml_owner::kStart) d = mml_owner::f4_add(row_val, d);
  *st.at(st.off(code & 0x7fff) + li) = d;
}

// A float4 of this CTA's shared memory (ld.shared).
__device__ __forceinline__ float4 lds4(const float4* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  float4 v;
  asm("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(a));
  return v;
}

// acc + the n values of this CTA's shared memory at at[0], at[w], ... in
// order, four loads ahead of the adds
__device__ __forceinline__ float4 fold(float4 acc, const float4* at, int n,
                                       int w) {
  using mml_owner::f4_add;
  int q = 0;
  for (; q + 4 <= n; q += 4, at += 4 * w) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = lds4(at + i * w);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = f4_add(acc, x[i]);
  }
  for (; q < n; ++q, at += w) acc = f4_add(acc, lds4(at));
  return acc;
}

// Phase 2 of one CTA with the stage on chip: the runs [k0, k1) of the
// runs block `runs` (those whose first value lies in this CTA's part),
// each (run, piece) one thread's sum: the run's first value, plus the
// others in list order (those in this CTA's part from its shared memory,
// the tail of a run that crosses into the next parts through the
// cluster's), stored once at pc.dst(table, entry id, piece).
template <int kThreads, class Pieces>
__device__ __forceinline__ void cluster_sums(const uint16_t* runs,
                                             const ClusterStage& st, int k0,
                                             int k1, const Pieces& pc) {
  const int nr0 = runs[0];
  const uint16_t* run = runs + 4;             // (entry, compact, length)
  const int n0 = max(0, min(k1, nr0) - k0);
  const int items = n0 * st.w0 + (k1 - k0 - n0) * st.w1;
  const int lo = st.rank * st.S, hi = lo + st.S;
  for (int x = threadIdx.x; x < items; x += kThreads) {
    int k, li, w;
    if (x < n0 * st.w0) {
      k = k0 + x / st.w0;
      li = x - (k - k0) * st.w0;
      w = st.w0;
    } else {
      const int y = x - n0 * st.w0;
      k = k0 + n0 + y / st.w1;
      li = y - (k - k0 - n0) * st.w1;
      w = st.w1;
    }
    const uint16_t e = run[3 * k];
    const int len = run[3 * k + 2];
    // the run's first value is in [lo, hi); its piece li and the values
    // after it may lie past hi, in the next parts
    const int o = st.off(run[3 * k + 1]) + li;
    const int nl = o >= hi ? 0
                   : o + (len - 1) * w < hi ? len : (hi - o + w - 1) / w;
    auto remote = [&](int c) {
      const int oc = o + c * w;
      const int q = quot(oc, st.S, st.rS);
      return st.part[q][oc - q * st.S];
    };
    float4 acc;
    int c = 1;
    if (nl > 0) {
      const float4* at = st.base + (o - lo);
      acc = fold(lds4(at), at + w, nl - 1, w);
      c = nl;
    } else {
      acc = remote(0);
    }
    for (; c < len; ++c) acc = mml_owner::f4_add(acc, remote(c));
    __stcg(pc.dst(mml_owner::side_of(e), e & mml_owner::kIdMask, li), acc);
  }
}

// Launch `kern` as one cluster of `cluster` CTAs (1 to kMaxCluster) of
// `threads` threads and `smem` bytes of dynamic shared memory on
// `stream`, without synchronising: the first CUDA error of the launch, or
// kClusterUnplaced where the card cannot place the cluster (never a
// smaller one in its place).
template <class... KArgs, class... Args>
int launch_cluster(void (*kern)(KArgs...), int cluster, int threads,
                   int smem, cudaStream_t stream, Args... args) {
  if (cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int placed = 0;
  err = cudaOccupancyMaxActiveClusters(&placed, (const void*)kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (placed < 1) return kClusterUnplaced;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace mml_cluster
