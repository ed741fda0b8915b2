// One BPR epoch over the chunk plan: a sampling kernel over the whole
// card, then the serial walk of the chunks in one thread-block cluster,
// both launched by one call.
//
// Replaces two TPU kernels of the same epoch, through one entry point:
// - mymedialite_tpu/ops/pallas_bpr.py:451 _mxu_bpr_kernel, the item table
//   resident in VMEM;
// - mymedialite_tpu/ops/pallas_bpr.py:979 _mxu_bpr_tiled_kernel, the
//   slab-tiled schedule of big catalogs, with the user block, the
//   positive slab and the negative slab in VMEM, swapped by blocking DMA.
//   Its chunk's positive block is isl * B + ibr and its negative block
//   jb = jsl * B + jbr, both absolute by the time they reach the kernel
//   (ops/bpr_epoch.py bpr_epoch_tiled); the order (sorted by isl, then
//   jsl, then user block) keeps the two slabs hot in L2, which takes the
//   place of the slabs in VMEM. The TPU kernel's transposed tables, pad
//   chunk, pass split and refetch flags are not carried over.
// Same semantics: every chunk of C positive events (u, i) is one
// minibatch step.
//
// Sampling, per slot, from the epoch's random bits (bits[k][t][s], T
// trials): a uniform candidate is (bits & 0x7fffffff) % nval[k]; a WBPR
// candidate is #(cdf_row < u01) with u01 = float(bits & 0x7fffffff) *
// 2^-31 over the IB entries of the negative block's popularity CDF
// (found by binary search: the row is nondecreasing). A candidate is a
// positive when key u_loc*IB + cand lies in bucket bkt = (ub, jb): in
// the bucket's packed bitmask, in its ascending, -1 padded key row, or
// (sub-bucketed keys, the tiled sampler's table [n_bkt * 8, Ksub]) in row
// bkt * 8 + (u_loc & 7), ascending and -1 padded too, which holds only
// the keys of the users that share the slot's u_loc & 7. The first trial
// that is not a positive wins; when all T trials hit positives, j = 0 and
// the slot's weight is 0. The sampler reads no table that the epoch
// writes (only the bits, the membership table, the CDF and the packed
// rows), so every slot of the epoch is sampled before the walk, one
// thread block per chunk over all SMs, into neg [nc, 2, C] (the local
// negative and the bits of its 0/1 success weight); padding slots are
// sampled too. The same block then builds the chunk's segment table
// (owner_scatter.cuh) into seg [nc, R]: its live entries (weight
// base * pad * ok not 0) keyed (table, row, entry id) with W entries
// (u_loc, slot) and H entries (the absolute H row, then i before j: id
// slot for i, C + slot for j), sorted by a bitonic sort in shared memory,
// its runs and each slot's codes. The H row key is relative to the lower
// of the chunk's two item blocks, so i and j rows that meet (the tiled
// schedule's isl * B + ibr == jsl * B + jbr) fall in one run.
//
// Update, with wgt = base_w * pad_w * ok and every gather reading the
// tables as they stood before the chunk:
//   x  = <w_u, h_i - h_j>   (the item bias rides in column f, against
//                            the users' constant-1 column)
//   g  = sigmoid(-x) * wgt, or (x < 1) * wgt for the hinge
//   dW[u] += w_lr * (g * (h_i - h_j) - wgt * w_reg * w_u)
//   dH[i] += i_lr * (g * w_u - wgt * i_reg * h_i)
//   dH[j] += j_lr * (-g * w_u - wgt * j_reg * h_j)
// with duplicate rows (and i == j rows across the two item blocks, which
// on the tiled schedule means isl == jsl and ibr == jbr) summing, each
// row's deltas in the plain version's order: W's in slot order, H's i
// deltas in slot order before its j deltas (ops/bpr_epoch.py, W then H at
// i then H at j). Slots of weight 0 write nothing and are in no run. The
// TPU idioms (one-hot matmul gathers and scatters, the [.., C]
// orientation, the byte-row matmul of the bitmask, bf16 operands, the
// VMEM copy of H) are not carried over: on Hopper the gathers are indexed
// loads and the scatter the owner scatter.
//
// The walk. As for the rating epoch (sgd_epoch.cu), the visit order
// groups chunks by user block and consecutive chunks share a user block
// or an item block, so chunk k+1 may read what chunk k writes, and the
// order is kept. A chunk's time is its chain of dependent round trips to
// L2 and the L2 traffic of the SMs that run it, not HBM bandwidth. So:
// - a chunk spreads over a thread-block cluster of N CTAs on neighbouring SMs
//   (one cluster is the whole grid; N from the shape, ops/cluster.py
//   cluster_size): CTA r takes slots [r cs, (r + 1) cs), cs = ceil(C / N),
//   and gathers their three rows (W, h_i, h_j) (a CTA of 640 threads up to 64
//   columns, threads_of: its 80 slots of a chunk of 640 fill one round, with
//   no register spilled). Each CTA holds the chunk's whole buffer (its packed
//   row, its sampled (j, ok) and its segment table: phase 2 needs any slot's
//   rows);
// - the buffers run two chunks ahead (three of them, with the packed row
//   of the chunk two after), copied with cp.async, so that no global load
//   but the gathers is on a chunk's path;
// - a row is cut into float4s, one per lane (two per lane past 128
//   columns), so at fe <= 64 a warp serves two slots per pass, and each
//   warp issues the row loads of several passes before it uses any;
// - the values for the owner scatter (only the runs' entries, W's and
//   H's, H's i entries before its j entries) go to the chunk's stage,
//   striped over the cluster's shared memory by compact index, and CTA r
//   sums the runs whose first value lies in its part, reading the tail of
//   a run that crosses into the next part (between two i entries, two j
//   entries, or an i entry and a j entry) remotely (cluster_scatter.cuh);
//   where the stage does not fit, the values go to a global scratch [3,
//   C, fe] and CTA 0 sums them with owner_scatter.cuh's owner_chain;
// - a W float4 whose learning rates are all 0 is not summed: its deltas
//   are exactly 0 (the zero padding of the tables to fe columns, and the
//   users' constant column); an H float4 is summed where the i or the j
//   rate is not 0, so that a run that mixes i and j entries adds every
//   one of them.
// A chunk, in each CTA: wait for the cluster; phase 1; wait for this
// thread's copies of chunk k+1, arrive, issue chunk k+2's copies, wait;
// phase 2; arrive. A cluster of
// one is compiled apart (kOne), so that the cluster's state takes no
// registers there; its copies go at the chunk's start and its phase 2 is
// owner_chain, whose barrier ends phase 1: the one-block walk.
//
// Why the tables equal the one-block walk's bit for bit: every slot's x
// is the same fmaf chain over its lanes' float4s of w_u and h_i - h_j and
// the same shuffle tree (the lanes of a slot, SPW, V and G are chosen
// from fe as before), its gradient and deltas the same expressions; each
// run's sum is the same left fold in list order (the stage's place of a
// value changes, not the order); and each value read is the value the
// one-block walk reads (the barriers below). Nothing is added atomically.
// (The tests hold the tables to digests of the one-block kernel's:
// tests/test_torch_cuda.py BPR_ONE_BLOCK_SHA256.)
//
// Ordering (cluster_scatter.cuh). Every thread arrives once its stores
// of chunk k-1's phase 2 are issued and waits at the start of chunk k:
// barrier.cluster's release and acquire order the owners' st.global.cg
// stores in one CTA before the next chunk's ld.global.cg gathers in
// another, and the arrive and wait between the phases order phase 1's
// remote stores into the stage before phase 2's reads. Each thread's
// copies of chunk k+1 (its buffer, and thread 0's ub, ib, jb and the
// packed row of chunk k+3) complete before its arrive after phase 1 of
// chunk k (the prologue's for chunks 0 and 1), so the wait that follows
// makes them visible to every thread: chunk k+1 reads that row to issue
// chunk k+3's copies. The sampler's
// outputs (neg, the segment tables) come from a kernel that ends before
// the walk starts on the same stream. The walk ends with a wait, so that
// no CTA leaves while another reads its stage. A __threadfence() orders
// writes for observers outside the cluster, and there are none during
// the walk.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_scatter.cuh"

namespace {

using mml_cluster::cluster_arrive;
using mml_cluster::cluster_wait;
using mml_cluster::cp_async4;
using mml_cluster::cp_async_commit;
using mml_cluster::kMaxCluster;
using mml_cluster::put;

// The walk's threads a CTA: 1024 in a cluster of one (the one-block
// walk); in a cluster of several, 640 where a warp serves two slots a
// pass (up to 64 columns): a CTA's 80 slots of a chunk of 640 on 8 CTAs
// then fill one round of its warps' G passes, and each thread has more
// than 64 registers, where 1024 threads have 64 and spill. Past 64
// columns 1024.
__host__ __device__ constexpr int threads_of(int SPW, bool kOne) {
  return kOne || SPW == 1 ? 1024 : 640;
}
constexpr int kSampleThreads = 512;
constexpr int kOneBits = 0x3f800000;  // bits of 1.0f
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kDeadKey = ~0ull;

// membership forms
constexpr int kKeys = 0;
constexpr int kBitmask = 1;
constexpr int kSubkeys = 2;
constexpr int kSubBuckets = 8;

// #(row[0..n) < x) for a nondecreasing row
__device__ __forceinline__ int count_less(const float* row, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// key in an ascending key row padded with -1 at its end
__device__ __forceinline__ bool in_key_row(const int32_t* row, int kcap,
                                           int32_t key) {
  int lo = 0, hi = kcap;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t v = __ldg(row + mid);
    if (v >= 0 && v < key) lo = mid + 1; else hi = mid;
  }
  return lo < kcap && __ldg(row + lo) == key;
}

// One thread block per chunk k: every slot's negative into neg [nc, 2, C],
// then the chunk's segment table into seg [nc, R] (the runs [RL], then
// the codes [3][Cw]) from its list of L = 3C (rounded up to 8) sort keys.
// Shared memory: N = the power of two >= L sort keys.
__global__ void __launch_bounds__(kSampleThreads)
bpr_sample_kernel(const int32_t* __restrict__ packed,
                  const int32_t* __restrict__ order_row,
                  const int32_t* __restrict__ ib_v,
                  const int32_t* __restrict__ jb_v,
                  const int32_t* __restrict__ nval_v,
                  const int32_t* __restrict__ bkt_v,
                  const int32_t* __restrict__ keys,
                  const unsigned char* __restrict__ bitmask,
                  const float* __restrict__ cdf,
                  const int32_t* __restrict__ bits,
                  int32_t* __restrict__ neg, uint16_t* __restrict__ seg,
                  int C, int L, int RL, int R, int N, int UB, int IB,
                  int trials, int kcap, int wbpr, int membership) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(smem);
  const int Cw = (C + 7) & ~7;
  const int k = blockIdx.x;
  const int32_t* prow = packed + (int64_t)__ldg(order_row + k) * 4 * C;
  const int nv = __ldg(nval_v + k);
  const int64_t bkt = __ldg(bkt_v + k);
  const int ib = __ldg(ib_v + k), jb = __ldg(jb_v + k);
  const int lo_b = min(ib, jb);
  // an H row's key: its block (the lower of ib, jb first), then its row
  auto hrow = [&](int blk, int loc) -> unsigned long long {
    return (unsigned long long)((blk == lo_b ? 0 : IB) + loc);
  };
  const float* crow = wbpr ? cdf + (int64_t)jb * IB : nullptr;
  const int nb8 = IB >> 3;
  for (int e = threadIdx.x; e < N; e += kSampleThreads) s_key[e] = kDeadKey;
  __syncthreads();
  for (int s = threadIdx.x; s < C; s += kSampleThreads) {
    const int u = __ldg(prow + s);
    const int32_t* b = bits + (int64_t)k * trials * C + s;
    const unsigned char* mrow = bitmask + (bkt * UB + u) * nb8;
    const int32_t* srow =
        membership == kSubkeys
            ? keys + (bkt * kSubBuckets + (u & (kSubBuckets - 1))) * kcap
            : keys + bkt * kcap;
    int j = 0;
    bool ok = false;
#pragma unroll 8
    for (int tr = 0; tr < trials; ++tr) {
      const int r = __ldg(b + (int64_t)tr * C) & 0x7fffffff;
      const int cand = wbpr ? count_less(crow, IB, __int2float_rn(r) *
                                                       (1.0f / 2147483648.0f))
                            : r % nv;
      bool pos;
      if (membership == kBitmask) {
        pos = (cand >> 3) < nb8 &&
              ((__ldg(mrow + (cand >> 3)) >> (cand & 7)) & 1);
      } else {
        pos = in_key_row(srow, kcap, u * IB + cand);
      }
      if (!ok && !pos) j = cand;
      ok = ok || !pos;
    }
    neg[(int64_t)k * 2 * C + s] = j;
    neg[(int64_t)k * 2 * C + C + s] = ok ? kOneBits : 0;
    // the slot's entries, where its weight is not 0: the plain version's
    // product base * pad * ok
    const float wgt = __int_as_float(__ldg(prow + 2 * C + s)) *
                      __int_as_float(__ldg(prow + 3 * C + s)) *
                      (ok ? 1.f : 0.f);
    if (wgt != 0.f) {
      s_key[s] = ((unsigned long long)u << 20) | (unsigned)s;
      s_key[C + s] = (1ull << 62) |
                     (hrow(ib, __ldg(prow + C + s)) << 20) | (unsigned)s;
      s_key[2 * C + s] = (1ull << 62) | (hrow(jb, j) << 20) |
                         (unsigned)(C + s);
    }
  }
  // bitonic sort of the N keys, ascending
  for (int w = 2; w <= N; w <<= 1) {
    for (int h = w >> 1; h > 0; h >>= 1) {
      __syncthreads();
      for (int e = threadIdx.x; e < N / 2; e += kSampleThreads) {
        const int i = 2 * e - (e & (h - 1));   // the pair (i, i + h)
        const unsigned long long a = s_key[i], c = s_key[i + h];
        if ((a > c) == ((i & w) == 0)) {
          s_key[i] = c;
          s_key[i + h] = a;
        }
      }
    }
  }
  __syncthreads();
  // the runs and the codes (owner_scatter.cuh): compact indices and run
  // numbers by block-wide counts of the entries and runs before, and the
  // same counts of table 0 for the runs block's head (table 1 the rest)
  uint16_t* runs = seg + (int64_t)k * R;
  uint16_t* codes = runs + RL;                // [3][Cw]
  __shared__ int s_warp[4][kSampleThreads / 32];
  // entries in runs, runs; the same of table 0
  __shared__ int s_before[4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 4) s_before[threadIdx.x] = 0;
  for (int i = threadIdx.x; i < 3 * Cw; i += kSampleThreads)
    codes[i] = mml_owner::kDead;
  for (int i = threadIdx.x; i < RL; i += kSampleThreads) runs[i] = 0;
  for (int p0 = 0; p0 < L; p0 += kSampleThreads) {
    const int p = p0 + threadIdx.x;
    const unsigned long long key = p < L ? s_key[p] : kDeadKey;
    const bool live = key != kDeadKey;
    const bool start =
        live && (p == 0 || (s_key[p - 1] >> 20) != (key >> 20));
    int end = p + 1;                  // past the run that starts at p
    if (start)
      while (end < N && s_key[end] != kDeadKey &&
             (s_key[end] >> 20) == (key >> 20))
        ++end;
    const bool in_run = live && (!start || end > p + 1);
    const bool first = start && end > p + 1;
    const bool side0 = (key >> 62) == 0;      // a dead key reads as side 3
    const unsigned b_in = __ballot_sync(kFull, in_run);
    const unsigned b_first = __ballot_sync(kFull, first);
    const unsigned b_in0 = __ballot_sync(kFull, in_run && side0);
    const unsigned b_first0 = __ballot_sync(kFull, first && side0);
    __syncthreads();                  // s_before is current, s_warp free
    if (lane == 0) {
      s_warp[0][warp] = __popc(b_in);
      s_warp[1][warp] = __popc(b_first);
      s_warp[2][warp] = __popc(b_in0);
      s_warp[3][warp] = __popc(b_first0);
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1;
    int ci = s_before[0] + __popc(b_in & below);
    int ri = s_before[1] + __popc(b_first & below);
    for (int w = 0; w < warp; ++w) {
      ci += s_warp[0][w];
      ri += s_warp[1][w];
    }
    if (live) {
      const int side = (int)(key >> 62);
      const int id = (int)(key & 0xfffff);
      const uint16_t entry =
          (uint16_t)(id | (side << 14) | (start ? 0x8000 : 0));
      if (in_run) {
        // kind table 0 W, 1 i, 2 j
        const int t = side == 0 ? 0 : (id < C ? 1 : 2);
        codes[t * Cw + (id < C ? id : id - C)] =
            (uint16_t)(ci | (start ? 0x8000 : 0));
      }
      if (first) {
        runs[4 + 3 * ri] = entry;
        runs[5 + 3 * ri] = (uint16_t)ci;
        runs[6 + 3 * ri] = (uint16_t)(end - p);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 0; w < kSampleThreads / 32; ++w)
        for (int c = 0; c < 4; ++c) s_before[c] += s_warp[c][w];
  }
  __syncthreads();
  // runs of table 0 and 1, entries in them of table 0 and 1
  if (threadIdx.x == 0) {
    runs[0] = (uint16_t)s_before[3];
    runs[1] = (uint16_t)(s_before[1] - s_before[3]);
    runs[2] = (uint16_t)s_before[2];
    runs[3] = (uint16_t)(s_before[0] - s_before[2]);
  }
}

__device__ __forceinline__ float4 f4_sub(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ bool f4_any(float4 a) {
  return a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f;
}

// r * (g * a - wr * b), component by component, wr = wgt * reg
__device__ __forceinline__ float4 f4_delta(float4 r, float g, float4 a,
                                           float wgt, float4 reg, float4 b) {
  return make_float4(r.x * (g * a.x - wgt * reg.x * b.x),
                     r.y * (g * a.y - wgt * reg.y * b.y),
                     r.z * (g * a.z - wgt * reg.z * b.z),
                     r.w * (g * a.w - wgt * reg.w * b.w));
}

// The shared buffer of one chunk: [0, 4C) its packed row (u_loc, i_loc,
// base weight bits, pad weight bits), [4C, 6C) its neg row (j, ok bits).
__device__ __forceinline__ float slot_weight(const int32_t* sd, int C,
                                             int s) {
  return __int_as_float(sd[2 * C + s]) * __int_as_float(sd[3 * C + s]) *
         __int_as_float(sd[5 * C + s]);
}

// Where piece li of an entry of the owner scatter goes: table 0 is W
// (entry id = slot), table 1 is H (entry id = slot for i, C + slot for j).
struct BprPieces {
  float* W;
  float* H;
  const int32_t* sd;        // the chunk's shared buffer
  const int32_t* live;      // [2][fe4]: the live float4s of W, then H
  int64_t wbase, ibase, jbase;
  int C, fe, fe4;
  __device__ float4* dst(int t, int id, int li) const {
    float* row = t == 0 ? W + (wbase + sd[id]) * fe
                 : id < C ? H + (ibase + sd[C + id]) * fe
                          : H + (jbase + sd[4 * C + id - C]) * fe;
    return reinterpret_cast<float4*>(row) + live[t * fe4 + li];
  }
};

// V float4s per lane per row (fe <= 128 V), SPW slots per warp pass (a
// slot on 32 / SPW lanes), G passes in flight per warp. One cluster of
// gridDim.x CTAs; kOne: a cluster of one, compiled apart so that the
// cluster's state takes no registers there.
template <int V, int SPW, int G, bool kOne>
__global__ void __launch_bounds__(threads_of(SPW, kOne), 1)
bpr_walk_kernel(float* __restrict__ W, float* __restrict__ H,
                const int32_t* __restrict__ packed,
                const int32_t* __restrict__ order_ub,
                const int32_t* __restrict__ order_ib,
                const int32_t* __restrict__ order_row,
                const int32_t* __restrict__ jb_v,
                const int32_t* __restrict__ neg,
                const uint16_t* __restrict__ segs,
                const float* __restrict__ rates,
                float4* __restrict__ scratch,
                int nc, int C, int RL, int UB, int IB, int fe,
                int stage_f4, int soft_margin) {
  constexpr int kThreads = threads_of(SPW, kOne);
  constexpr int kWarps = kThreads / 32;
  constexpr int kLanes = 32 / SPW;            // lanes per slot
  constexpr int kStep = kWarps * SPW;         // slots per pass of the block
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncta = kOne ? 1 : gridDim.x;
  const int rank = kOne ? 0 : blockIdx.x;
  const int fe4 = fe >> 2;
  const int Cw = (C + 7) & ~7;
  const int RK = RL + 3 * Cw;                 // a chunk's table row
  const int cs = (C + ncta - 1) / ncta;       // slots a CTA
  const int s_lo = min(C, rank * cs);
  const int ns = min(C, s_lo + cs) - s_lo;    // this CTA's slots
  // [6][fe] rates | [3][6C] chunk buffers | [3][RK] runs and codes |
  // [2][fe4] live float4s and [2][fe4] their pieces (rounded to 16 bytes)
  // | the owner scatter's stage (this CTA's part)
  float* s_rate = reinterpret_cast<float*>(smem);
  int32_t* s_buf = reinterpret_cast<int32_t*>(s_rate + 6 * fe);
  uint16_t* s_seg = reinterpret_cast<uint16_t*>(s_buf + 18 * C);
  int32_t* s_live = reinterpret_cast<int32_t*>(s_seg + 3 * RK);
  int32_t* s_li = s_live + 2 * fe4;
  float4* s_stage = reinterpret_cast<float4*>(s_live + ((4 * fe4 + 3) & ~3));
  // per buffer: the chunk's ub, ib and jb, and the packed row of the chunk
  // two after it
  __shared__ int32_t s_meta[3][4];
  __shared__ int s_nlive[2];
  __shared__ int s_runs[2];        // this CTA's runs [k0, k1) of a chunk
  // each CTA's stage (and past the last, none)
  __shared__ float4* s_part[kMaxCluster + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = lane / kLanes;             // this lane's slot of a pass
  const int sub = lane % kLanes;              // its float4s: sub + kLanes v
  for (int t = tid; t < fe * 6; t += kThreads)
    s_rate[(t % 6) * fe + t / 6] = rates[t];
  if (tid <= kMaxCluster)
    s_part[tid] = tid < ncta ? cooperative_groups::this_cluster()
                                   .map_shared_rank(s_stage, tid)
                             : nullptr;

  // chunk k's packed row r, its neg and segment rows, its (ub, ib, jb)
  // and the packed row of chunk k+2 into buffer b
  auto prefetch = [&](int k, int64_t r, int b) {
    const int32_t* prow = packed + r * 4 * C;
    const int32_t* nrow = neg + (int64_t)k * 2 * C;
    const uint16_t* srow = segs + (int64_t)k * RK;
    int32_t* dst = s_buf + b * 6 * C;
    for (int e = tid; e < C; e += kThreads)
      mml_owner::cp_async16(dst + 4 * e, prow + 4 * e);
    for (int e = tid; e < C / 2; e += kThreads)
      mml_owner::cp_async16(dst + 4 * C + 4 * e, nrow + 4 * e);
    for (int e = tid; e < RK / 8; e += kThreads)
      mml_owner::cp_async16(s_seg + b * RK + 8 * e, srow + 8 * e);
    if (tid == 0) {
      cp_async4(&s_meta[b][0], order_ub + k);
      cp_async4(&s_meta[b][1], order_ib + k);
      cp_async4(&s_meta[b][2], jb_v + k);
      if (k + 2 < nc) cp_async4(&s_meta[b][3], order_row + k + 2);
    }
  };

  if (nc > 0) prefetch(0, __ldg(order_row), 0);
  if (nc > 1) prefetch(1, __ldg(order_row + 1), 1);
  cp_async_commit();
  __syncthreads();
  const float4* r4 = reinterpret_cast<const float4*>(s_rate);  // [6][fe4]
  if (tid < 2) {
    int n = 0;
    for (int c4 = 0; c4 < fe4; ++c4) {
      s_li[tid * fe4 + c4] = n;
      if (tid == 0 ? f4_any(r4[0 * fe4 + c4])
                   : f4_any(r4[2 * fe4 + c4]) || f4_any(r4[4 * fe4 + c4]))
        s_live[tid * fe4 + n++] = c4;
    }
    s_nlive[tid] = n;
  }
  // the first chunk's wait: every CTA of the cluster runs (its stage may
  // be written), the live lists are set, and the copies of chunks 0 and 1
  // have landed
  mml_cluster::arrive_copied(ncta);

  for (int k = 0; k < nc; ++k) {
    const int b = k % 3;
    // chunk k's buffer has landed in every thread, with the packed row of
    // chunk k+2; the previous chunk's stores are visible to this chunk's
    // gathers, and its stage is read (see the note at the top)
    cluster_wait(ncta);
    // chunk k+2's buffer into the one chunk k-1 used: in one CTA now, in
    // a cluster while the other CTAs finish phase 1
    auto next_chunk = [&]() {
      if (k + 2 < nc) prefetch(k + 2, s_meta[b][3], (k + 2) % 3);
      cp_async_commit();
    };
    if (ncta == 1) next_chunk();
    const int32_t* sd = s_buf + b * 6 * C;
    const uint16_t* runs = s_seg + b * RK;
    const uint16_t* codes = runs + RL;          // [3][Cw]: W, i, j
    const int64_t wbase = (int64_t)s_meta[b][0] * UB;
    const int64_t ibase = (int64_t)s_meta[b][1] * IB;
    const int64_t jbase = (int64_t)s_meta[b][2] * IB;
    const mml_cluster::ClusterStage st = mml_cluster::cluster_stage(
        runs, 3u, s_nlive[0], s_nlive[1], ncta, rank, s_part, s_stage,
        scratch, stage_f4);
    // this CTA's runs of phase 2, those whose first value lies in its part
    // of the stage, found by one thread while its first pass's loads are
    // in flight
    const int nr = (int)runs[0] + (int)runs[1];
    const bool searcher = ncta > 1 && st.on_chip && tid == kThreads - 32;
    bool searched = false;
    auto find_runs = [&]() {
      mml_cluster::find_runs(runs, st, 0, nr, s_runs);
      searched = true;
    };

    // phase 1: gather and gradient, G passes' row loads issued before any
    // is used; the pass loop is uniform across the warp (its shuffles
    // need every lane), slots past this CTA's weigh 0
    for (int p0 = warp * SPW; p0 < ns; p0 += kStep * G) {
      const int j0 = p0 + half;
      float4 wu[G][V], hi[G][V], hj[G][V];
      float wgt[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = j0 + g * kStep;
        const int s = s_lo + j;
        wgt[g] = j < ns ? slot_weight(sd, C, s) : 0.f;
        const bool live = wgt[g] != 0.f;    // else rows 0, not read
        const float4* wrow = reinterpret_cast<const float4*>(
            W + (live ? wbase + sd[s] : 0) * fe);
        const float4* irow = reinterpret_cast<const float4*>(
            H + (live ? ibase + sd[C + s] : 0) * fe);
        const float4* jrow = reinterpret_cast<const float4*>(
            H + (live ? jbase + sd[4 * C + s] : 0) * fe);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c4 = sub + kLanes * v;
          const bool ld = live && c4 < fe4;
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          wu[g][v] = ld ? __ldcg(wrow + c4) : z;
          hi[g][v] = ld ? __ldcg(irow + c4) : z;
          hj[g][v] = ld ? __ldcg(jrow + c4) : z;
        }
      }
      if (searcher && !searched) find_runs();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float4 d = f4_sub(hi[g][v], hj[g][v]);
          x = fmaf(wu[g][v].x, d.x, x);
          x = fmaf(wu[g][v].y, d.y, x);
          x = fmaf(wu[g][v].z, d.z, x);
          x = fmaf(wu[g][v].w, d.w, x);
        }
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1)
          x += __shfl_xor_sync(kFull, x, o);
        const int s = s_lo + j0 + g * kStep;
        if (wgt[g] == 0.f) continue;          // padding or no negative
        const float gr = soft_margin ? (x < 1.f ? wgt[g] : 0.f)
                                     : wgt[g] / (1.f + expf(x));
        const uint16_t wcode = codes[s], icode = codes[Cw + s],
                       jcode = codes[2 * Cw + s];
        float4* wrow = reinterpret_cast<float4*>(W + (wbase + sd[s]) * fe);
        float4* irow = reinterpret_cast<float4*>(H + (ibase + sd[C + s]) * fe);
        float4* jrow =
            reinterpret_cast<float4*>(H + (jbase + sd[4 * C + s]) * fe);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c4 = sub + kLanes * v;
          if (c4 >= fe4) continue;
          const float4 ng = make_float4(-wu[g][v].x, -wu[g][v].y,
                                        -wu[g][v].z, -wu[g][v].w);
          if (f4_any(r4[0 * fe4 + c4]))
            put(wcode, st, s_li[c4], wrow + c4, wu[g][v],
                f4_delta(r4[0 * fe4 + c4], gr, f4_sub(hi[g][v], hj[g][v]),
                         wgt[g], r4[1 * fe4 + c4], wu[g][v]));
          if (f4_any(r4[2 * fe4 + c4]) || f4_any(r4[4 * fe4 + c4])) {
            const int li = s_li[fe4 + c4];
            put(icode, st, li, irow + c4, hi[g][v],
                f4_delta(r4[2 * fe4 + c4], gr, wu[g][v], wgt[g],
                         r4[3 * fe4 + c4], hi[g][v]));
            put(jcode, st, li, jrow + c4, hj[g][v],
                f4_delta(r4[4 * fe4 + c4], gr, ng, wgt[g], r4[5 * fe4 + c4],
                         hj[g][v]));
          }
        }
      }
    }

    if (searcher && !searched) find_runs();

    // phase 2: each run of a W or H row summed in entry order. Over the
    // cluster where the stage is on chip; else in CTA 0 by owner_chain,
    // whose first barrier ends phase 1 in a cluster of one: the stage in
    // its shared memory, or the values in the global scratch
    const BprPieces pc{W, H, sd, s_live, wbase, ibase, jbase, C, fe, fe4};
    // this thread's phase 1, and its copies of chunk k+1 (issued a chunk
    // ago; in one CTA, with those of chunk k+2, issued at this chunk's
    // start)
    mml_cluster::arrive_copied(ncta);
    if (ncta > 1) {
      next_chunk();
      cluster_wait(ncta);
    }
    if (ncta > 1 && st.on_chip) {
      mml_cluster::cluster_sums<kThreads>(runs, st, s_runs[0], s_runs[1],
                                          pc);
    } else if (rank == 0) {
      mml_owner::owner_chain(runs, 3u, st.block(), s_stage, stage_f4, pc);
    }
    cluster_arrive(ncta);                     // this thread's phase 2
  }
  // no CTA leaves while another may read its stage
  cluster_wait(ncta);
}

template <int V, int SPW, int G, class... Args>
int launch(int cluster, int smem, cudaStream_t st, Args... args) {
  return mml_cluster::launch_cluster(
      cluster == 1 ? &bpr_walk_kernel<V, SPW, G, true>
                   : &bpr_walk_kernel<V, SPW, G, false>,
      cluster, threads_of(SPW, cluster == 1), smem, st, args...);
}

// the lanes of a slot from the width, as the one-block walk chose them
template <class... Args>
int launch_width(int fe, Args... args) {
  if (fe <= 64) return launch<1, 2, 2>(args...);
  if (fe <= 128) return launch<1, 1, 2>(args...);
  return launch<2, 1, 1>(args...);
}

// the sampling kernel over the nc visited chunks
int launch_sample(const int32_t* packed, const int32_t* order_ib,
                  const int32_t* order_row, const int32_t* jb,
                  const int32_t* nval, const int32_t* bkt,
                  const int32_t* keys, const void* bitmask, const float* cdf,
                  const int32_t* bits, int32_t* neg_out, uint16_t* seg,
                  int nc, int C, int RL, int UB, int IB, int trials, int kcap,
                  int wbpr, int membership, cudaStream_t st) {
  const int L = (3 * C + 7) & ~7;           // the list's entries
  const int R = RL + 3 * ((C + 7) & ~7);    // a chunk's table row
  int N = 1;
  while (N < L) N <<= 1;
  const int sample_smem = N * 8;
  cudaError_t err = cudaFuncSetAttribute(
      bpr_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sample_smem);
  if (err != cudaSuccess) return (int)err;
  bpr_sample_kernel<<<nc, kSampleThreads, sample_smem, st>>>(
      packed, order_row, order_ib, jb, nval, bkt, keys,
      static_cast<const unsigned char*>(bitmask), cdf, bits, neg_out, seg,
      C, L, RL, R, N, UB, IB, trials, kcap, wbpr, membership);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). Launch on `stream`, do not synchronise,
// and return the first CUDA error of the launches. Chunk k's positive
// block is order_ib[k] and its negative block jb[k], absolute item blocks
// on either schedule. membership: 0 reads the key rows `keys` [*, kcap], 1
// the bitmask, 2 the sub-bucketed key rows `keys` [n_bkt * 8, kcap]; `cdf`
// is read when wbpr is 1; `neg_out` [nc, 2, C] receives every slot's
// negative and `seg_out` [nc, RL + 3 Cw] every chunk's segment table (its
// runs [RL], then the codes [3, Cw], Cw = C rounded up to 8), both read by
// the walk; `scratch` holds 3 * C * fe floats; fe is a multiple of 4, at
// most 256, C a multiple of 4 and at most 4096. The walk is one cluster
// of `cluster` CTAs (1 to 16), each with `smem` bytes of dynamic shared
// memory, its part of the stage what is left past 24 fe + 72 C + 6 (RL +
// 3 Cw) + 16 (fe / 4) (rounded to 16) bytes, at least one row; -2 back
// where the card cannot place the cluster. ops/bpr_epoch.py checks all
// and sizes smem.
extern "C" int mml_bpr_epoch(float* W, float* H, const int32_t* packed,
                             const int32_t* order_ub, const int32_t* order_ib,
                             const int32_t* order_row, const int32_t* jb,
                             const int32_t* nval, const int32_t* bkt,
                             const int32_t* keys, const void* bitmask,
                             const float* cdf, const int32_t* bits,
                             const float* rates, float* scratch,
                             int32_t* neg_out, void* seg_out, int nc, int C,
                             int RL, int UB, int IB, int fe, int trials,
                             int kcap, int soft_margin, int wbpr,
                             int membership, int smem, int cluster,
                             void* stream) {
  if (nc == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint16_t* seg = static_cast<uint16_t*>(seg_out);
  int rc = launch_sample(packed, order_ib, order_row, jb, nval, bkt, keys,
                         bitmask, cdf, bits, neg_out, seg, nc, C, RL, UB, IB,
                         trials, kcap, wbpr, membership, st);
  if (rc != (int)cudaSuccess) return rc;

  const int fe4 = fe / 4;
  const int RK = RL + 3 * ((C + 7) & ~7);
  const int fixed = 24 * fe + 72 * C + 6 * RK + 4 * ((4 * fe4 + 3) & ~3);
  const int stage_f4 = (smem - fixed) / 16;
  if (stage_f4 < fe4) return (int)cudaErrorInvalidValue;
  float4* sc = reinterpret_cast<float4*>(scratch);
  return launch_width(fe, cluster, smem, st, W, H, packed, order_ub,
                      order_ib, order_row, jb, neg_out, seg, rates, sc, nc,
                      C, RL, UB, IB, fe, stage_f4, soft_margin);
}

// The sampling kernel of mml_bpr_epoch alone (no walk), into neg_out and
// seg_out as there: what ops/bpr_epoch.py sampler_tables returns, to hold
// the tables the walk reads against their plain builder.
extern "C" int mml_bpr_sample(const int32_t* packed, const int32_t* order_ib,
                              const int32_t* order_row, const int32_t* jb,
                              const int32_t* nval, const int32_t* bkt,
                              const int32_t* keys, const void* bitmask,
                              const float* cdf, const int32_t* bits,
                              int32_t* neg_out, void* seg_out, int nc, int C,
                              int RL, int UB, int IB, int trials, int kcap,
                              int wbpr, int membership, void* stream) {
  if (nc == 0) return (int)cudaSuccess;
  return launch_sample(packed, order_ib, order_row, jb, nval, bkt, keys,
                       bitmask, cdf, bits, neg_out,
                       static_cast<uint16_t*>(seg_out), nc, C, RL, UB, IB,
                       trials, kcap, wbpr, membership,
                       static_cast<cudaStream_t>(stream));
}
