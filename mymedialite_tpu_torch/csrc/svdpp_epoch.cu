// One SVD++ epoch over the static S/R/Y schedule, in one launch.
//
// Replaces mymedialite_tpu/ops/pallas_svdpp.py:308 _svdpp_kernel (called
// by svdpp_epoch_mxu :460). Same semantics: the schedule visits each user
// block once, its chunks contiguous, in three phases, and every chunk of C
// slots is one minibatch step (all slots read the rows as they stood
// before the chunk; duplicates within a chunk sum; padded slots, weight 0,
// contribute nothing). Per user block, with s and c zeroed when the block
// starts:
//
//   S (edge chunk):   s[u] += wt * Y[i]
//   R (rating chunk): su = W[u] + mf * s[u] * inv_u   (inv_u = W[u, F+2])
//                     score = <su, Q[i]>; plain: g = (v - score - gb) * wt,
//                     sigmoid: the loss gradient at min + sig(score + gb) *
//                     range, times wt
//                     W[u] += w_lr * (g * Q[i] - wt * w_reg * W[u])
//                     Q[i] += q_lr * (g * su - wt * q_reg * Q[i])
//                     c[u] += mf * g * inv_u * Q[i];  n[u] += wt
//   Y (edge chunk):   Y[i] += y_lr * wt * (mf * c[u] - n[u] * y_reg * Y[i])
//
// with the per-column rates [fe, 8] (w_lr, w_reg, q_lr, q_reg, mf, -, y_lr,
// y_reg) of ops/svdpp_plan.py svdpp_mxu_rates, mf being 1 on the F factor
// columns and 0 elsewhere. n[u] is the TPU kernel's c[u, F], the rating
// count. The float32 expressions are the plain version's, term by term
// (ops/svdpp_epoch.py svdpp_epoch_reference), and every sum, of s, W, c,
// n, Q and Y, adds a row's deltas in slot order (owner_scatter.cuh), the
// order of the plain version's index_add_ on the CPU.
//
// The TPU idioms are not carried over: the one-hot matmul gathers and
// scatters, bf16 operands, the transposed [fe, rows] tables, the VMEM
// copies of Q and Y with their DMA semaphores, the passes, the pad chunk
// and the refetch flags. On Hopper a gather is an indexed load, straight
// on the row-major tables in device memory, a scatter the owner scatter,
// and the kernel reads the schedule (ph, ub, ib, row) itself.
//
// The walk. Q and Y are shared by every user block and each step depends
// on the one before (the schedule's order is the trajectory the JAX
// package trains), so the parallelism is within a step (C slots x fe
// columns). A step's time is its chain of dependent round trips to L2 and
// the L2 traffic of the SMs that run it, not HBM bandwidth. The design
// shortens that chain and changes no value:
// - A step spreads over a thread-block cluster of N CTAs on neighbouring SMs
//   (one cluster is the whole grid; N from the shape, ops/cluster.py
//   cluster_size): CTA r takes slots [r cs, (r + 1) cs), cs = ceil(C / N), in
//   every phase, so a round of row loads is spread over N SMs (a CTA of 512
//   threads up to 64 columns, threads_of: its 64 slots of a step fill one
//   pass, with no register spilled). Each CTA holds the step's whole packed
//   chunk and segment table (phase 2 needs any slot's row); the chunk and
//   table of the next step are copied into a second buffer with cp.async
//   while this step runs, with the schedule row of the step after it, so that
//   no global load but the gathers is on a step's path.
// - a row is cut into float4s, one per lane (two per lane past 128
//   columns): at fe <= 32 eight lanes serve a row and a warp four slots
//   per pass, at fe <= 64 two, and each warp issues the loads of two
//   passes before it uses any;
// - s, c and n hold only the columns that are ever read: s [UB][Fp], the
//   F factor columns rounded up to 4 floats, and cn [UB][Fp + 4], c's
//   columns then n in column Fp. They are summed in a global scratch
//   (L2-resident). When the user block changes, each CTA zeroes its
//   stripe of them (st.global.cg) and the cluster meets at a barrier
//   before any slot reads them. The sums a phase reads are final when it
//   starts (no R step adds to s, no Y step to c or n), so where one
//   [UB][Fp + 4] table fits beside the rates, the two chunk buffers and
//   the CTA's part of the stage, every CTA copies the whole of s on chip
//   at the first R step of a block and c and n at the first Y step, and
//   the phase reads them there; past that R and Y read them through L2.
//   The wrapper picks the variant from the shape (ops/svdpp_epoch.py
//   accumulator_variant);
// - each slot's values for the owner scatter (s in S; W, then c and n,
//   by user and Q by item in R; Y in Y) go to the stage, except a row
//   alone in its run, which phase 1 writes itself: S and R read the first
//   entry's s or cn row for it. The stage lies over the cluster's shared
//   memory, striped by compact index, and CTA r sums the runs whose first
//   value lies in its part (cluster_scatter.cuh; table 0 is s in S, W's
//   live float4s and the cn row in R; table 1 is Q in R and Y in Y);
// - a float4 whose learning rates are all 0 is neither stored nor summed:
//   its deltas are exactly 0 (the constant and padding columns).
// A step, in each CTA: wait for the cluster; issue the next step's
// copies; at a new user block zero the stripe and meet; at a new R or Y
// phase copy s or cn on chip; phase 1; wait for this thread's copies of
// the next step, arrive and wait; phase 2 (the sums); arrive. A cluster
// of one is compiled apart (kOne), so that the cluster's state takes no
// registers there, and sums with owner_scatter.cuh's owner_chain, whose
// barrier ends phase 1: the one-block walk. Where a step's values do not
// fit the CTAs' stages they go to the global scratch and CTA 0 sums them
// with owner_chain.
//
// Why the tables equal the one-block walk's bit for bit: every slot's dot
// is the same fmaf chain over its lanes' float4s and the same shuffle
// tree (the lanes of a slot, SPW, V and G are chosen from fe as before),
// its su, gradient, ginv and S / R / Y deltas the same expressions; each
// run's sum is the same left fold in list order (the stage's place of a
// value changes, not the order); and each value read is the value the
// one-block walk reads (the barriers below). Nothing is added atomically.
// (The tests hold the tables to digests of the one-block kernel's:
// tests/test_torch_cuda.py SVDPP_ONE_BLOCK_SHA256.)
//
// Ordering (cluster_scatter.cuh). The chunk-start wait follows every
// thread's arrive after the previous step's phase 2, so the owners'
// st.global.cg stores of step k-1 in one CTA (the tables, and s, c and n
// in the scratch) precede step k's gathers in another: a run's first
// entry reads the s row (S) or the cn row (R) that another CTA's owner
// stored in an earlier step. Each thread's copies of step k (its chunk,
// its segment table, and thread 0's ph, ub, ib and the schedule row of
// step k+1) complete before its arrive after phase 1 of step k-1 (the
// prologue's for step 0), so the wait that follows makes them visible to
// every thread. The zeroing's barrier orders each CTA's
// stripe of zeros before any read of s, c or n in the block, the copy on
// chip included. The arrive and wait between the phases order the
// stage's remote stores of phase 1 before phase 2's reads. The kernel
// ends with a wait, so that no CTA leaves while another reads its stage.
// A __threadfence() orders writes for observers outside the cluster, and
// there are none during the walk.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster_scatter.cuh"

namespace {

using mml_cluster::cluster_arrive;
using mml_cluster::cluster_barrier;
using mml_cluster::cluster_wait;
using mml_cluster::cp_async4;
using mml_cluster::cp_async_commit;
using mml_cluster::kMaxCluster;
using mml_cluster::put;

// A CTA's threads: 1024 in a cluster of one (the one-block walk); in a
// cluster of several, 512 where a warp serves two or more slots a pass:
// the CTA's share of a step of 512 slots then fills one pass of its
// warps, and each thread has 128 registers, where 1024 threads have 64
// and spill. Past 64 columns (a slot a warp) 1024.
__host__ __device__ constexpr int threads_of(int SPW, bool kOne) {
  return kOne || SPW == 1 ? 1024 : 512;
}
constexpr unsigned kFull = 0xffffffffu;

constexpr int kLossRmse = 0;
constexpr int kLossMae = 1;

constexpr int kPhaseS = 0;
constexpr int kPhaseR = 1;

// rate rows of the shared rate table [8][fe]
constexpr int kWLr = 0, kWReg = 1, kQLr = 2, kQReg = 3, kMf = 4, kYLr = 6,
              kYReg = 7;

__device__ __forceinline__ bool f4_any(float4 a) {
  return a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f;
}

// r * (g * a - wt * reg * b), component by component
__device__ __forceinline__ float4 f4_delta(float4 r, float g, float4 a,
                                           float wt, float4 reg, float4 b) {
  return make_float4(r.x * (g * a.x - wt * reg.x * b.x),
                     r.y * (g * a.y - wt * reg.y * b.y),
                     r.z * (g * a.z - wt * reg.z * b.z),
                     r.w * (g * a.w - wt * reg.w * b.w));
}

// v on the columns first + j < F, 0 past them
__device__ __forceinline__ float4 f4_first(float4 v, int first, int F) {
  return make_float4(first < F ? v.x : 0.f, first + 1 < F ? v.y : 0.f,
                     first + 2 < F ? v.z : 0.f, first + 3 < F ? v.w : 0.f);
}

// the finished sums: on chip, plain loads; in the global scratch, through
// L2
template <bool kShared>
__device__ __forceinline__ float4 acc_load4(const float* p) {
  if constexpr (kShared) return *reinterpret_cast<const float4*>(p);
  else return __ldcg(reinterpret_cast<const float4*>(p));
}

template <bool kShared>
__device__ __forceinline__ float acc_load(const float* p) {
  if constexpr (kShared) return *p;
  else return __ldcg(p);
}

// Where piece li of an entry of the owner scatter goes. Table 0 (the user
// list): in S the s row's Fp / 4 float4s; in R the W row's live float4s,
// then the cn row's (Fp + 4) / 4. Table 1 (the item list): in R the Q
// row's live float4s, in Y the Y row's.
struct SvdppPieces {
  float* W;
  float* Q;
  float* Y;
  float* s_acc;             // [UB][Fp]
  float* cn_acc;            // [UB][Fq]
  const int32_t* sd;        // the step's packed chunk in shared memory
  const int32_t* live;      // [3][fe4]: the live float4s of W, Q, Y
  int nlive_w;
  int64_t wbase, ibase;
  int phase, C, fe, fe4, Fp, Fq;
  __device__ float4* dst(int t, int id, int li) const {
    float* p;
    if (phase == kPhaseS) p = s_acc + (size_t)sd[id] * Fp + 4 * li;
    else if (phase != kPhaseR)
      p = Y + (ibase + sd[C + id]) * fe + 4 * live[2 * fe4 + li];
    else if (t) p = Q + (ibase + sd[C + id]) * fe + 4 * live[fe4 + li];
    else if (li < nlive_w) p = W + (wbase + sd[id]) * fe + 4 * live[li];
    else p = cn_acc + (size_t)sd[id] * Fq + 4 * (li - nlive_w);
    return reinterpret_cast<float4*>(p);
  }
};

// V float4s per lane per row (fe <= 128 V), SPW slots per warp pass (a
// slot on 32 / SPW lanes), G passes in flight per warp; kShared: R reads
// s and Y reads c and n from an on-chip copy, else from the global
// scratch where they are summed. One cluster of gridDim.x CTAs; kOne: a
// cluster of one, compiled apart so that the cluster's state takes no
// registers there.
template <int V, int SPW, int G, bool kShared, bool kOne>
__global__ void __launch_bounds__(threads_of(SPW, kOne), 1)
svdpp_epoch_kernel(float* __restrict__ W, float* __restrict__ Q,
                   float* __restrict__ Y, const int32_t* __restrict__ packed,
                   const uint16_t* __restrict__ segs,
                   const int32_t* __restrict__ sched_ph,
                   const int32_t* __restrict__ sched_ub,
                   const int32_t* __restrict__ sched_ib,
                   const int32_t* __restrict__ sched_row,
                   const float* __restrict__ rates,
                   float* __restrict__ scratch, int n_steps, int C, int RL,
                   int UB, int IB, int fe, int F, int stage_f4,
                   float gb, float min_rating, float rating_range, int loss,
                   int sigmoid) {
  constexpr int kThreads = threads_of(SPW, kOne);
  constexpr int kWarps = kThreads / 32;
  constexpr int kLanes = 32 / SPW;            // lanes per slot
  constexpr int kStep = kWarps * SPW;         // slots per pass of the block
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncta = kOne ? 1 : gridDim.x;
  const int rank = kOne ? 0 : blockIdx.x;
  const int fe4 = fe >> 2;
  const int Fp = (F + 3) & ~3;                // an s row, in floats
  const int Fp4 = Fp >> 2;
  const int Fq = Fp + 4;                      // a cn row: c, then n at Fp
  const int Fq4 = Fq >> 2;
  const int Cw = (C + 7) & ~7;
  const int RK = RL + 2 * Cw;                 // a chunk's table row
  const int cs = (C + ncta - 1) / ncta;       // slots a CTA
  const int s_lo = min(C, rank * cs);
  const int ns = min(C, s_lo + cs) - s_lo;    // this CTA's slots
  // [8][fe] rates | [2][4C] packed chunks | [2][RK] runs and codes |
  // [3][fe4] live float4s and [3][fe4] their pieces (rounded to 16 bytes)
  // | kShared: the on-chip copy [UB][Fq] | the owner scatter's stage (this
  // CTA's part)
  float* s_rate = reinterpret_cast<float*>(smem);
  int32_t* s_buf = reinterpret_cast<int32_t*>(s_rate + 8 * fe);
  uint16_t* s_seg = reinterpret_cast<uint16_t*>(s_buf + 8 * C);
  int32_t* s_live = reinterpret_cast<int32_t*>(s_seg + 2 * RK);
  int32_t* s_li = s_live + 3 * fe4;
  float* sh_a = reinterpret_cast<float*>(s_live + ((6 * fe4 + 3) & ~3));
  float4* s_stage =
      reinterpret_cast<float4*>(sh_a + (kShared ? (size_t)UB * Fq : 0));
  // per buffer: the step's ph, ub and ib, and the schedule row of the step
  // after it
  __shared__ int32_t s_meta[2][4];
  __shared__ int s_nlive[3];
  __shared__ int s_runs[2];        // this CTA's runs [k0, k1) of a step
  // each CTA's stage (and past the last, none)
  __shared__ float4* s_part[kMaxCluster + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = lane / kLanes;             // this lane's slot of a pass
  const int sub = lane % kLanes;              // its float4s: sub + kLanes v
  for (int t = tid; t < fe * 8; t += kThreads)
    s_rate[(t % 8) * fe + t / 8] = rates[t];
  if (tid <= kMaxCluster)
    s_part[tid] = tid < ncta ? cooperative_groups::this_cluster()
                                   .map_shared_rank(s_stage, tid)
                             : nullptr;
  // the scratch: the owner scatter's values where they do not fit the
  // stage ([C][2 fe + Fq] floats), then the sums s [UB][Fp], cn [UB][Fq]
  float4* fallback = reinterpret_cast<float4*>(scratch);
  float* s_acc = scratch + (size_t)C * (2 * fe + Fq);
  float* cn_acc = s_acc + (size_t)UB * Fp;
  const int acc_len = UB * (Fp + Fq);
  const int zl = (acc_len + ncta - 1) / ncta;   // a CTA's stripe of zeros
  const float* s_read = kShared ? sh_a : s_acc;
  const float* c_read = kShared ? sh_a : cn_acc;

  // step k's (ph, ub, ib), chunk r (its packed row and segment table) and
  // the schedule row of step k+1 into buffer b
  auto prefetch = [&](int k, int64_t r, int b) {
    const int32_t* prow = packed + r * 4 * C;
    int32_t* dst = s_buf + b * 4 * C;
    for (int e = tid; e < C; e += kThreads)
      mml_owner::cp_async16(dst + 4 * e, prow + 4 * e);
    const uint16_t* srow = segs + r * RK;
    for (int e = tid; e < RK / 8; e += kThreads)
      mml_owner::cp_async16(s_seg + b * RK + 8 * e, srow + 8 * e);
    if (tid == 0) {
      cp_async4(&s_meta[b][0], sched_ph + k);
      cp_async4(&s_meta[b][1], sched_ub + k);
      cp_async4(&s_meta[b][2], sched_ib + k);
      if (k + 1 < n_steps) cp_async4(&s_meta[b][3], sched_row + k + 1);
    }
  };
  if (n_steps > 0) prefetch(0, __ldg(sched_row), 0);
  cp_async_commit();
  __syncthreads();
  const float4* r4 = reinterpret_cast<const float4*>(s_rate);  // [8][fe4]
  if (tid < 3) {
    const int lr = tid == 0 ? kWLr : tid == 1 ? kQLr : kYLr;
    int n = 0;
    for (int c4 = 0; c4 < fe4; ++c4) {
      s_li[tid * fe4 + c4] = n;
      if (f4_any(r4[lr * fe4 + c4])) s_live[tid * fe4 + n++] = c4;
    }
    s_nlive[tid] = n;
  }
  // the first step's wait: every CTA of the cluster runs (its stage may
  // be written), the live lists are set, and step 0's copies have landed
  mml_cluster::arrive_copied(ncta);

  int prev_ub = -1, prev_phase = -1;
  for (int k = 0; k < n_steps; ++k) {
    const int b = k & 1;
    // step k's chunk, its table and its schedule entries have landed in
    // every thread; everything the previous step wrote is visible to this
    // one, and its stage is read (see the note at the top)
    cluster_wait(ncta);
    if (k + 1 < n_steps) prefetch(k + 1, s_meta[b][3], b ^ 1);
    cp_async_commit();
    const int32_t* sd = s_buf + b * 4 * C;
    const uint16_t* runs = s_seg + b * RK;
    const uint16_t* codes = runs + RL;          // [2][Cw]: users, items
    const int phase = s_meta[b][0];
    const int ub = s_meta[b][1];
    const int64_t wbase = (int64_t)ub * UB;
    const int64_t ibase = (int64_t)s_meta[b][2] * IB;
    if (ub != prev_ub) {
      // a new user block: s, c and n start from zero, each CTA its stripe
      const int z1 = min(acc_len, (rank + 1) * zl);
      for (int t = rank * zl + tid; t < z1; t += kThreads)
        __stcg(s_acc + t, 0.f);
      prev_ub = ub;
      prev_phase = -1;
      cluster_barrier(ncta);
    }
    if constexpr (kShared) {
      if (phase != prev_phase && phase != kPhaseS) {
        // the sums R or Y read are final (no step of this phase adds to
        // them): copy them on chip once, the whole table in every CTA
        const float4* src = reinterpret_cast<const float4*>(
            phase == kPhaseR ? s_acc : cn_acc);
        const int n4 = UB * (phase == kPhaseR ? Fp4 : Fq4);
        for (int t = tid; t < n4; t += kThreads)
          reinterpret_cast<float4*>(sh_a)[t] = __ldcg(src + t);
        __syncthreads();
      }
    }
    prev_phase = phase;
    // the owner scatter: S sums s by user, R W, c and n by user and Q by
    // item, Y Y by item
    const unsigned sides = phase == kPhaseS ? 1u : phase == kPhaseR ? 3u : 2u;
    const mml_cluster::ClusterStage stg = mml_cluster::cluster_stage(
        runs, sides,
        phase == kPhaseS ? Fp4 : phase == kPhaseR ? s_nlive[0] + Fq4 : 0,
        phase == kPhaseR ? s_nlive[1] : s_nlive[2], ncta, rank, s_part,
        s_stage, fallback, stage_f4);
    // this CTA's runs of phase 2, those whose first value lies in its part
    // of the stage, found by one thread while its first pass's loads are
    // in flight
    const bool searcher = ncta > 1 && stg.on_chip && tid == kThreads - 32;
    bool searched = false;
    auto find_runs = [&]() {
      mml_cluster::find_runs(runs, stg, mml_cluster::runs_lo(runs, sides),
                             mml_cluster::runs_hi(runs, sides), s_runs);
      searched = true;
    };

    // phase 1; the pass loop is uniform across the warp (its shuffles need
    // every lane), slots past this CTA's weigh 0
    if (phase == kPhaseS) {
      // s[u] += wt * Y[i] on the factor columns
      for (int p0 = warp * SPW; p0 < ns; p0 += kStep * G) {
        const int j0 = p0 + half;
        float4 y[G][V], sr[G][V];
        float wt[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int j = j0 + g * kStep;
          const int s = s_lo + j;
          wt[g] = j < ns ? __int_as_float(sd[3 * C + s]) : 0.f;
          const bool live = wt[g] != 0.f;
          // the s row is read where the slot's value starts from it
          const bool first = live && (codes[s] & mml_owner::kStart);
          const float4* yrow = reinterpret_cast<const float4*>(
              Y + (live ? ibase + sd[C + s] : 0) * fe);
          const float4* srow = reinterpret_cast<const float4*>(
              s_acc + (size_t)(first ? sd[s] : 0) * Fp);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            y[g][v] = live && c4 < Fp4 ? __ldcg(yrow + c4) : z;
            sr[g][v] = first && c4 < Fp4 ? __ldcg(srow + c4) : z;
          }
        }
        if (searcher && !searched) find_runs();
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (wt[g] == 0.f) continue;        // padded slot
          const int s = s_lo + j0 + g * kStep;
          const uint16_t code = codes[s];
          float4* srow = reinterpret_cast<float4*>(s_acc + (size_t)sd[s] * Fp);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            const float4 yv = y[g][v];
            if (c4 < Fp4)
              put(code, stg, c4, srow + c4, sr[g][v],
                  f4_first(make_float4(yv.x * wt[g], yv.y * wt[g],
                                       yv.z * wt[g], yv.w * wt[g]),
                           4 * c4, F));
          }
        }
      }
    } else if (phase == kPhaseR) {
      // gather and gradient; every read sees the pre-chunk rows
      for (int p0 = warp * SPW; p0 < ns; p0 += kStep * G) {
        const int j0 = p0 + half;
        float4 wu[G][V], qi[G][V], sa[G][V], cr[G][V];
        float4 nr[G];
        float wt[G], inv[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int j = j0 + g * kStep;
          const int s = s_lo + j;
          wt[g] = j < ns ? __int_as_float(sd[3 * C + s]) : 0.f;
          const bool live = wt[g] != 0.f;
          // the cn row is read where the slot's value starts from it
          const bool first = live && (codes[s] & mml_owner::kStart);
          const float* wrow = W + (live ? wbase + sd[s] : 0) * fe;
          const float4* qrow = reinterpret_cast<const float4*>(
              Q + (live ? ibase + sd[C + s] : 0) * fe);
          const float* srow = s_read + (size_t)(live ? sd[s] : 0) * Fp;
          const float4* crow = reinterpret_cast<const float4*>(
              cn_acc + (size_t)(first ? sd[s] : 0) * Fq);
          inv[g] = live ? __ldcg(wrow + F + 2) : 0.f;
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          nr[g] = first && sub == 0 ? __ldcg(crow + Fp4) : z;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            const bool ld = live && c4 < fe4;
            wu[g][v] = ld ? __ldcg(reinterpret_cast<const float4*>(wrow) + c4)
                          : z;
            qi[g][v] = ld ? __ldcg(qrow + c4) : z;
            sa[g][v] = live && c4 < Fp4 ? acc_load4<kShared>(srow + 4 * c4)
                                        : z;
            cr[g][v] = first && c4 < Fp4 ? __ldcg(crow + c4) : z;
          }
        }
        if (searcher && !searched) find_runs();
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float4 su[V];
          float dot = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            const float4 mf = c4 < fe4 ? r4[kMf * fe4 + c4]
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
            su[v] = make_float4(wu[g][v].x + mf.x * (sa[g][v].x * inv[g]),
                                wu[g][v].y + mf.y * (sa[g][v].y * inv[g]),
                                wu[g][v].z + mf.z * (sa[g][v].z * inv[g]),
                                wu[g][v].w + mf.w * (sa[g][v].w * inv[g]));
            dot = fmaf(su[v].x, qi[g][v].x, dot);
            dot = fmaf(su[v].y, qi[g][v].y, dot);
            dot = fmaf(su[v].z, qi[g][v].z, dot);
            dot = fmaf(su[v].w, qi[g][v].w, dot);
          }
#pragma unroll
          for (int o = kLanes / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(kFull, dot, o);
          if (wt[g] == 0.f) continue;        // padded slot
          const int s = s_lo + j0 + g * kStep;
          const float v_ = __int_as_float(sd[2 * C + s]);
          float gr;
          if (sigmoid) {
            const float sig = 1.f / (1.f + expf(-(dot + gb)));
            const float err = v_ - (min_rating + sig * rating_range);
            if (loss == kLossRmse) {
              gr = err * sig * (1.f - sig) * rating_range;
            } else if (loss == kLossMae) {
              // sign(0) = 0, as jnp.sign
              gr = (float)((err > 0.f) - (err < 0.f)) * sig * (1.f - sig) *
                   rating_range;
            } else {
              gr = err;
            }
          } else {
            gr = v_ - (dot + gb);
          }
          gr *= wt[g];
          const float ginv = gr * inv[g];
          const uint16_t ucode = codes[s], icode = codes[Cw + s];
          const int nw = s_nlive[0];
          float4* wrow = reinterpret_cast<float4*>(W + (wbase + sd[s]) * fe);
          float4* qrow = reinterpret_cast<float4*>(Q + (ibase + sd[C + s]) * fe);
          float4* crow = reinterpret_cast<float4*>(cn_acc + (size_t)sd[s] * Fq);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            if (c4 >= fe4) continue;
            const float4 wl = r4[kWLr * fe4 + c4];
            const float4 ql = r4[kQLr * fe4 + c4];
            if (f4_any(wl))
              put(ucode, stg, s_li[c4], wrow + c4, wu[g][v],
                  f4_delta(wl, gr, qi[g][v], wt[g], r4[kWReg * fe4 + c4],
                           wu[g][v]));
            if (f4_any(ql))
              put(icode, stg, s_li[fe4 + c4], qrow + c4, qi[g][v],
                  f4_delta(ql, gr, su[v], wt[g], r4[kQReg * fe4 + c4],
                           qi[g][v]));
            const float4 mf = r4[kMf * fe4 + c4];
            const float4 q = qi[g][v];
            if (c4 < Fp4)
              put(ucode, stg, nw + c4, crow + c4, cr[g][v],
                  f4_first(make_float4(mf.x * ginv * q.x, mf.y * ginv * q.y,
                                       mf.z * ginv * q.z, mf.w * ginv * q.w),
                           4 * c4, F));
          }
          // n, the cn row's float4 at Fp: (n, 0, 0, 0)
          if (sub == 0)
            put(ucode, stg, nw + Fp4, crow + Fp4, nr[g],
                make_float4(wt[g], 0.f, 0.f, 0.f));
        }
      }
    } else {
      // Y phase: the deltas from the pre-chunk rows
      for (int p0 = warp * SPW; p0 < ns; p0 += kStep * G) {
        const int j0 = p0 + half;
        float4 y[G][V], ca[G][V];
        float wt[G], n[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int j = j0 + g * kStep;
          const int s = s_lo + j;
          wt[g] = j < ns ? __int_as_float(sd[3 * C + s]) : 0.f;
          const bool live = wt[g] != 0.f;
          const float4* yrow = reinterpret_cast<const float4*>(
              Y + (live ? ibase + sd[C + s] : 0) * fe);
          const int u = live ? sd[s] : 0;
          const float* crow = c_read + (size_t)u * Fq;
          n[g] = live ? acc_load<kShared>(crow + Fp) : 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            y[g][v] = live && c4 < fe4 ? __ldcg(yrow + c4) : z;
            ca[g][v] = live && c4 < Fp4 ? acc_load4<kShared>(crow + 4 * c4)
                                        : z;
          }
        }
        if (searcher && !searched) find_runs();
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (wt[g] == 0.f) continue;
          const int s = s_lo + j0 + g * kStep;
          const uint16_t code = codes[Cw + s];
          float4* yrow = reinterpret_cast<float4*>(Y + (ibase + sd[C + s]) * fe);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            if (c4 >= fe4) continue;
            const float4 yl = r4[kYLr * fe4 + c4];
            if (!f4_any(yl)) continue;
            const float4 mf = r4[kMf * fe4 + c4];
            const float4 yr = r4[kYReg * fe4 + c4];
            const float4 c = ca[g][v], yv = y[g][v];
            const float w = wt[g], nn = n[g];
            put(code, stg, s_li[2 * fe4 + c4], yrow + c4, yv,
                make_float4(yl.x * w * (mf.x * c.x - nn * yr.x * yv.x),
                            yl.y * w * (mf.y * c.y - nn * yr.y * yv.y),
                            yl.z * w * (mf.z * c.z - nn * yr.z * yv.z),
                            yl.w * w * (mf.w * c.w - nn * yr.w * yv.w)));
          }
        }
      }
    }

    if (searcher && !searched) find_runs();
    // phase 2: each run of the step's rows summed in slot order, S the
    // user list (s), R both (W, c and n; Q), Y the item list (Y). Over the
    // cluster where the stage is on chip; else in CTA 0 by owner_chain,
    // whose first barrier ends phase 1 in a cluster of one: the stage in
    // its shared memory, or the values in the global scratch
    const SvdppPieces pc{W, Q, Y, s_acc, cn_acc, sd, s_live, s_nlive[0],
                         wbase, ibase, phase, C, fe, fe4, Fp, Fq};
    // this thread's phase 1, and its copies of step k+1 (issued at this
    // step's start)
    mml_cluster::arrive_copied(ncta);
    if (ncta > 1) cluster_wait(ncta);
    if (ncta > 1 && stg.on_chip) {
      mml_cluster::cluster_sums<kThreads>(runs, stg, s_runs[0], s_runs[1],
                                          pc);
    } else if (rank == 0) {
      mml_owner::owner_chain(runs, sides, stg.block(), s_stage, stage_f4,
                             pc);
    }
    cluster_arrive(ncta);                     // this thread's phase 2
  }
  // no CTA leaves while another may read its stage
  cluster_wait(ncta);
}

template <int V, int SPW, int G, bool kShared, class... Args>
int launch(int cluster, int smem, cudaStream_t st, Args... args) {
  return mml_cluster::launch_cluster(
      cluster == 1 ? &svdpp_epoch_kernel<V, SPW, G, kShared, true>
                   : &svdpp_epoch_kernel<V, SPW, G, kShared, false>,
      cluster, threads_of(SPW, cluster == 1), smem, st, args...);
}

// the lanes of a slot from the width, as the one-block walk chose them
template <bool kShared, class... Args>
int launch_width(int fe, Args... args) {
  if (fe <= 32) return launch<1, 4, 2, kShared>(args...);
  if (fe <= 64) return launch<1, 2, 2, kShared>(args...);
  if (fe <= 128) return launch<1, 1, 2, kShared>(args...);
  return launch<2, 1, 1, kShared>(args...);
}

}  // namespace

// C interface (bound with ctypes). Launches one cluster of `cluster` CTAs
// (1 to 16) on `stream`, does not synchronise, and returns the first CUDA
// error of the launch, or -2 where the card cannot place the cluster.
// Step k runs phase sched_ph[k] on chunk sched_row[k] of `packed`,
// touching W rows sched_ub[k] * UB + u_loc and Q/Y rows sched_ib[k] * IB +
// i_loc; `segs` [rows of packed, RL + 2 Cw] holds each chunk's segment
// table (ops/segments.py): the runs [RL], then the codes [2, Cw], Cw = C
// rounded up to 8. `scratch` holds (2 fe + Fp + 4) C + UB (2 Fp + 4)
// floats (Fp = F rounded up to 4): the owner scatter's values where they
// do not fit the stage, then s and cn. shared_acc: R and Y read the sums
// from a copy in shared memory. fe is a multiple of 4, at most 256, C a
// multiple of 4, RL a multiple of 8, and each CTA's shared memory `smem`
// bytes, of which its part of the owner scatter's stage takes what is
// left past 32 fe + 32 C + 4 (RL + 2 Cw) + 24 (fe / 4) (rounded to 16)
// bytes, and 4 UB (Fp + 4) more with shared_acc, and must hold one row of
// the widest step, fe + Fp + 4 floats (ops/svdpp_epoch.py checks all,
// picks shared_acc and sizes smem).
extern "C" int mml_svdpp_epoch(float* W, float* Q, float* Y,
                               const int32_t* packed, const void* segs,
                               const int32_t* sched_ph,
                               const int32_t* sched_ub,
                               const int32_t* sched_ib,
                               const int32_t* sched_row, const float* rates,
                               float* scratch, int n_steps, int C, int RL,
                               int UB, int IB, int fe, int F, int smem,
                               int cluster, float gb, float min_rating,
                               float rating_range, int loss, int sigmoid,
                               int shared_acc, void* stream) {
  if (n_steps == 0) return (int)cudaSuccess;
  const int Fp = (F + 3) & ~3;
  const int fe4 = fe / 4;
  const int RK = RL + 2 * ((C + 7) & ~7);
  const int fixed = 32 * fe + 32 * C + 4 * RK + 4 * ((6 * fe4 + 3) & ~3) +
                    (shared_acc ? 4 * UB * (Fp + 4) : 0);
  const int stage_f4 = (smem - fixed) / 16;
  if (stage_f4 < fe4 + (Fp + 4) / 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* sg = static_cast<const uint16_t*>(segs);
  auto go = [&](auto shared) {
    return launch_width<decltype(shared)::value>(
        fe, cluster, smem, st, W, Q, Y, packed, sg, sched_ph, sched_ub,
        sched_ib, sched_row, rates, scratch, n_steps, C, RL, UB, IB, fe, F,
        stage_f4, gb, min_rating, rating_range, loss, sigmoid);
  };
  return shared_acc ? go(std::true_type{}) : go(std::false_type{});
}
