// One rating-SGD epoch over the chunk plan, in one launch.
//
// Replaces two TPU kernels of the same update, through one entry point:
// - mymedialite_tpu/ops/pallas_sgd.py:324 _mxu_sgd_kernel, the item table
//   resident in VMEM;
// - mymedialite_tpu/ops/pallas_sgd.py:745 _mxu_sgd_tiled_kernel, the
//   slab-tiled schedule for catalogs past the resident bound, with one
//   user block and one item slab in VMEM, swapped by blocking DMA.
// Same update semantics: every chunk of C slots is one minibatch step. All
// slots of a chunk read W and H as they stood before the chunk, the loss
// gradient is taken in closed form, and the user and item deltas are
// added with duplicates summing, each row's in slot order (see
// owner_scatter.cuh). Padded slots (weight 0) contribute nothing.
//
//   biased: pred = min + sigmoid(<w_u, h_i> + gb) * range  (the fused
//           bias columns are inside the dot product)
//   plain:  pred = <w_u, h_i> + gb
//   dW[u] += w_lr * (g * h_i - wt * w_reg * w_u)
//   dH[i] += h_lr * (g * w_u - wt * h_reg * h_i)
//
// The TPU idioms (one-hot matmul gathers/scatters, the [.., C]
// orientation, bf16 operands, the VMEM copy of H, and for the tiled
// schedule the transposed tables, the slab and user-block DMAs, the pad
// chunk, the pass split and the refetch flags) are not carried over: on
// Hopper the gather is an indexed load, straight on the tables in device
// memory, and the scatter a slot-ordered owner scatter. The tiled schedule
// is the same walk over another order: chunks sorted by item slab,
// grouped by user block within a slab, with the absolute item block
// sl * B + ibr formed by the wrapper (ops/sgd_epoch.py sgd_epoch_tiled).
// That order keeps one slab (4 MB at k=40) hot in the 50 MB L2, which
// takes the place of the TPU's slab in VMEM.
//
// What bounds the walk. The chunks run in the JAX order, one after
// another: consecutive chunks share a user or an item block, so chunk k+1
// may read what chunk k writes, and the order is kept because it is the
// trajectory the JAX package trains. A chunk's time is its chain of
// dependent steps (its gathers' round trips to L2, a barrier, the owner
// scatter's sums, a barrier) and the L2 traffic of the SMs that run it,
// not HBM bandwidth. The design shortens that chain and changes no
// value:
// - A chunk spreads over a thread-block cluster of N CTAs on neighbouring
//   SMs (one cluster is the whole grid; N from the shape, ops/sgd_epoch.py
//   cluster_size): CTA r takes slots [r cs, (r + 1) cs), cs = ceil(C / N),
//   so a chunk of 640 is one round of row loads on each of 8 SMs where one
//   block took five. Each CTA holds the chunk's whole packed row and
//   segment table (phase 2 needs any slot's row).
// - The indices run two chunks ahead (three buffers, with the packed row
//   of the chunk two after), so that no global load but the gathers is on
//   a chunk's path.
// What does not pay on this card: copying the next chunk's rows that lie
// on another block than this chunk's into shared memory while this chunk
// runs, by cp.async 16 bytes a piece or by the bulk-copy unit a row a
// copy. An SM holds only so many loads in flight, so the copies take the
// gathers' place in its load unit, and the bulk copies' latency a row is
// longer than a gather round (PERF.md section 6).
// A chunk, in each CTA: wait for the cluster; phase 1 (the gathers, the
// dot, the gradient, the deltas); wait for this thread's index copies of
// chunk k+1, arrive, issue chunk k+2's, wait; phase 2 (the sums); arrive.
// A cluster of one is compiled apart (kOne), so that the cluster's state
// takes no registers there; its index copies go at the chunk's start and
// its phase 2 is owner_scatter.cuh's owner_chain, whose barrier ends
// phase 1: the one-block walk, which measured no slower than the
// parent's.
//
// The stage. As in owner_scatter.cuh, phase 1 writes the value of an
// entry whose row is in no other slot of the chunk (code kDead) as row + d
// straight into the table, and the others (row + d for a run's first
// entry, d for the rest) into a stage by compact index; phase 2 sums each
// run in list order and stores it once (st.global.cg). Here the stage is
// the cluster's distributed shared memory (cluster_scatter.cuh, shared
// with kernels 3-5): float4 o of the chunk's stage
// lies in CTA o / S at o % S, S = ceil(total / N), through the generic
// pointers that cooperative_groups' map_shared_rank gives. CTA r sums the
// runs whose first value lies in its part, reading the tail of a run
// that crosses into the next part remotely. Where S exceeds a CTA's stage
// (a wide table), the values go to the global scratch [2, C, fe] and CTA 0
// sums them with owner_scatter.cuh's owner_chain, by windows, as the
// one-block walk did; a cluster of one sums with owner_chain too.
//
// Why the tables equal the one-block walk's bit for bit: every slot's dot
// is the same fmaf chain over its lanes' float4s and the same shuffle tree
// (the lanes of a slot, SPW, V and G are chosen from fe as before), its
// gradient and deltas the same expressions; each run's sum is the same
// left fold in list order (the stage's place of a value changes, not the
// order); and each value read is the value the one-block walk reads (the
// barriers below). Nothing is added atomically.
// (The tests hold the tables to digests of the one-block kernel's:
// tests/test_torch_cuda.py SGD_ONE_BLOCK_SHA256.)
//
// Ordering. barrier.cluster.arrive (release semantics by default) and
// barrier.cluster.wait (acquire by default), executed by every thread of
// every CTA, order each thread's prior global and shared-memory accesses,
// the distributed shared memory included, before every access that
// follows the wait in any thread of the cluster (PTX ISA, barrier.cluster
// and the memory consistency model's release and acquire patterns at
// cluster scope). So the owners' st.global.cg stores of chunk k-1 in one
// CTA precede chunk k's ld.global.cg gathers and cp.async copies in
// another, and the stage's remote stores of phase 1 precede phase 2's
// reads. Both act at L2, not through a stale L1 line. At the end of a
// chunk a thread arrives once its stores are issued, and waits at the
// start of the next, where it needs the others'. Its cp.async copies of
// chunk k+1 (its buffer, and thread 0's ub, ib and the packed row of
// chunk k+3) complete before its arrive after phase 1 of chunk k (the
// prologue's for chunks 0 and 1), so the wait that follows makes them
// visible to every thread: chunk k+1 reads that row to issue chunk k+3's
// copies. With N = 1 the wait is bar.sync, which orders the
// block's accesses the same way within the block, the one-block walk's
// barrier. The kernel ends with a wait, so that no CTA leaves while
// another reads its stage.
// A __threadfence() orders writes for observers outside the cluster, and
// there are none during the walk.
//
// A float4 whose learning rates are all 0 is neither stored nor summed:
// its deltas are exactly 0 (the zero padding of the tables to fe columns,
// and each table's constant column).

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

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kLossRmse = 0;
constexpr int kLossMae = 1;

// rate rows of the shared rate table [4][fe]
constexpr int kWLr = 0, kWReg = 1, kHLr = 2, kHReg = 3;

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

// The loss gradient at the score `dot`, times the slot weight.
__device__ __forceinline__ float gradient(float dot, float v, float wt,
                                          float gb, float min_rating,
                                          float rating_range, int loss,
                                          int biased) {
  float g;
  if (biased) {
    const float sig = 1.f / (1.f + expf(-(dot + gb)));
    const float err = v - (min_rating + sig * rating_range);
    if (loss == kLossRmse) {
      g = err * sig * (1.f - sig) * rating_range;
    } else if (loss == kLossMae) {
      // sign(0) = 0, as jnp.sign
      g = (float)((err > 0.f) - (err < 0.f)) * sig * (1.f - sig) *
          rating_range;
    } else {
      g = err;
    }
  } else {
    g = v - (dot + gb);
  }
  return g * wt;
}

// Where piece li of an entry of the owner scatter goes: table 0 is W
// (slot id's user row), table 1 is H (its item row); a piece is one of
// the table's live float4s.
struct SgdPieces {
  float* W;
  float* H;
  const int32_t* sd;        // the chunk's packed row in shared memory
  const int32_t* live;      // [2][fe4]: the live float4s of W, then H
  int64_t wbase, hbase;
  int C, fe, fe4;
  __device__ float4* dst(int t, int id, int li) const {
    const int c4 = live[t * fe4 + li];
    float* row = t ? H + (hbase + sd[C + id]) * fe : W + (wbase + sd[id]) * fe;
    return reinterpret_cast<float4*>(row) + c4;
  }
};

// V float4s per lane per row (fe <= 128 V), SPW slots per warp pass (a
// slot on 32 / SPW lanes), G passes in flight per warp. One cluster of
// gridDim.x CTAs; kOne: a cluster of one, compiled apart so that the
// cluster's state takes no registers there.
template <int V, int SPW, int G, bool kOne>
__global__ void __launch_bounds__(kThreads, 1)
sgd_epoch_kernel(float* __restrict__ W, float* __restrict__ H,
                 const int32_t* __restrict__ packed,
                 const uint16_t* __restrict__ segs,
                 const int32_t* __restrict__ order_ub,
                 const int32_t* __restrict__ order_ib,
                 const int32_t* __restrict__ order_row,
                 const float* __restrict__ rates,
                 float4* __restrict__ scratch,
                 int nc, int C, int RL, int UB, int IB, int fe,
                 int stage_f4, float gb, float min_rating,
                 float rating_range, int loss, int biased) {
  constexpr int kLanes = 32 / SPW;            // lanes per slot
  constexpr int kStep = kWarps * SPW;         // slots per pass of the block
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncta = kOne ? 1 : gridDim.x;
  const int rank = kOne ? 0 : blockIdx.x;
  const int fe4 = fe >> 2;
  const int Cw = (C + 7) & ~7;
  const int RK = RL + 2 * Cw;                 // a chunk's table row
  const int cs = (C + ncta - 1) / ncta;       // slots a CTA
  const int s_lo = min(C, rank * cs);
  const int ns = min(C, s_lo + cs) - s_lo;    // this CTA's slots
  // [4][fe] rates | [3][4C] packed rows | [3][RK] runs and codes | [2][fe4]
  // live float4s and [2][fe4] their pieces (rounded to 16 bytes) | the
  // stage
  float* s_rate = reinterpret_cast<float*>(smem);
  int32_t* s_buf = reinterpret_cast<int32_t*>(s_rate + 4 * fe);
  uint16_t* s_seg = reinterpret_cast<uint16_t*>(s_buf + 12 * C);
  int32_t* s_live = reinterpret_cast<int32_t*>(s_seg + 3 * RK);
  int32_t* s_li = s_live + 2 * fe4;
  float4* s_stage = reinterpret_cast<float4*>(s_live + ((4 * fe4 + 3) & ~3));
  // per buffer: the chunk's ub and ib, and the packed row of the chunk two
  // after it
  __shared__ int32_t s_meta[3][3];
  __shared__ int s_nlive[2];
  __shared__ int s_runs[2];        // this CTA's runs [k0, k1) of a chunk
  // each CTA's stage (and past the last, none)
  __shared__ float4* s_part[kMaxCluster + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = lane / kLanes;             // this lane's slot of a pass
  const int sub = lane % kLanes;              // its float4s: sub + kLanes v
  for (int t = tid; t < fe * 4; t += kThreads)
    s_rate[(t % 4) * fe + t / 4] = rates[t];
  if (tid <= kMaxCluster)
    s_part[tid] = tid < ncta ? cooperative_groups::this_cluster()
                                   .map_shared_rank(s_stage, tid)
                             : nullptr;

  // chunk k's packed row r (u_loc, i_loc, v bits, w bits), the runs and
  // codes of its segment table, its (ub, ib) and the row of chunk k+2 into
  // buffer b
  auto prefetch = [&](int k, int64_t r, int b) {
    const int32_t* prow = packed + r * 4 * C;
    int32_t* dst = s_buf + b * 4 * C;
    for (int e = tid; e < C; e += kThreads)
      mml_owner::cp_async16(dst + 4 * e, prow + 4 * e);
    const uint16_t* srow = segs + r * RK;
    for (int e = tid; e < RK / 8; e += kThreads)
      mml_owner::cp_async16(s_seg + b * RK + 8 * e, srow + 8 * e);
    if (tid == 0) {
      cp_async4(&s_meta[b][0], order_ub + k);
      cp_async4(&s_meta[b][1], order_ib + k);
      if (k + 2 < nc) cp_async4(&s_meta[b][2], order_row + k + 2);
    }
  };

  if (nc > 0) prefetch(0, __ldg(order_row), 0);
  if (nc > 1) prefetch(1, __ldg(order_row + 1), 1);
  cp_async_commit();
  __syncthreads();
  if (tid < 2) {
    const float4* r4 = reinterpret_cast<const float4*>(s_rate);
    const int lr = tid ? kHLr : kWLr;
    int n = 0;
    for (int c4 = 0; c4 < fe4; ++c4) {
      s_li[tid * fe4 + c4] = n;
      if (f4_any(r4[lr * fe4 + c4])) s_live[tid * fe4 + n++] = c4;
    }
    s_nlive[tid] = n;
  }
  // the first chunk's wait: every CTA of the cluster runs (its stage may
  // be written), the live lists are set, and the copies of chunks 0 and 1
  // have landed
  mml_cluster::arrive_copied(ncta);
  const float4* r4 = reinterpret_cast<const float4*>(s_rate);  // [4][fe4]

  for (int k = 0; k < nc; ++k) {
    const int b = k % 3;
    // chunk k's indices have landed in every thread, with the packed row
    // of chunk k+2; the previous chunk's stores are visible to this
    // chunk's gathers, and its stage is read (see the note at the top)
    cluster_wait(ncta);
    // chunk k+2's indices into the buffer chunk k-1 used: in one CTA now,
    // in a cluster while the other CTAs finish phase 1 (each measured
    // the faster, PERF.md section 6)
    auto next_indices = [&]() {
      if (k + 2 < nc) prefetch(k + 2, s_meta[b][2], (k + 2) % 3);
      cp_async_commit();
    };
    if (ncta == 1) next_indices();
    const int ub = s_meta[b][0], ib = s_meta[b][1];
    const int32_t* sd = s_buf + b * 4 * C;
    const uint16_t* runs = s_seg + b * RK;
    const uint16_t* codes = runs + RL;          // [2][Cw]
    const int64_t wbase = (int64_t)ub * UB;
    const int64_t hbase = (int64_t)ib * IB;
    const mml_cluster::ClusterStage st = mml_cluster::cluster_stage(
        runs, 3u, s_nlive[0], s_nlive[1], ncta, rank, s_part, s_stage,
        scratch, stage_f4);
    // this CTA's runs of phase 2, those whose first value lies in its part
    // of the stage (all of them in a cluster of one), found by one thread
    // while its first pass's loads are in flight
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
      float4 wu[G][V], hi[G][V];
      float wt[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = j0 + g * kStep;
        const int s = s_lo + j;
        wt[g] = j < ns ? __int_as_float(sd[3 * C + s]) : 0.f;
        const bool live = wt[g] != 0.f;      // else rows 0, not read
        const float4* wrow = reinterpret_cast<const float4*>(
            W + (live ? wbase + sd[s] : 0) * fe);
        const float4* hrow = reinterpret_cast<const float4*>(
            H + (live ? hbase + sd[C + s] : 0) * fe);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c4 = sub + kLanes * v;
          const bool ld = live && c4 < fe4;
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          wu[g][v] = ld ? __ldcg(wrow + c4) : z;
          hi[g][v] = ld ? __ldcg(hrow + c4) : z;
        }
      }
      if (searcher && !searched) find_runs();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          dot = fmaf(wu[g][v].x, hi[g][v].x, dot);
          dot = fmaf(wu[g][v].y, hi[g][v].y, dot);
          dot = fmaf(wu[g][v].z, hi[g][v].z, dot);
          dot = fmaf(wu[g][v].w, hi[g][v].w, dot);
        }
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(kFull, dot, o);
        if (wt[g] == 0.f) continue;          // padded slot
        const int s = s_lo + j0 + g * kStep;
        const float gr = gradient(dot, __int_as_float(sd[2 * C + s]), wt[g],
                                  gb, min_rating, rating_range, loss, biased);
        const uint16_t wcode = codes[s], hcode = codes[Cw + s];
        float4* wrow = reinterpret_cast<float4*>(W + (wbase + sd[s]) * fe);
        float4* hrow = reinterpret_cast<float4*>(H + (hbase + sd[C + s]) * fe);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c4 = sub + kLanes * v;
          if (c4 >= fe4) continue;
          const float4 wl = r4[kWLr * fe4 + c4];
          const float4 hl = r4[kHLr * fe4 + c4];
          if (f4_any(wl))
            put(wcode, st, s_li[c4], wrow + c4, wu[g][v],
                f4_delta(wl, gr, hi[g][v], wt[g], r4[kWReg * fe4 + c4],
                         wu[g][v]));
          if (f4_any(hl))
            put(hcode, st, s_li[fe4 + c4], hrow + c4, hi[g][v],
                f4_delta(hl, gr, wu[g][v], wt[g], r4[kHReg * fe4 + c4],
                         hi[g][v]));
        }
      }
    }

    if (searcher && !searched) find_runs();

    // phase 2: each run of a W or H row summed in slot order. Over the
    // cluster where the stage is on chip; else in CTA 0 by owner_chain,
    // whose first barrier ends phase 1 in a cluster of one: the stage in
    // its shared memory, or the values in the global scratch
    const SgdPieces pc{W, H, sd, s_live, wbase, hbase, C, fe, fe4};
    // this thread's phase 1, and its copies of chunk k+1 (issued a chunk
    // ago; in one CTA, with those of chunk k+2, issued at this chunk's
    // start)
    mml_cluster::arrive_copied(ncta);
    if (ncta > 1) {
      next_indices();
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
      cluster == 1 ? &sgd_epoch_kernel<V, SPW, G, true>
                   : &sgd_epoch_kernel<V, SPW, G, false>,
      cluster, kThreads, smem, st, args...);
}

// the lanes of a slot from the width, as the one-block walk chose them
template <class... Args>
int launch_width(int fe, Args... args) {
  if (fe <= 64) return launch<1, 2, 2>(args...);
  if (fe <= 128) return launch<1, 1, 2>(args...);
  return launch<2, 1, 1>(args...);
}

}  // namespace

// C interface (bound with ctypes). Launches one cluster of `cluster` CTAs
// (1 to 16) on `stream`, does not synchronise, and returns the first CUDA
// error of the launch, or -2 where the card cannot place the cluster.
// Chunk k touches W rows order_ub[k] * UB + u_loc and H rows order_ib[k]
// * IB + i_loc: order_ib holds absolute item blocks on either schedule.
// `segs` [rows of packed, RL + 2 Cw] holds each chunk's segment table
// (ops/segments.py): the runs [RL] and the codes [2, Cw], Cw = C rounded
// up to 8. `scratch` holds 2 * C * fe floats; fe is a multiple of 4, at
// most 256, C a multiple of 4, RL a multiple of 8. Each CTA has `smem`
// bytes of dynamic shared memory: 16 fe + 48 C + 6 (RL + 2 Cw) + 4 fe
// bytes of rates, indices and live lists, and the stage in the rest;
// ops/sgd_epoch.py checks all and sizes smem.
extern "C" int mml_sgd_epoch(float* W, float* H, const int32_t* packed,
                             const void* segs, const int32_t* order_ub,
                             const int32_t* order_ib,
                             const int32_t* order_row, const float* rates,
                             float* scratch, int nc, int C, int RL, int UB,
                             int IB, int fe, int smem, int cluster,
                             float gb, float min_rating, float rating_range,
                             int loss, int biased, void* stream) {
  if (nc == 0) return (int)cudaSuccess;
  const int fe4 = fe / 4;
  const int RK = RL + 2 * ((C + 7) & ~7);
  const int fixed = 16 * fe + 48 * C + 6 * RK + 4 * ((4 * fe4 + 3) & ~3);
  const int stage_f4 = (smem - fixed) / 16;
  if (stage_f4 < fe4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* sg = static_cast<const uint16_t*>(segs);
  float4* sc = reinterpret_cast<float4*>(scratch);
  return launch_width(fe, cluster, smem, st, W, H, packed, sg, order_ub,
                      order_ib, order_row, rates, sc, nc, C, RL, UB, IB, fe,
                      stage_f4, gb, min_rating, rating_range, loss, biased);
}
