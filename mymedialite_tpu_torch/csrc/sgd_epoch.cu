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
// memory, and the scatter the owner scatter of owner_scatter.cuh. The
// tiled schedule is the same walk over another order: chunks sorted by
// item slab, grouped by user block within a slab, with the absolute item
// block sl * B + ibr formed by the wrapper (ops/sgd_epoch.py
// sgd_epoch_tiled). That order keeps one slab (4 MB at k=40) hot in the
// 50 MB L2, which takes the place of the TPU's slab in VMEM.
//
// The walk. The chunk order walks user blocks one after another and
// consecutive chunks share a user or an item block, so there is almost
// no parallelism across chunks: the parallelism is within a chunk (C
// slots x fe columns), and one thread block walks the whole order. A
// chunk's time is its chain of dependent round trips to L2 and one SM's
// traffic to L2, not HBM bandwidth. So, as in the BPR walk
// (bpr_epoch.cu):
// - the next chunk's packed row, the runs and codes of its segment table
//   (ops/segments.py, built once per plan) and its (ub, ib) are copied
//   into a second shared buffer with cp.async while this chunk runs, so a
//   chunk starts with its indices on chip;
// - a row is cut into float4s, one per lane (two per lane past 128
//   columns): at fe <= 64 a warp serves two slots per pass, and each
//   warp issues the row loads of two passes before it uses any;
// - the deltas (row + delta for the first slot of a row's run, the new
//   row itself for a row alone in the chunk) go to the owner scatter's
//   stage in shared memory, only the runs' entries and only their live
//   float4s, or to a global scratch [2, C, fe] in a chunk where they do
//   not fit; phase 2 sums each run in slot order;
// - a float4 whose learning rates are all 0 is neither stored nor summed:
//   its deltas are exactly 0 (the zero padding of the tables to fe
//   columns, and each table's constant column). At k = 40, fe = 64, 11 of
//   a row's 16 float4s are;
// - no device-scope fence ends a chunk. Every reader and writer of the
//   tables during the walk is a thread of this one block, and the next
//   chunk's gathers follow a __syncthreads(), which the CUDA C++
//   Programming Guide defines to make every global and shared memory
//   access made before it by the block's threads visible to all threads
//   of the block; the stores (st.global.cg) and the gathers
//   (ld.global.cg) act at L2, not through a stale L1 line. A
//   __threadfence() orders a thread's writes for observers outside the
//   block, and there are none. A barrier separates a chunk's gathers from
//   the owners' stores, and a row alone in its run is read and written by
//   its one slot.
// Spreading the epoch over the card's SMs needs a chunk order with
// independent cells (DSGD diagonals), which changes the trajectory and is
// left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "owner_scatter.cuh"

namespace {

using mml_owner::put;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kLossRmse = 0;
constexpr int kLossMae = 1;

// rate rows of the shared rate table [4][fe]
constexpr int kWLr = 0, kWReg = 1, kHLr = 2, kHReg = 3;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

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
// slot on 32 / SPW lanes), G passes in flight per warp.
template <int V, int SPW, int G>
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
  const int fe4 = fe >> 2;
  const int Cw = (C + 7) & ~7;
  const int RK = RL + 2 * Cw;                 // a chunk's table row
  // [4][fe] rates | [2][4C] packed rows | [2][RK] runs and codes | [2][fe4]
  // live float4s and [2][fe4] their pieces (rounded to 16 bytes) | the
  // owner scatter's stage
  float* s_rate = reinterpret_cast<float*>(smem);
  int32_t* s_buf = reinterpret_cast<int32_t*>(s_rate + 4 * fe);
  uint16_t* s_seg = reinterpret_cast<uint16_t*>(s_buf + 8 * C);
  int32_t* s_live = reinterpret_cast<int32_t*>(s_seg + 2 * RK);
  int32_t* s_li = s_live + 2 * fe4;
  float4* s_stage = reinterpret_cast<float4*>(s_live + ((4 * fe4 + 3) & ~3));
  __shared__ int32_t s_meta[2][2];                 // ub, ib per buffer
  __shared__ int s_nlive[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = lane / kLanes;             // this lane's slot of a pass
  const int sub = lane % kLanes;              // its float4s: sub + kLanes v
  for (int t = tid; t < fe * 4; t += kThreads)
    s_rate[(t % 4) * fe + t / 4] = rates[t];
  __syncthreads();
  const float4* r4 = reinterpret_cast<const float4*>(s_rate);  // [4][fe4]
  if (tid < 2) {
    const int lr = tid ? kHLr : kWLr;
    int n = 0;
    for (int c4 = 0; c4 < fe4; ++c4) {
      s_li[tid * fe4 + c4] = n;
      if (f4_any(r4[lr * fe4 + c4])) s_live[tid * fe4 + n++] = c4;
    }
    s_nlive[tid] = n;
  }

  // chunk k's packed row (u_loc, i_loc, v bits, w bits) and the runs and
  // codes of its segment table into buffer b
  auto prefetch = [&](int k, int b) {
    const int64_t r = __ldg(order_row + k);
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
    }
    cp_async_commit();
  };
  if (nc > 0) prefetch(0, 0);

  for (int k = 0; k < nc; ++k) {
    const int b = k & 1;
    cp_async_wait_all();
    // chunk k's rows have landed; the previous chunk's stores are
    // visible to this chunk's gathers (see the comment at the top)
    __syncthreads();
    if (k + 1 < nc) prefetch(k + 1, b ^ 1);
    const int32_t* sd = s_buf + b * 4 * C;
    const uint16_t* runs = s_seg + b * RK;
    const uint16_t* codes = runs + RL;          // [2][Cw]
    const int64_t wbase = (int64_t)s_meta[b][0] * UB;
    const int64_t hbase = (int64_t)s_meta[b][1] * IB;
    const mml_owner::Stage st = mml_owner::make_stage(
        runs, 3u, s_nlive[0], s_nlive[1], s_stage, stage_f4, scratch);

    // phase 1: gather and gradient, G passes' row loads issued before any
    // is used; the pass loop is uniform across the warp (its shuffles
    // need every lane), slots past C weigh 0
    for (int p0 = warp * SPW; p0 < C; p0 += kStep * G) {
      const int s0 = p0 + half;
      float4 wu[G][V], hi[G][V];
      float wt[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = s0 + g * kStep;
        wt[g] = s < C ? __int_as_float(sd[3 * C + s]) : 0.f;
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
        const int s = s0 + g * kStep;
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

    // phase 2: each run of a W or H row summed in slot order
    const SgdPieces pc{W, H, sd, s_live, wbase, hbase, C, fe, fe4};
    mml_owner::owner_chain(runs, 3u, st, s_stage, stage_f4, pc);
  }
}

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns the first CUDA error of the launch. Chunk k
// touches W rows order_ub[k] * UB + u_loc and H rows order_ib[k] * IB +
// i_loc: order_ib holds absolute item blocks on either schedule. `segs`
// [rows of packed, RL + 2 Cw] holds each chunk's segment table
// (ops/segments.py): the runs [RL] and the codes [2, Cw], Cw = C rounded
// up to 8. `scratch` holds 2 * C * fe floats; fe is a multiple of 4, at
// most 256, C a multiple of 4, RL a multiple of 8, and the shared memory `smem` bytes, of which
// the owner scatter's stage takes what is left past 16 fe + 32 C + 4 (RL
// + 2 Cw) + 16 (fe / 4) (rounded to 16) bytes; ops/sgd_epoch.py checks
// all and sizes smem.
extern "C" int mml_sgd_epoch(float* W, float* H, const int32_t* packed,
                             const void* segs, const int32_t* order_ub,
                             const int32_t* order_ib,
                             const int32_t* order_row, const float* rates,
                             float* scratch, int nc, int C, int RL, int UB,
                             int IB, int fe, int smem,
                             float gb, float min_rating, float rating_range,
                             int loss, int biased, void* stream) {
  if (nc == 0) return (int)cudaSuccess;
  const int fe4 = fe / 4;
  const int RK = RL + 2 * ((C + 7) & ~7);
  const int fixed = 16 * fe + 32 * C + 4 * RK + 4 * ((4 * fe4 + 3) & ~3);
  const int stage_f4 = (smem - fixed) / 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* sg = static_cast<const uint16_t*>(segs);
  cudaError_t err;
#define MML_LAUNCH(V, SPW, G)                                                \
  do {                                                                       \
    err = cudaFuncSetAttribute(sgd_epoch_kernel<V, SPW, G>,                  \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               smem);                                        \
    if (err != cudaSuccess) return (int)err;                                 \
    sgd_epoch_kernel<V, SPW, G><<<1, kThreads, smem, st>>>(                  \
        W, H, packed, sg, order_ub, order_ib, order_row, rates,              \
        reinterpret_cast<float4*>(scratch), nc, C, RL, UB, IB, fe,           \
        stage_f4, gb, min_rating, rating_range, loss, biased);               \
  } while (0)
  if (fe <= 64) {
    MML_LAUNCH(1, 2, 2);
  } else if (fe <= 128) {
    MML_LAUNCH(1, 1, 2);
  } else {
    MML_LAUNCH(2, 1, 1);
  }
#undef MML_LAUNCH
  return (int)cudaGetLastError();
}
