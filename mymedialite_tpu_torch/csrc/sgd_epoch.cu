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
// scatter-added with duplicates summing. Padded slots (weight 0)
// contribute nothing.
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
// Hopper the gather is an indexed load and the scatter an atomic add,
// straight on the tables in device memory. The tiled schedule is the
// same walk over another order: chunks sorted by item slab, grouped by
// user block within a slab, with the absolute item block sl * B + ibr
// formed by the wrapper (ops/sgd_epoch.py sgd_epoch_tiled). That order
// keeps one slab (4 MB at k=40) hot in the 50 MB L2, which takes the
// place of the TPU's slab in VMEM.
//
// The walk. The chunk order walks user blocks one after another and
// consecutive chunks share a user or an item block, so there is almost
// no parallelism across chunks: the parallelism is within a chunk (C
// slots x fe columns), and one thread block walks the whole order. A
// chunk's time is its chain of dependent round trips to L2 and the
// atomic throughput of one SM, not HBM bandwidth. So, as in the BPR walk
// (bpr_epoch.cu):
// - the next chunk's packed row and its (ub, ib) are copied into a
//   second shared buffer with cp.async while this chunk runs, so a chunk
//   starts with its indices on chip;
// - a row is cut into float4s, one per lane (two per lane past 128
//   columns): at fe <= 64 a warp serves two slots per pass, and each
//   warp issues the row loads of two passes before it uses any;
// - where a warp's slots all fall in its first two passes (C <= 128 at
//   fe <= 64: the tiled schedule's chunk), the deltas stay in registers
//   across the barrier. Otherwise they go to a global scratch [2, C, fe]
//   that the same lanes read back after the barrier, two passes' loads
//   before their atomics: at C = 640, fe = 64 they are 320 KB, past a
//   block's 227 KB of shared memory, and a warp would have to hold the
//   deltas of all its ten passes in registers;
// - the scatter is float4 atomic adds (red.global.add.v4.f32 on sm_90),
//   and a float4 whose learning rates are all 0 is neither stored nor
//   sent: its deltas are exactly 0 (the zero padding of the tables to fe
//   columns, and each table's constant column). At k = 40, fe = 64, 11 of
//   a row's 16 float4s are sent;
// - no device-scope fence ends a chunk. Every reader and writer of the
//   tables during the walk is a thread of this one block, and the next
//   chunk's gathers follow a __syncthreads(), which the CUDA C++
//   Programming Guide defines to make every global and shared memory
//   access made before it by the block's threads visible to all threads
//   of the block; the atomics (red.global) act at L2, and the gathers read
//   through L2 (ld.global.cg), not through a stale L1 line. A
//   __threadfence() orders a thread's writes for observers outside the
//   block, and there are none. The same barrier separates a chunk's
//   gathers from its atomics.
// Spreading the epoch over the card's SMs needs a chunk order with
// independent cells (DSGD diagonals), which changes the trajectory and is
// left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
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

// V float4s per lane per row (fe <= 128 V), SPW slots per warp pass (a
// slot on 32 / SPW lanes), G passes in flight per warp.
template <int V, int SPW, int G>
__global__ void __launch_bounds__(kThreads, 1)
sgd_epoch_kernel(float* __restrict__ W, float* __restrict__ H,
                 const int32_t* __restrict__ packed,
                 const int32_t* __restrict__ order_ub,
                 const int32_t* __restrict__ order_ib,
                 const int32_t* __restrict__ order_row,
                 const float* __restrict__ rates,
                 float* __restrict__ scratch,
                 int nc, int C, int UB, int IB, int fe,
                 float gb, float min_rating, float rating_range,
                 int loss, int biased) {
  constexpr int kLanes = 32 / SPW;            // lanes per slot
  constexpr int kStep = kWarps * SPW;         // slots per pass of the block
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_rate = reinterpret_cast<float*>(smem);   // [4][fe], by rate
  int32_t* s_buf = reinterpret_cast<int32_t*>(s_rate + 4 * fe);  // [2][4C]
  __shared__ int32_t s_meta[2][2];                 // ub, ib per buffer

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = lane / kLanes;             // this lane's slot of a pass
  const int sub = lane % kLanes;              // its float4s: sub + kLanes v
  const int fe4 = fe >> 2;
  for (int t = tid; t < fe * 4; t += kThreads)
    s_rate[(t % 4) * fe + t / 4] = rates[t];
  const float4* r4 = reinterpret_cast<const float4*>(s_rate);  // [4][fe4]
  float* dW = scratch;                        // [C][fe]
  float* dH = scratch + (size_t)C * fe;       // [C][fe]

  // chunk k's packed row (u_loc, i_loc, v bits, w bits) into buffer b
  auto prefetch = [&](int k, int b) {
    const int32_t* prow = packed + (int64_t)__ldg(order_row + k) * 4 * C;
    int32_t* dst = s_buf + b * 4 * C;
    for (int e = tid; e < C; e += kThreads)
      cp_async16(dst + 4 * e, prow + 4 * e);
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
    // chunk k's rows have landed; the previous chunk's atomics are
    // visible to this chunk's gathers (see the comment at the top)
    __syncthreads();
    if (k + 1 < nc) prefetch(k + 1, b ^ 1);
    const int32_t* sd = s_buf + b * 4 * C;
    const int64_t wbase = (int64_t)s_meta[b][0] * UB;
    const int64_t hbase = (int64_t)s_meta[b][1] * IB;

    // the deltas of a warp's passes; with every slot of the chunk in one
    // group of G passes per warp (C <= 128 at fe <= 64) they stay in
    // registers across the barrier, else they go through the scratch
    float4 dw[G][V], dh[G][V];
    const bool in_regs = C <= kStep * G;

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
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c4 = sub + kLanes * v;
          if (c4 >= fe4) continue;
          const size_t at = (size_t)s * fe + 4 * c4;
          const float4 wl = r4[kWLr * fe4 + c4];
          const float4 hl = r4[kHLr * fe4 + c4];
          dw[g][v] = f4_delta(wl, gr, hi[g][v], wt[g], r4[kWReg * fe4 + c4],
                              wu[g][v]);
          dh[g][v] = f4_delta(hl, gr, wu[g][v], wt[g], r4[kHReg * fe4 + c4],
                              hi[g][v]);
          if (in_regs) continue;
          if (f4_any(wl)) *reinterpret_cast<float4*>(dW + at) = dw[g][v];
          if (f4_any(hl)) *reinterpret_cast<float4*>(dH + at) = dh[g][v];
        }
      }
    }
    __syncthreads();  // every gather of the chunk precedes every atomic

    // phase 2: scatter-add; duplicate rows within the chunk sum. Through
    // the scratch, each lane reads back the deltas it wrote itself
    // (program order), G passes' loads before their atomics
    for (int p0 = warp * SPW; p0 < C; p0 += kStep * G) {
      const int s0 = p0 + half;
      bool live[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = s0 + g * kStep;
        live[g] = s < C && __int_as_float(sd[3 * C + s]) != 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c4 = sub + kLanes * v;
          const size_t at = (size_t)s * fe + 4 * c4;
          if (!in_regs && live[g] && c4 < fe4) {
            if (f4_any(r4[kWLr * fe4 + c4]))
              dw[g][v] = __ldcg(reinterpret_cast<const float4*>(dW + at));
            if (f4_any(r4[kHLr * fe4 + c4]))
              dh[g][v] = __ldcg(reinterpret_cast<const float4*>(dH + at));
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (!live[g]) continue;
        const int s = s0 + g * kStep;
        float4* wrow = reinterpret_cast<float4*>(W + (wbase + sd[s]) * fe);
        float4* hrow = reinterpret_cast<float4*>(H + (hbase + sd[C + s]) * fe);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c4 = sub + kLanes * v;
          if (c4 >= fe4) continue;
          // a float4 whose rates are all 0 has exactly zero deltas
          if (f4_any(r4[kWLr * fe4 + c4])) atomicAdd(wrow + c4, dw[g][v]);
          if (f4_any(r4[kHLr * fe4 + c4])) atomicAdd(hrow + c4, dh[g][v]);
        }
      }
    }
  }
}

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns the first CUDA error of the launch. Chunk k
// touches W rows order_ub[k] * UB + u_loc and H rows order_ib[k] * IB +
// i_loc: order_ib holds absolute item blocks on either schedule.
// `scratch` holds 2 * C * fe floats; fe is a multiple of 4, at most 256, C
// a multiple of 4 (16-byte pieces of each chunk's rows), and the shared
// memory, 16 fe + 32 C bytes, at most 227 KB (ops/sgd_epoch.py checks all
// three).
extern "C" int mml_sgd_epoch(float* W, float* H, const int32_t* packed,
                             const int32_t* order_ub, const int32_t* order_ib,
                             const int32_t* order_row, const float* rates,
                             float* scratch, int nc, int C, int UB, int IB,
                             int fe, float gb, float min_rating,
                             float rating_range, int loss, int biased,
                             void* stream) {
  if (nc == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)fe * 4 * sizeof(float) +
                      (size_t)8 * C * sizeof(int32_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define MML_LAUNCH(V, SPW, G)                                                \
  do {                                                                       \
    err = cudaFuncSetAttribute(sgd_epoch_kernel<V, SPW, G>,                  \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               (int)smem);                                   \
    if (err != cudaSuccess) return (int)err;                                 \
    sgd_epoch_kernel<V, SPW, G><<<1, kThreads, smem, st>>>(                  \
        W, H, packed, order_ub, order_ib, order_row, rates, scratch, nc, C,  \
        UB, IB, fe, gb, min_rating, rating_range, loss, biased);             \
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
