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
// Design and bound. The chunk order walks user blocks one after another
// and consecutive chunks share a user or an item block, so there is
// almost no parallelism across chunks: the parallelism is within a chunk
// (C slots x fe columns). One thread block walks the whole order: warps
// over slots, lanes over columns. Phase 1 gathers rows through L2
// (ld.global.cg, so no stale L1 line survives the previous chunk's
// atomics), computes the gradient and stages the deltas in a global
// scratch [2, C, fe] (~330 KB at C=640, fe=64, L2-resident);
// __syncthreads(); phase 2 adds the deltas with atomics; a fence and
// __syncthreads() before the next chunk. The epoch is therefore bound by
// L2 latency (dependent round trips per chunk) and by the atomic
// throughput of one SM, not by HBM bandwidth. Spreading the epoch over the card's SMs
// needs a chunk order with independent cells (DSGD diagonals), which
// changes the trajectory and is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

constexpr int kLossRmse = 0;
constexpr int kLossMae = 1;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// CPL = columns per lane: fe <= 32 * CPL.
template <int CPL>
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
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_rates = reinterpret_cast<float*>(smem);            // [fe][4]
  int32_t* s_d = reinterpret_cast<int32_t*>(s_rates + fe * 4);  // [4][C]

  for (int t = threadIdx.x; t < fe * 4; t += kThreads) s_rates[t] = rates[t];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* dW = scratch;                          // [C][fe]
  float* dH = scratch + (size_t)C * fe;         // [C][fe]

  for (int k = 0; k < nc; ++k) {
    // stage the chunk's (u_loc, i_loc, v bits, w bits) in shared memory
    const int32_t* d = packed + (int64_t)order_row[k] * 4 * C;
    for (int t = threadIdx.x; t < 4 * C; t += kThreads) s_d[t] = __ldg(d + t);
    __syncthreads();
    const int64_t wbase = (int64_t)order_ub[k] * UB;
    const int64_t hbase = (int64_t)order_ib[k] * IB;

    // phase 1: gather and gradient; every read sees the pre-chunk tables
    for (int s = warp; s < C; s += kWarps) {
      const float wt = __int_as_float(s_d[3 * C + s]);
      if (wt == 0.f) continue;  // padded slot (uniform across the warp)
      const float* wrow = W + (wbase + s_d[s]) * fe;
      const float* hrow = H + (hbase + s_d[C + s]) * fe;
      const float v = __int_as_float(s_d[2 * C + s]);
      float wu[CPL], hi[CPL];
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        wu[j] = c < fe ? __ldcg(wrow + c) : 0.f;
        hi[j] = c < fe ? __ldcg(hrow + c) : 0.f;
        dot = fmaf(wu[j], hi[j], dot);
      }
      dot = warp_sum(dot);
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
      g *= wt;
      float* dw = dW + (size_t)s * fe;
      float* dh = dH + (size_t)s * fe;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        if (c < fe) {
          const float* r = s_rates + 4 * c;
          dw[c] = r[0] * (g * hi[j] - wt * r[1] * wu[j]);
          dh[c] = r[2] * (g * wu[j] - wt * r[3] * hi[j]);
        }
      }
    }
    __syncthreads();

    // phase 2: scatter-add; duplicate rows within the chunk sum
    for (int s = warp; s < C; s += kWarps) {
      if (__int_as_float(s_d[3 * C + s]) == 0.f) continue;
      float* wrow = W + (wbase + s_d[s]) * fe;
      float* hrow = H + (hbase + s_d[C + s]) * fe;
      const float* dw = dW + (size_t)s * fe;
      const float* dh = dH + (size_t)s * fe;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        if (c < fe) {
          atomicAdd(wrow + c, dw[c]);
          atomicAdd(hrow + c, dh[c]);
        }
      }
    }
    // the next chunk's gathers must see every atomic of this one; the
    // device-scope fence makes that explicit beside the barrier
    __threadfence();
    __syncthreads();
  }
}

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch. Chunk k
// touches W rows order_ub[k] * UB + u_loc and H rows order_ib[k] * IB +
// i_loc: order_ib holds absolute item blocks on either schedule.
extern "C" int mml_sgd_epoch(float* W, float* H, const int32_t* packed,
                             const int32_t* order_ub, const int32_t* order_ib,
                             const int32_t* order_row, const float* rates,
                             float* scratch, int nc, int C, int UB, int IB,
                             int fe, float gb, float min_rating,
                             float rating_range, int loss, int biased,
                             void* stream) {
  const size_t smem = (size_t)fe * 4 * sizeof(float) +
                      (size_t)4 * C * sizeof(int32_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MML_LAUNCH(CPL)                                                   \
  sgd_epoch_kernel<CPL><<<1, kThreads, smem, st>>>(                       \
      W, H, packed, order_ub, order_ib, order_row, rates, scratch, nc, C, \
      UB, IB, fe, gb, min_rating, rating_range, loss, biased)
  if (fe <= 64) {
    MML_LAUNCH(2);
  } else if (fe <= 128) {
    MML_LAUNCH(4);
  } else {
    MML_LAUNCH(8);
  }
#undef MML_LAUNCH
  return (int)cudaGetLastError();
}
