// One SVD++ epoch over the static S/R/Y schedule, in one launch.
//
// Replaces mymedialite_tpu/ops/pallas_svdpp.py:308 _svdpp_kernel (called
// by svdpp_epoch_mxu :460). Same semantics: the schedule visits each user
// block once, its chunks contiguous, in three phases, and every chunk of C
// slots is one minibatch step (all slots read the rows as they stood
// before the chunk; duplicates within a chunk sum; padded slots, weight 0,
// contribute nothing). Per user block, with s and c [UB, fe] zeroed when
// the block starts:
//
//   S (edge chunk):   s[u] += wt * Y[i]
//   R (rating chunk): su = W[u] + mf * s[u] * inv_u   (inv_u = W[u, F+2])
//                     score = <su, Q[i]>; plain: g = (v - score - gb) * wt,
//                     sigmoid: the loss gradient at min + sig(score + gb) *
//                     range, times wt
//                     W[u] += w_lr * (g * Q[i] - wt * w_reg * W[u])
//                     Q[i] += q_lr * (g * su - wt * q_reg * Q[i])
//                     c[u] += mf * g * inv_u * Q[i];  c[u, F] += wt
//   Y (edge chunk):   Y[i] += y_lr * wt * (mf * c[u] - c[u, F] * y_reg * Y[i])
//
// with the per-column rates [fe, 8] (w_lr, w_reg, q_lr, q_reg, mf, -, y_lr,
// y_reg) of ops/svdpp_plan.py svdpp_mxu_rates.
//
// The TPU idioms are not carried over: the one-hot matmul gathers and
// scatters, bf16 operands, the transposed [fe, rows] tables, the VMEM
// copies of Q and Y with their DMA semaphores, the passes, the pad chunk
// and the refetch flags. On Hopper a gather is an indexed load and a
// scatter an atomic add, straight on the row-major tables in device
// memory, and the kernel reads the schedule (ph, ub, ib, row) itself.
//
// Design and bound. Q and Y are shared by every user block and each
// chunk depends on the one before, so the parallelism is within a chunk
// (C slots x fe columns). One thread block walks the whole schedule:
// warps over slots, lanes over columns (one column per lane at k=20,
// fe=32). s and c live in a global scratch [2, UB, fe] (128 KB at
// UB=512, fe=32: it stays in L2), zeroed when the user block changes. The
// R and Y phases gather rows through L2 (ld.global.cg, so no stale L1 line
// survives an earlier chunk's atomics), stage their deltas in a global
// scratch [2, C, fe], and scatter them with atomics after a barrier; S
// adds straight into s, which no S chunk reads. A fence and a barrier
// separate chunks. The epoch is therefore bound by dependent L2 round
// trips and by the atomic throughput of one SM, not by HBM bandwidth.
// Spreading it over the card's SMs needs an order with independent cells
// (user blocks on disjoint item blocks), which changes the trajectory and
// is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

constexpr int kLossRmse = 0;
constexpr int kLossMae = 1;

constexpr int kPhaseS = 0;
constexpr int kPhaseR = 1;

// rate columns
constexpr int kWLr = 0, kWReg = 1, kQLr = 2, kQReg = 3, kMf = 4, kYLr = 6,
              kYReg = 7;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// CPL = columns per lane: fe <= 32 * CPL.
template <int CPL>
__global__ void __launch_bounds__(kThreads, 1)
svdpp_epoch_kernel(float* __restrict__ W, float* __restrict__ Q,
                   float* __restrict__ Y, const int32_t* __restrict__ packed,
                   const int32_t* __restrict__ sched_ph,
                   const int32_t* __restrict__ sched_ub,
                   const int32_t* __restrict__ sched_ib,
                   const int32_t* __restrict__ sched_row,
                   const float* __restrict__ rates,
                   float* __restrict__ scratch, int n_steps, int C, int UB,
                   int IB, int fe, int F, float gb, float min_rating,
                   float rating_range, int loss, int sigmoid) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_rates = reinterpret_cast<float*>(smem);            // [fe][8]
  int32_t* s_d = reinterpret_cast<int32_t*>(s_rates + fe * 8);  // [4][C]

  for (int t = threadIdx.x; t < fe * 8; t += kThreads) s_rates[t] = rates[t];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* s_acc = scratch;                               // [UB][fe]
  float* c_acc = scratch + (size_t)UB * fe;             // [UB][fe]
  float* d1 = scratch + (size_t)2 * UB * fe;            // [C][fe]
  float* d2 = d1 + (size_t)C * fe;                      // [C][fe]

  int prev_ub = -1;
  for (int k = 0; k < n_steps; ++k) {
    const int phase = __ldg(sched_ph + k);
    const int ub = __ldg(sched_ub + k);
    if (ub != prev_ub) {
      // a new user block: s and c start from zero
      for (int t = threadIdx.x; t < 2 * UB * fe; t += kThreads)
        __stcg(scratch + t, 0.f);
      prev_ub = ub;
    }
    // stage the chunk's (u_loc, i_loc, v bits, w bits) in shared memory
    const int32_t* d = packed + (int64_t)__ldg(sched_row + k) * 4 * C;
    for (int t = threadIdx.x; t < 4 * C; t += kThreads) s_d[t] = __ldg(d + t);
    __syncthreads();
    const int64_t wbase = (int64_t)ub * UB;
    const int64_t ibase = (int64_t)__ldg(sched_ib + k) * IB;

    if (phase == kPhaseS) {
      // s[u] += wt * Y[i]; only the factor columns of s are ever read
      for (int s = warp; s < C; s += kWarps) {
        const float wt = __int_as_float(s_d[3 * C + s]);
        if (wt == 0.f) continue;  // padded slot (uniform across the warp)
        const float* yrow = Y + (ibase + s_d[C + s]) * fe;
        float* srow = s_acc + (size_t)s_d[s] * fe;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          if (c < F) atomicAdd(srow + c, __ldcg(yrow + c) * wt);
        }
      }
    } else if (phase == kPhaseR) {
      // gather and gradient; every read sees the pre-chunk rows
      for (int s = warp; s < C; s += kWarps) {
        const float wt = __int_as_float(s_d[3 * C + s]);
        if (wt == 0.f) continue;
        const int u = s_d[s];
        const float* wrow = W + (wbase + u) * fe;
        const float* qrow = Q + (ibase + s_d[C + s]) * fe;
        const float* srow = s_acc + (size_t)u * fe;
        float* crow = c_acc + (size_t)u * fe;
        const float v = __int_as_float(s_d[2 * C + s]);
        const float inv = __ldcg(wrow + F + 2);
        float wu[CPL], qi[CPL], su[CPL];
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          wu[j] = c < fe ? __ldcg(wrow + c) : 0.f;
          qi[j] = c < fe ? __ldcg(qrow + c) : 0.f;
          su[j] = c < fe
                      ? wu[j] + s_rates[8 * c + kMf] * (__ldcg(srow + c) * inv)
                      : 0.f;
          dot = fmaf(su[j], qi[j], dot);
        }
        dot = warp_sum(dot);
        float g;
        if (sigmoid) {
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
        const float ginv = g * inv;
        float* dw = d1 + (size_t)s * fe;
        float* dq = d2 + (size_t)s * fe;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          if (c < fe) {
            const float* r = s_rates + 8 * c;
            dw[c] = r[kWLr] * (g * qi[j] - wt * r[kWReg] * wu[j]);
            dq[c] = r[kQLr] * (g * su[j] - wt * r[kQReg] * qi[j]);
            // c is not read in the R phase: add straight away
            if (c < F) {
              atomicAdd(crow + c, r[kMf] * ginv * qi[j]);
            } else if (c == F) {
              atomicAdd(crow + c, wt);
            }
          }
        }
      }
      __syncthreads();
      // scatter-add; columns whose rate is 0 (constants, padding) stay
      for (int s = warp; s < C; s += kWarps) {
        if (__int_as_float(s_d[3 * C + s]) == 0.f) continue;
        float* wrow = W + (wbase + s_d[s]) * fe;
        float* qrow = Q + (ibase + s_d[C + s]) * fe;
        const float* dw = d1 + (size_t)s * fe;
        const float* dq = d2 + (size_t)s * fe;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          if (c < fe) {
            if (s_rates[8 * c + kWLr] != 0.f) atomicAdd(wrow + c, dw[c]);
            if (s_rates[8 * c + kQLr] != 0.f) atomicAdd(qrow + c, dq[c]);
          }
        }
      }
    } else {
      // Y phase: the deltas from the pre-chunk rows, then the scatter
      for (int s = warp; s < C; s += kWarps) {
        const float wt = __int_as_float(s_d[3 * C + s]);
        if (wt == 0.f) continue;
        const float* yrow = Y + (ibase + s_d[C + s]) * fe;
        const float* crow = c_acc + (size_t)s_d[s] * fe;
        const float n = __ldcg(crow + F);
        float* dy = d1 + (size_t)s * fe;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          if (c < fe) {
            const float* r = s_rates + 8 * c;
            dy[c] = r[kYLr] * wt *
                    (r[kMf] * __ldcg(crow + c) -
                     n * r[kYReg] * __ldcg(yrow + c));
          }
        }
      }
      __syncthreads();
      for (int s = warp; s < C; s += kWarps) {
        if (__int_as_float(s_d[3 * C + s]) == 0.f) continue;
        float* yrow = Y + (ibase + s_d[C + s]) * fe;
        const float* dy = d1 + (size_t)s * fe;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          if (c < fe && s_rates[8 * c + kYLr] != 0.f)
            atomicAdd(yrow + c, dy[c]);
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
// synchronise, and returns cudaGetLastError() after the launch. Step k
// runs phase sched_ph[k] on chunk sched_row[k] of `packed`, touching W
// rows sched_ub[k] * UB + u_loc and Q/Y rows sched_ib[k] * IB + i_loc.
// `scratch` holds 2 * (UB + C) * fe floats.
extern "C" int mml_svdpp_epoch(float* W, float* Q, float* Y,
                               const int32_t* packed, const int32_t* sched_ph,
                               const int32_t* sched_ub,
                               const int32_t* sched_ib,
                               const int32_t* sched_row, const float* rates,
                               float* scratch, int n_steps, int C, int UB,
                               int IB, int fe, int F, float gb,
                               float min_rating, float rating_range, int loss,
                               int sigmoid, void* stream) {
  const size_t smem = (size_t)fe * 8 * sizeof(float) +
                      (size_t)4 * C * sizeof(int32_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MML_LAUNCH(CPL)                                                      \
  svdpp_epoch_kernel<CPL><<<1, kThreads, smem, st>>>(                        \
      W, Q, Y, packed, sched_ph, sched_ub, sched_ib, sched_row, rates,       \
      scratch, n_steps, C, UB, IB, fe, F, gb, min_rating, rating_range, loss, \
      sigmoid)
  if (fe <= 32) {
    MML_LAUNCH(1);
  } else if (fe <= 64) {
    MML_LAUNCH(2);
  } else if (fe <= 128) {
    MML_LAUNCH(4);
  } else {
    MML_LAUNCH(8);
  }
#undef MML_LAUNCH
  return (int)cudaGetLastError();
}
