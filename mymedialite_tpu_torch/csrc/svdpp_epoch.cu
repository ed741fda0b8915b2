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
// (ops/svdpp_epoch.py svdpp_epoch_reference), so that only the order of
// the sums differs.
//
// The TPU idioms are not carried over: the one-hot matmul gathers and
// scatters, bf16 operands, the transposed [fe, rows] tables, the VMEM
// copies of Q and Y with their DMA semaphores, the passes, the pad chunk
// and the refetch flags. On Hopper a gather is an indexed load and a
// scatter an atomic add, straight on the row-major tables in device
// memory, and the kernel reads the schedule (ph, ub, ib, row) itself.
//
// The walk. Q and Y are shared by every user block and each chunk depends
// on the one before, so the parallelism is within a chunk (C slots x fe
// columns), and one thread block walks the whole schedule. A step's time
// is its chain of dependent round trips to L2 and the atomic throughput of
// one SM, not HBM bandwidth. So, as in the BPR walk (bpr_epoch.cu):
// - the next step's (ph, ub, ib) and packed chunk are copied into a
//   second shared buffer with cp.async while this step runs;
// - a row is cut into float4s, one per lane (two per lane past 128
//   columns): at fe <= 32 eight lanes serve a row and a warp four slots
//   per pass, at fe <= 64 two, and each warp issues the loads of two
//   passes before it uses any;
// - s, c and n hold only the columns that are ever read: the F factor
//   columns of s and c (rows of Fp = F rounded up to 4 floats) and n, one
//   float per user. They are summed in a global scratch (L2-resident),
//   zeroed with st.global.cg when the user block changes, S into s and R
//   into c with float4 atomic adds: a float atomic add to shared memory
//   is a compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN), and an S step
//   took 5.19 us summing s in shared memory against 1.98 us in L2
//   (exp_torch_epoch_split.py, Netflix shape, H100 80GB HBM3). The sums a
//   phase reads are final when it starts (no R step adds to s, no Y step
//   to c or n), so where one [UB][Fp] table and n fit beside the rates and
//   the two chunk buffers in a block's 227 KB of shared memory (F <= 100
//   at UB = 512, C = 512), the first R step of a run copies s on chip and
//   the first Y step c and n, and the phase reads them there; past that R
//   and Y read them through L2. The wrapper picks the variant from the
//   shape (ops/svdpp_epoch.py accumulator_variant);
// - the R and Y deltas go to a global scratch [2, C, fe] that the same
//   lanes read back after the barrier, two passes' loads before their
//   atomics; a warp would have to hold all its passes' deltas in
//   registers across the barrier. Keeping them in shared memory where
//   they fit (128 KB at C = 512, fe = 32) was tried on an H100 and did
//   not shorten the epoch;
// - the W, Q and Y scatters are float4 atomic adds
//   (red.global.add.v4.f32 on sm_90), and a float4 whose learning rates
//   are all 0 is neither stored nor sent: its deltas are exactly 0 (the
//   constant and padding columns);
// - an S step reads only Y and its chunk and writes only s, which no S
//   step reads, so consecutive S steps need no barrier of their own: the
//   one barrier per step is the one that makes the cp.async'd chunk
//   visible to every warp and frees the other buffer for the prefetch. R
//   and Y add a barrier between their gathers and their atomics;
// - no device-scope fence ends a step. Every reader and writer of the
//   tables, s and c during the walk is a thread of this one block, and
//   the next step's reads follow a __syncthreads(), which the CUDA C++
//   Programming Guide defines to make every global and shared memory
//   access made before it by the block's threads visible to all threads
//   of the block; the global atomics (red.global) act at L2, and the
//   gathers read through L2 (ld.global.cg), not through a stale L1 line.
//   A __threadfence() orders a thread's writes for observers outside the
//   block, and there are none.
// Spreading the epoch over the card's SMs needs an order with independent
// cells (user blocks on disjoint item blocks), which changes the
// trajectory and is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kLossRmse = 0;
constexpr int kLossMae = 1;

constexpr int kPhaseS = 0;
constexpr int kPhaseR = 1;

// rate rows of the shared rate table [8][fe]
constexpr int kWLr = 0, kWReg = 1, kQLr = 2, kQReg = 3, kMf = 4, kYLr = 6,
              kYReg = 7;

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

// p[j] += v_j for the columns first + j < F, one float4 atomic in the
// global scratch (the components past F add 0)
__device__ __forceinline__ void acc_add4(float* p, float4 v, int first,
                                         int F) {
  atomicAdd(reinterpret_cast<float4*>(p),
            make_float4(first < F ? v.x : 0.f, first + 1 < F ? v.y : 0.f,
                        first + 2 < F ? v.z : 0.f, first + 3 < F ? v.w : 0.f));
}

// V float4s per lane per row (fe <= 128 V), SPW slots per warp pass (a
// slot on 32 / SPW lanes), G passes in flight per warp; kShared: R reads
// s and Y reads c and n from an on-chip copy, else from the global
// scratch where they are summed.
template <int V, int SPW, int G, bool kShared>
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
  constexpr int kLanes = 32 / SPW;            // lanes per slot
  constexpr int kStep = kWarps * SPW;         // slots per pass of the block
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_rate = reinterpret_cast<float*>(smem);   // [8][fe], by rate
  int32_t* s_buf = reinterpret_cast<int32_t*>(s_rate + 8 * fe);  // [2][4C]
  __shared__ int32_t s_meta[2][4];                 // ph, ub, ib per buffer

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = lane / kLanes;             // this lane's slot of a pass
  const int sub = lane % kLanes;              // its float4s: sub + kLanes v
  const int fe4 = fe >> 2;
  const int Fp = (F + 3) & ~3;                // an s or c row, in floats
  const int Fp4 = Fp >> 2;
  for (int t = tid; t < fe * 8; t += kThreads)
    s_rate[(t % 8) * fe + t / 8] = rates[t];
  const float4* r4 = reinterpret_cast<const float4*>(s_rate);  // [8][fe4]
  float* d1 = scratch;                        // [C][fe]: W or Y deltas
  float* d2 = scratch + (size_t)C * fe;       // [C][fe]: Q deltas
  // the sums, in the global scratch: s [UB][Fp], c [UB][Fp], n [UB]
  float* s_acc = scratch + (size_t)2 * C * fe;
  float* c_acc = s_acc + (size_t)UB * Fp;
  float* n_acc = c_acc + (size_t)UB * Fp;
  const int acc_len = UB * (2 * Fp + 1);
  // kShared: the on-chip copy, [UB][Fp] (s in R, c in Y) and n [UB]
  float* sh_a = reinterpret_cast<float*>(s_buf + 8 * C);
  float* sh_n = sh_a + (size_t)UB * Fp;
  const float* s_read = kShared ? sh_a : s_acc;
  const float* c_read = kShared ? sh_a : c_acc;
  const float* n_read = kShared ? sh_n : n_acc;

  // step k's (ph, ub, ib) and packed chunk into buffer b
  auto prefetch = [&](int k, int b) {
    const int32_t* prow = packed + (int64_t)__ldg(sched_row + k) * 4 * C;
    int32_t* dst = s_buf + b * 4 * C;
    for (int e = tid; e < C; e += kThreads)
      cp_async16(dst + 4 * e, prow + 4 * e);
    if (tid == 0) {
      cp_async4(&s_meta[b][0], sched_ph + k);
      cp_async4(&s_meta[b][1], sched_ub + k);
      cp_async4(&s_meta[b][2], sched_ib + k);
    }
    cp_async_commit();
  };
  if (n_steps > 0) prefetch(0, 0);

  int prev_ub = -1, prev_phase = -1;
  for (int k = 0; k < n_steps; ++k) {
    const int b = k & 1;
    cp_async_wait_all();
    // step k's chunk has landed; everything the previous step wrote is
    // visible to this one (see the comment at the top)
    __syncthreads();
    if (k + 1 < n_steps) prefetch(k + 1, b ^ 1);
    const int32_t* sd = s_buf + b * 4 * C;
    const int phase = s_meta[b][0];
    const int ub = s_meta[b][1];
    const int64_t wbase = (int64_t)ub * UB;
    const int64_t ibase = (int64_t)s_meta[b][2] * IB;
    if (ub != prev_ub) {
      // a new user block: s, c and n start from zero
      for (int t = tid; t < acc_len; t += kThreads) __stcg(s_acc + t, 0.f);
      prev_ub = ub;
      prev_phase = -1;
      __syncthreads();
    }
    if constexpr (kShared) {
      if (phase != prev_phase && phase != kPhaseS) {
        // the sums R or Y read are final (no step of this phase adds to
        // them): copy them on chip once
        const float4* src = reinterpret_cast<const float4*>(
            phase == kPhaseR ? s_acc : c_acc);
        for (int t = tid; t < UB * Fp4; t += kThreads)
          reinterpret_cast<float4*>(sh_a)[t] = __ldcg(src + t);
        if (phase != kPhaseR)
          for (int t = tid; t < UB; t += kThreads) sh_n[t] = __ldcg(n_acc + t);
        __syncthreads();
      }
    }
    prev_phase = phase;

    if (phase == kPhaseS) {
      // s[u] += wt * Y[i] on the factor columns
      for (int p0 = warp * SPW; p0 < C; p0 += kStep * G) {
        const int s0 = p0 + half;
        float4 y[G][V];
        float wt[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int s = s0 + g * kStep;
          wt[g] = s < C ? __int_as_float(sd[3 * C + s]) : 0.f;
          const float4* yrow = reinterpret_cast<const float4*>(
              Y + (wt[g] != 0.f ? ibase + sd[C + s] : 0) * fe);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            y[g][v] = wt[g] != 0.f && c4 < Fp4
                          ? __ldcg(yrow + c4)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (wt[g] == 0.f) continue;        // padded slot
          float* srow = s_acc + (size_t)sd[s0 + g * kStep] * Fp;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            const float4 yv = y[g][v];
            if (c4 < Fp4)
              acc_add4(srow + 4 * c4,
                       make_float4(yv.x * wt[g], yv.y * wt[g], yv.z * wt[g],
                                   yv.w * wt[g]),
                       4 * c4, F);
          }
        }
      }
    } else if (phase == kPhaseR) {
      // gather and gradient; every read sees the pre-chunk rows
      for (int p0 = warp * SPW; p0 < C; p0 += kStep * G) {
        const int s0 = p0 + half;
        float4 wu[G][V], qi[G][V], sa[G][V];
        float wt[G], inv[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int s = s0 + g * kStep;
          wt[g] = s < C ? __int_as_float(sd[3 * C + s]) : 0.f;
          const bool live = wt[g] != 0.f;
          const float* wrow = W + (live ? wbase + sd[s] : 0) * fe;
          const float4* qrow = reinterpret_cast<const float4*>(
              Q + (live ? ibase + sd[C + s] : 0) * fe);
          const float* srow = s_read + (size_t)(live ? sd[s] : 0) * Fp;
          inv[g] = live ? __ldcg(wrow + F + 2) : 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            const bool ld = live && c4 < fe4;
            const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            wu[g][v] = ld ? __ldcg(reinterpret_cast<const float4*>(wrow) + c4)
                          : z;
            qi[g][v] = ld ? __ldcg(qrow + c4) : z;
            sa[g][v] = live && c4 < Fp4 ? acc_load4<kShared>(srow + 4 * c4)
                                        : z;
          }
        }
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
          const int s = s0 + g * kStep;
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
          float* crow = c_acc + (size_t)sd[s] * Fp;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            if (c4 >= fe4) continue;
            const size_t at = (size_t)s * fe + 4 * c4;
            const float4 wl = r4[kWLr * fe4 + c4];
            const float4 ql = r4[kQLr * fe4 + c4];
            if (f4_any(wl))
              *reinterpret_cast<float4*>(d1 + at) =
                  f4_delta(wl, gr, qi[g][v], wt[g], r4[kWReg * fe4 + c4],
                           wu[g][v]);
            if (f4_any(ql))
              *reinterpret_cast<float4*>(d2 + at) =
                  f4_delta(ql, gr, su[v], wt[g], r4[kQReg * fe4 + c4],
                           qi[g][v]);
            // c is not read in the R phase: add straight away
            const float4 mf = r4[kMf * fe4 + c4];
            const float4 q = qi[g][v];
            if (c4 < Fp4)
              acc_add4(crow + 4 * c4,
                       make_float4(mf.x * ginv * q.x, mf.y * ginv * q.y,
                                   mf.z * ginv * q.z, mf.w * ginv * q.w),
                       4 * c4, F);
          }
          if (sub == 0) atomicAdd(n_acc + sd[s], wt[g]);
        }
      }
      __syncthreads();  // every gather of the chunk precedes every atomic
      // scatter-add; float4s whose rate is 0 (constants, padding) stay
      for (int p0 = warp * SPW; p0 < C; p0 += kStep * G) {
        const int s0 = p0 + half;
        float4 dw[G][V], dq[G][V];
        bool live[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int s = s0 + g * kStep;
          live[g] = s < C && __int_as_float(sd[3 * C + s]) != 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            const size_t at = (size_t)s * fe + 4 * c4;
            if (live[g] && c4 < fe4) {
              if (f4_any(r4[kWLr * fe4 + c4]))
                dw[g][v] = __ldcg(reinterpret_cast<const float4*>(d1 + at));
              if (f4_any(r4[kQLr * fe4 + c4]))
                dq[g][v] = __ldcg(reinterpret_cast<const float4*>(d2 + at));
            }
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (!live[g]) continue;
          const int s = s0 + g * kStep;
          float4* wrow = reinterpret_cast<float4*>(W + (wbase + sd[s]) * fe);
          float4* qrow =
              reinterpret_cast<float4*>(Q + (ibase + sd[C + s]) * fe);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            if (c4 >= fe4) continue;
            if (f4_any(r4[kWLr * fe4 + c4])) atomicAdd(wrow + c4, dw[g][v]);
            if (f4_any(r4[kQLr * fe4 + c4])) atomicAdd(qrow + c4, dq[g][v]);
          }
        }
      }
    } else {
      // Y phase: the deltas from the pre-chunk rows, then the scatter
      for (int p0 = warp * SPW; p0 < C; p0 += kStep * G) {
        const int s0 = p0 + half;
        float4 y[G][V], ca[G][V];
        float wt[G], n[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int s = s0 + g * kStep;
          wt[g] = s < C ? __int_as_float(sd[3 * C + s]) : 0.f;
          const bool live = wt[g] != 0.f;
          const float4* yrow = reinterpret_cast<const float4*>(
              Y + (live ? ibase + sd[C + s] : 0) * fe);
          const int u = live ? sd[s] : 0;
          const float* crow = c_read + (size_t)u * Fp;
          n[g] = live ? acc_load<kShared>(n_read + u) : 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            y[g][v] = live && c4 < fe4 ? __ldcg(yrow + c4) : z;
            ca[g][v] = live && c4 < Fp4 ? acc_load4<kShared>(crow + 4 * c4)
                                        : z;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (wt[g] == 0.f) continue;
          const int s = s0 + g * kStep;
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
            *reinterpret_cast<float4*>(d1 + (size_t)s * fe + 4 * c4) =
                make_float4(yl.x * w * (mf.x * c.x - nn * yr.x * yv.x),
                            yl.y * w * (mf.y * c.y - nn * yr.y * yv.y),
                            yl.z * w * (mf.z * c.z - nn * yr.z * yv.z),
                            yl.w * w * (mf.w * c.w - nn * yr.w * yv.w));
          }
        }
      }
      __syncthreads();  // every gather of the chunk precedes every atomic
      for (int p0 = warp * SPW; p0 < C; p0 += kStep * G) {
        const int s0 = p0 + half;
        float4 dy[G][V];
        bool live[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int s = s0 + g * kStep;
          live[g] = s < C && __int_as_float(sd[3 * C + s]) != 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            if (live[g] && c4 < fe4 && f4_any(r4[kYLr * fe4 + c4]))
              dy[g][v] = __ldcg(reinterpret_cast<const float4*>(
                  d1 + (size_t)s * fe + 4 * c4));
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (!live[g]) continue;
          float4* yrow = reinterpret_cast<float4*>(
              Y + (ibase + sd[C + s0 + g * kStep]) * fe);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c4 = sub + kLanes * v;
            if (c4 < fe4 && f4_any(r4[kYLr * fe4 + c4]))
              atomicAdd(yrow + c4, dy[g][v]);
          }
        }
      }
    }
  }
}

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns the first CUDA error of the launch. Step k runs
// phase sched_ph[k] on chunk sched_row[k] of `packed`, touching W rows
// sched_ub[k] * UB + u_loc and Q/Y rows sched_ib[k] * IB + i_loc.
// `scratch` holds 2 * C * fe + UB * (2 Fp + 1) floats (Fp = F rounded up
// to 4): the deltas, then s, c and n. shared_acc: R and Y read the sums
// from a copy in shared memory. fe is a multiple of 4, at most 256, C a
// multiple of 4, and the shared memory, 32 fe + 32 C bytes, plus 4 UB
// (Fp + 1) with shared_acc, at most 227 KB (ops/svdpp_epoch.py checks all
// three and picks shared_acc).
extern "C" int mml_svdpp_epoch(float* W, float* Q, float* Y,
                               const int32_t* packed, const int32_t* sched_ph,
                               const int32_t* sched_ub,
                               const int32_t* sched_ib,
                               const int32_t* sched_row, const float* rates,
                               float* scratch, int n_steps, int C, int UB,
                               int IB, int fe, int F, float gb,
                               float min_rating, float rating_range, int loss,
                               int sigmoid, int shared_acc, void* stream) {
  if (n_steps == 0) return (int)cudaSuccess;
  const int Fp = (F + 3) & ~3;
  const size_t smem = (size_t)fe * 8 * sizeof(float) +
                      (size_t)8 * C * sizeof(int32_t) +
                      (shared_acc ? (size_t)UB * (Fp + 1) * sizeof(float)
                                  : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define MML_LAUNCH(V, SPW, G, SH)                                             \
  do {                                                                        \
    err = cudaFuncSetAttribute(svdpp_epoch_kernel<V, SPW, G, SH>,             \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                               (int)smem);                                    \
    if (err != cudaSuccess) return (int)err;                                  \
    svdpp_epoch_kernel<V, SPW, G, SH><<<1, kThreads, smem, st>>>(             \
        W, Q, Y, packed, sched_ph, sched_ub, sched_ib, sched_row, rates,      \
        scratch, n_steps, C, UB, IB, fe, F, gb, min_rating, rating_range,     \
        loss, sigmoid);                                                       \
  } while (0)
#define MML_LAUNCH_WIDTH(SH)       \
  do {                             \
    if (fe <= 32) {                \
      MML_LAUNCH(1, 4, 2, SH);     \
    } else if (fe <= 64) {         \
      MML_LAUNCH(1, 2, 2, SH);     \
    } else if (fe <= 128) {        \
      MML_LAUNCH(1, 1, 2, SH);     \
    } else {                       \
      MML_LAUNCH(2, 1, 1, SH);     \
    }                              \
  } while (0)
  if (shared_acc) {
    MML_LAUNCH_WIDTH(true);
  } else {
    MML_LAUNCH_WIDTH(false);
  }
#undef MML_LAUNCH_WIDTH
#undef MML_LAUNCH
  return (int)cudaGetLastError();
}
