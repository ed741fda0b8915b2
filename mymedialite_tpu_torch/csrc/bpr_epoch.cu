// One BPR epoch over the chunk plan: a sampling kernel over the whole
// card, then the serial walk of the chunks in one thread block, both
// launched by one call.
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
// thread per (chunk, slot) over all SMs, into neg [nc, 2, C] (the local
// negative and the bits of its 0/1 success weight); padding slots are
// sampled too.
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
// on the tiled schedule means isl == jsl and ibr == jbr) summing, as the
// TPU kernels' i-block write before the j-block read-modify-write. Slots
// of weight 0 write nothing. The TPU idioms (one-hot matmul gathers and
// scatters, the [.., C] orientation, the byte-row matmul of the bitmask,
// bf16 operands, the VMEM copy of H) are not carried over: on Hopper the
// gathers are indexed loads and the scatter atomic adds.
//
// The walk. As for the rating epoch (sgd_epoch.cu), the visit order
// groups chunks by user block and consecutive chunks share a user block
// or an item block, so one thread block walks the whole order, and a
// chunk's time is its chain of dependent round trips to L2. So:
// - the next chunk's packed row and its sampled (j, ok) are copied into a
//   second shared buffer with cp.async while this chunk runs, and a chunk
//   starts with its indices on chip;
// - a row is cut into float4s, one per lane (two per lane past 128
//   columns), so at fe <= 64 a warp serves two slots per pass, and each
//   warp issues the row loads of several passes before it uses any; the
//   deltas go to a global scratch [3, C, fe] that the same lanes read
//   back after the barrier, several passes' loads before their atomics;
// - the scatter is float4 atomic adds (red.global.add.v4.f32 on sm_90),
//   and a float4 whose learning rates are all 0 is not sent: its deltas
//   are exactly 0 (the zero padding of the tables to fe columns, and the
//   users' constant column);
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
// The walk is bound by L2 latency (dependent round trips per chunk) and
// one SM's atomic throughput, not by HBM bandwidth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSampleThreads = 256;
constexpr int kOneBits = 0x3f800000;  // bits of 1.0f
constexpr unsigned kFull = 0xffffffffu;

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

// One thread per (chunk k, slot s): the slot's negative into neg [nc, 2, C].
__global__ void __launch_bounds__(kSampleThreads)
bpr_sample_kernel(const int32_t* __restrict__ packed,
                  const int32_t* __restrict__ order_row,
                  const int32_t* __restrict__ jb_v,
                  const int32_t* __restrict__ nval_v,
                  const int32_t* __restrict__ bkt_v,
                  const int32_t* __restrict__ keys,
                  const unsigned char* __restrict__ bitmask,
                  const float* __restrict__ cdf,
                  const int32_t* __restrict__ bits,
                  int32_t* __restrict__ neg,
                  int nc, int C, int UB, int IB, int trials, int kcap,
                  int wbpr, int membership) {
  const int64_t t = (int64_t)blockIdx.x * kSampleThreads + threadIdx.x;
  if (t >= (int64_t)nc * C) return;
  const int k = (int)(t / C);
  const int s = (int)(t - (int64_t)k * C);
  const int u = __ldg(packed + (int64_t)__ldg(order_row + k) * 4 * C + s);
  const int nv = __ldg(nval_v + k);
  const int64_t bkt = __ldg(bkt_v + k);
  const float* crow = wbpr ? cdf + (int64_t)__ldg(jb_v + k) * IB : nullptr;
  const int nb8 = IB >> 3;
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
}

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

// V float4s per lane per row (fe <= 128 V), SPW slots per warp pass (a
// slot on 32 / SPW lanes), G passes in flight per warp.
template <int V, int SPW, int G>
__global__ void __launch_bounds__(kThreads, 1)
bpr_walk_kernel(float* __restrict__ W, float* __restrict__ H,
                const int32_t* __restrict__ packed,
                const int32_t* __restrict__ order_ub,
                const int32_t* __restrict__ order_ib,
                const int32_t* __restrict__ order_row,
                const int32_t* __restrict__ jb_v,
                const int32_t* __restrict__ neg,
                const float* __restrict__ rates,
                float* __restrict__ scratch,
                int nc, int C, int UB, int IB, int fe, int soft_margin) {
  constexpr int kLanes = 32 / SPW;            // lanes per slot
  constexpr int kStep = kWarps * SPW;         // slots per pass of the block
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_rate = reinterpret_cast<float*>(smem);   // [6][fe], by rate
  int32_t* s_buf = reinterpret_cast<int32_t*>(s_rate + 6 * fe);  // [2][6C]
  __shared__ int32_t s_meta[2][4];                 // ub, ib, jb per buffer

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = lane / kLanes;             // this lane's slot of a pass
  const int sub = lane % kLanes;              // its float4s: sub + kLanes v
  const int fe4 = fe >> 2;
  for (int t = tid; t < fe * 6; t += kThreads)
    s_rate[(t % 6) * fe + t / 6] = rates[t];
  const float4* r4 = reinterpret_cast<const float4*>(s_rate);  // [6][fe4]
  float* dW = scratch;                        // [C][fe]
  float* dI = scratch + (size_t)C * fe;
  float* dJ = scratch + (size_t)2 * C * fe;

  // chunk k's packed and neg rows into buffer b
  auto prefetch = [&](int k, int b) {
    const int32_t* prow = packed + (int64_t)__ldg(order_row + k) * 4 * C;
    const int32_t* nrow = neg + (int64_t)k * 2 * C;
    int32_t* dst = s_buf + b * 6 * C;
    for (int e = tid; e < C; e += kThreads)
      cp_async16(dst + 4 * e, prow + 4 * e);
    for (int e = tid; e < C / 2; e += kThreads)
      cp_async16(dst + 4 * C + 4 * e, nrow + 4 * e);
    if (tid == 0) {
      cp_async4(&s_meta[b][0], order_ub + k);
      cp_async4(&s_meta[b][1], order_ib + k);
      cp_async4(&s_meta[b][2], jb_v + k);
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
    const int32_t* sd = s_buf + b * 6 * C;
    const int64_t wbase = (int64_t)s_meta[b][0] * UB;
    const int64_t ibase = (int64_t)s_meta[b][1] * IB;
    const int64_t jbase = (int64_t)s_meta[b][2] * IB;

    // gather and gradient: G passes' row loads issued before any is used;
    // the pass loop is uniform across the warp (its shuffles need every
    // lane), slots past C weigh 0
    for (int p0 = warp * SPW; p0 < C; p0 += kStep * G) {
      const int s0 = p0 + half;
      float4 wu[G][V], hi[G][V], hj[G][V];
      float wgt[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = s0 + g * kStep;
        wgt[g] = s < C ? slot_weight(sd, C, s) : 0.f;
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
        const int s = s0 + g * kStep;
        if (wgt[g] == 0.f) continue;          // padding or no negative
        const float gr = soft_margin ? (x < 1.f ? wgt[g] : 0.f)
                                     : wgt[g] / (1.f + expf(x));
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c4 = sub + kLanes * v;
          if (c4 >= fe4) continue;
          const size_t at = (size_t)s * fe + 4 * c4;
          const float4 ng = make_float4(-wu[g][v].x, -wu[g][v].y,
                                        -wu[g][v].z, -wu[g][v].w);
          *reinterpret_cast<float4*>(dW + at) =
              f4_delta(r4[0 * fe4 + c4], gr, f4_sub(hi[g][v], hj[g][v]),
                       wgt[g], r4[1 * fe4 + c4], wu[g][v]);
          *reinterpret_cast<float4*>(dI + at) =
              f4_delta(r4[2 * fe4 + c4], gr, wu[g][v], wgt[g],
                       r4[3 * fe4 + c4], hi[g][v]);
          *reinterpret_cast<float4*>(dJ + at) =
              f4_delta(r4[4 * fe4 + c4], gr, ng, wgt[g], r4[5 * fe4 + c4],
                       hj[g][v]);
        }
      }
    }
    __syncthreads();  // every gather of the chunk precedes every atomic

    // scatter-add; duplicate rows within the chunk sum. Each lane reads
    // back the deltas it wrote itself (program order), G passes' loads
    // before their atomics
    for (int p0 = warp * SPW; p0 < C; p0 += kStep * G) {
      const int s0 = p0 + half;
      float4 dw[G][V], di[G][V], dj[G][V];
      bool live[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int s = s0 + g * kStep;
        live[g] = s < C && slot_weight(sd, C, s) != 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c4 = sub + kLanes * v;
          const size_t at = (size_t)s * fe + 4 * c4;
          if (live[g] && c4 < fe4) {
            dw[g][v] = __ldcg(reinterpret_cast<const float4*>(dW + at));
            di[g][v] = __ldcg(reinterpret_cast<const float4*>(dI + at));
            dj[g][v] = __ldcg(reinterpret_cast<const float4*>(dJ + at));
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (!live[g]) continue;
        const int s = s0 + g * kStep;
        float4* wrow = reinterpret_cast<float4*>(W + (wbase + sd[s]) * fe);
        float4* irow = reinterpret_cast<float4*>(H + (ibase + sd[C + s]) * fe);
        float4* jrow = reinterpret_cast<float4*>(H + (jbase + sd[4 * C + s]) * fe);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c4 = sub + kLanes * v;
          if (c4 >= fe4) continue;
          // a float4 whose rates are all 0 has exactly zero deltas
          if (f4_any(r4[0 * fe4 + c4])) atomicAdd(wrow + c4, dw[g][v]);
          if (f4_any(r4[2 * fe4 + c4])) atomicAdd(irow + c4, di[g][v]);
          if (f4_any(r4[4 * fe4 + c4])) atomicAdd(jrow + c4, dj[g][v]);
        }
      }
    }
  }
}

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns the first CUDA error of the launches. Chunk
// k's positive block is order_ib[k] and its negative block jb[k],
// absolute item blocks on either schedule. membership: 0 reads the key
// rows `keys` [*, kcap], 1 the bitmask, 2 the sub-bucketed key rows
// `keys` [n_bkt * 8, kcap]; `cdf` is read when wbpr is 1; `neg_out`
// [nc, 2, C] receives every slot's negative and is required (the walk
// reads it); `scratch` holds 3 * C * fe floats; fe is a multiple of 4, at
// most 256, C a multiple of 4 (16-byte pieces of each chunk's rows), and
// the shared memory, 24 fe + 48 C bytes, at most 227 KB (ops/bpr_epoch.py
// checks all three).
extern "C" int mml_bpr_epoch(float* W, float* H, const int32_t* packed,
                             const int32_t* order_ub, const int32_t* order_ib,
                             const int32_t* order_row, const int32_t* jb,
                             const int32_t* nval, const int32_t* bkt,
                             const int32_t* keys, const void* bitmask,
                             const float* cdf, const int32_t* bits,
                             const float* rates, float* scratch,
                             int32_t* neg_out, int nc, int C, int UB, int IB,
                             int fe, int trials, int kcap, int soft_margin,
                             int wbpr, int membership, void* stream) {
  if (nc == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t slots = (int64_t)nc * C;
  bpr_sample_kernel<<<(unsigned)((slots + kSampleThreads - 1) /
                                 kSampleThreads),
                      kSampleThreads, 0, st>>>(
      packed, order_row, jb, nval, bkt, keys,
      static_cast<const unsigned char*>(bitmask), cdf, bits, neg_out, nc, C,
      UB, IB, trials, kcap, wbpr, membership);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = (size_t)fe * 6 * sizeof(float) +
                      (size_t)12 * C * sizeof(int32_t);
#define MML_LAUNCH(V, SPW, G)                                                \
  do {                                                                       \
    err = cudaFuncSetAttribute(bpr_walk_kernel<V, SPW, G>,                   \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               (int)smem);                                   \
    if (err != cudaSuccess) return (int)err;                                 \
    bpr_walk_kernel<V, SPW, G><<<1, kThreads, smem, st>>>(                   \
        W, H, packed, order_ub, order_ib, order_row, jb, neg_out, rates,     \
        scratch, nc, C, UB, IB, fe, soft_margin);                            \
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
