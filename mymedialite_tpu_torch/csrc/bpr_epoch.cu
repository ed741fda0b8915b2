// One BPR epoch over the chunk plan, negatives sampled inside the kernel,
// in one launch.
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
// the keys of the users that share the slot's u_loc & 7. The
// first trial that is not a positive wins; when all T trials hit
// positives, j = 0 and the slot's weight is 0. Padding slots are sampled
// too, so neg_out covers every slot.
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
// TPU kernels' i-block write before the j-block read-modify-write. The
// TPU idioms (one-hot matmul gathers and scatters, the [.., C]
// orientation, the byte-row matmul of the bitmask, bf16 operands, the
// VMEM copy of H) are not carried over: on Hopper the
// gathers are indexed loads, the membership test one byte load or a
// binary search, the scatter atomic adds.
//
// Design and bound. As for the rating epoch (sgd_epoch.cu), the visit
// order groups chunks by user block and consecutive chunks share a user
// block or an item block, so one thread block walks the whole order.
// Per chunk: stage the chunk's four rows (and the CDF row for WBPR) in
// shared memory; sample one thread per slot, all T trials issued without
// early exit so their loads overlap; gather and stage the three deltas
// in a global scratch [3, C, fe] (warps over slots, lanes over columns,
// reads through L2 with ld.global.cg); a barrier; atomic scatter; a
// device-scope fence and a barrier before the next chunk. Slots of
// weight 0 are skipped: their deltas are zero. The epoch is bound by L2
// latency (dependent round trips per slot) and one SM's atomic
// throughput, not by HBM bandwidth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kOneBits = 0x3f800000;  // bits of 1.0f

// membership forms
constexpr int kKeys = 0;
constexpr int kBitmask = 1;
constexpr int kSubkeys = 2;
constexpr int kSubBuckets = 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// #(row[0..n) < x) for a nondecreasing row
__device__ __forceinline__ int count_less(const float* row, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < x) lo = mid + 1; else hi = mid;
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

// CPL = columns per lane: fe <= 32 * CPL.
template <int CPL>
__global__ void __launch_bounds__(kThreads, 1)
bpr_epoch_kernel(float* __restrict__ W, float* __restrict__ H,
                 const int32_t* __restrict__ packed,
                 const int32_t* __restrict__ order_ub,
                 const int32_t* __restrict__ order_ib,
                 const int32_t* __restrict__ order_row,
                 const int32_t* __restrict__ jb_v,
                 const int32_t* __restrict__ nval_v,
                 const int32_t* __restrict__ bkt_v,
                 const int32_t* __restrict__ keys,
                 const unsigned char* __restrict__ bitmask,
                 const float* __restrict__ cdf,
                 const int32_t* __restrict__ bits,
                 const float* __restrict__ rates,
                 float* __restrict__ scratch,
                 int32_t* __restrict__ neg_out,
                 int nc, int C, int UB, int IB, int fe, int trials,
                 int kcap, int soft_margin, int wbpr, int membership) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_rates = reinterpret_cast<float*>(smem);             // [fe][6]
  int32_t* s_d = reinterpret_cast<int32_t*>(s_rates + fe * 6);  // [4][C]
  int32_t* s_j = s_d + 4 * C;                                   // [C]
  float* s_w = reinterpret_cast<float*>(s_j + C);               // [C]
  float* s_cdf = s_w + C;                                       // [IB]

  for (int t = threadIdx.x; t < fe * 6; t += kThreads) s_rates[t] = rates[t];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb8 = IB >> 3;
  float* dW = scratch;                          // [C][fe]
  float* dI = scratch + (size_t)C * fe;         // [C][fe]
  float* dJ = scratch + (size_t)2 * C * fe;     // [C][fe]

  for (int k = 0; k < nc; ++k) {
    const int jb = jb_v[k];
    const int32_t* d = packed + (int64_t)order_row[k] * 4 * C;
    for (int t = threadIdx.x; t < 4 * C; t += kThreads) s_d[t] = __ldg(d + t);
    if (wbpr) {
      const float* crow = cdf + (int64_t)jb * IB;
      for (int t = threadIdx.x; t < IB; t += kThreads) s_cdf[t] = __ldg(crow + t);
    }
    __syncthreads();

    // phase 0: the negative of every slot, one thread per slot
    const int nv = nval_v[k];
    const int64_t bkt = bkt_v[k];
    const int32_t* krow = keys + bkt * kcap;
    for (int s = threadIdx.x; s < C; s += kThreads) {
      const int u = s_d[s];
      const int32_t* b = bits + (int64_t)k * trials * C + s;
      const unsigned char* mrow = bitmask + (bkt * UB + u) * nb8;
      const int32_t* srow =
          membership == kSubkeys
              ? keys + (bkt * kSubBuckets + (u & (kSubBuckets - 1))) * kcap
              : krow;
      int j = 0;
      bool ok = false;
#pragma unroll 8
      for (int t = 0; t < trials; ++t) {
        const int r = __ldg(b + (int64_t)t * C) & 0x7fffffff;
        int cand;
        if (wbpr) {
          cand = count_less(s_cdf, IB, __int2float_rn(r) * (1.0f / 2147483648.0f));
        } else {
          cand = r % nv;
        }
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
      const float wgt = __int_as_float(s_d[2 * C + s]) *
                        __int_as_float(s_d[3 * C + s]) * (ok ? 1.f : 0.f);
      s_j[s] = j;
      s_w[s] = wgt;
      if (neg_out != nullptr) {
        neg_out[(int64_t)k * 2 * C + s] = j;
        neg_out[(int64_t)k * 2 * C + C + s] = ok ? kOneBits : 0;
      }
    }
    __syncthreads();

    const int64_t wbase = (int64_t)order_ub[k] * UB;
    const int64_t ibase = (int64_t)order_ib[k] * IB;
    const int64_t jbase = (int64_t)jb * IB;

    // phase 1: gather and gradient; every read sees the pre-chunk tables
    for (int s = warp; s < C; s += kWarps) {
      const float wgt = s_w[s];
      if (wgt == 0.f) continue;  // padding or no negative: zero deltas
      const float* wrow = W + (wbase + s_d[s]) * fe;
      const float* irow = H + (ibase + s_d[C + s]) * fe;
      const float* jrow = H + (jbase + s_j[s]) * fe;
      float wu[CPL], hi[CPL], hj[CPL];
      float x = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = lane + 32 * q;
        wu[q] = c < fe ? __ldcg(wrow + c) : 0.f;
        hi[q] = c < fe ? __ldcg(irow + c) : 0.f;
        hj[q] = c < fe ? __ldcg(jrow + c) : 0.f;
        x = fmaf(wu[q], hi[q] - hj[q], x);
      }
      x = warp_sum(x);
      const float g = soft_margin ? (x < 1.f ? wgt : 0.f)
                                  : wgt / (1.f + expf(x));
      float* dw = dW + (size_t)s * fe;
      float* di = dI + (size_t)s * fe;
      float* dj = dJ + (size_t)s * fe;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = lane + 32 * q;
        if (c < fe) {
          const float* r = s_rates + 6 * c;
          dw[c] = r[0] * (g * (hi[q] - hj[q]) - wgt * r[1] * wu[q]);
          di[c] = r[2] * (g * wu[q] - wgt * r[3] * hi[q]);
          dj[c] = r[4] * (-g * wu[q] - wgt * r[5] * hj[q]);
        }
      }
    }
    __syncthreads();

    // phase 2: scatter-add; duplicate rows within the chunk sum
    for (int s = warp; s < C; s += kWarps) {
      if (s_w[s] == 0.f) continue;
      float* wrow = W + (wbase + s_d[s]) * fe;
      float* irow = H + (ibase + s_d[C + s]) * fe;
      float* jrow = H + (jbase + s_j[s]) * fe;
      const float* dw = dW + (size_t)s * fe;
      const float* di = dI + (size_t)s * fe;
      const float* dj = dJ + (size_t)s * fe;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = lane + 32 * q;
        if (c < fe) {
          atomicAdd(wrow + c, dw[c]);
          atomicAdd(irow + c, di[c]);
          atomicAdd(jrow + c, dj[c]);
        }
      }
    }
    // the next chunk's gathers must see every atomic of this one
    __threadfence();
    __syncthreads();
  }
}

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch. Chunk k's
// positive block is order_ib[k] and its negative block jb[k], absolute
// item blocks on either schedule. membership: 0 reads the key rows `keys`
// [*, kcap], 1 the bitmask, 2 the sub-bucketed key rows `keys`
// [n_bkt * 8, kcap]; `cdf` is read when wbpr is 1; `neg_out` may be null.
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
  const size_t smem = (size_t)fe * 6 * sizeof(float) +
                      (size_t)6 * C * sizeof(int32_t) +
                      (wbpr ? (size_t)IB * sizeof(float) : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* bm = static_cast<const unsigned char*>(bitmask);
#define MML_LAUNCH(CPL)                                                      \
  bpr_epoch_kernel<CPL><<<1, kThreads, smem, st>>>(                          \
      W, H, packed, order_ub, order_ib, order_row, jb, nval, bkt, keys, bm,  \
      cdf, bits, rates, scratch, neg_out, nc, C, UB, IB, fe, trials, kcap,   \
      soft_margin, wbpr, membership)
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
