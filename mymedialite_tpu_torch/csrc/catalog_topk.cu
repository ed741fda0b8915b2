// Fused catalog scoring + per-user top-k, in one launch.
//
// Replaces mymedialite_tpu/ops/pallas_topk.py:55 _topk_kernel (entry
// catalog_topk :108): scores = user_rows @ item_table.T, item by item,
// with masked items (mask[u, i] == 0) scored -3e38, and the k best of each
// user's row kept under the order (value descending, id ascending), which
// is the order of lax.top_k and of a stable descending sort. The score
// matrix never reaches device memory.
//
// The TPU kernel keeps a [BU, k] running list in VMEM and merges each
// [BU, T] tile into it with k rounds of (max, first argmax, mask) over the
// [BU, k + T] merge buffer: a VPU idiom that touches every score k times.
// Here one warp owns one user and a sorted list of k <= 64 entries in
// registers (lane l holds entries l and l + 32). Each lane scores four
// items of a 128-item tile; a lane whose (score, id) ranks before the
// list's k-th entry is a candidate; candidates are inserted one at a time,
// picked by a ballot: the insert position is the number of entries that
// rank before the new one (two ballots), the entries behind it move down
// one place through warp shuffles, and the k-th entry is read again, so a
// candidate that no longer beats it drops out. After the first tiles few
// items beat the k-th entry, and most tiles insert nothing. Ties are
// settled by the id in the comparison itself, so the order of insertion
// does not matter and tile edges need no care.
//
// Item tiles [128, f] are staged in shared memory once per CTA and read by
// its eight warps (eight users). Rows are padded to an odd number of
// float4s, so the 32 lanes' 16-byte loads of a column group fall in
// distinct banks; the pad columns are zero in the tile and in the user
// rows. Ids >= N (the last tile's tail) are never candidates.
//
// Bound: 2 B N f float32 operations against B f + N f floats and B N mask
// bytes read and B k (id, value) pairs written. At the serving shapes
// (B = 1024 users, f = 41, N = 17,770 or 62,423) the operations bound it;
// this simple kernel is limited by shared-memory loads (one 16-byte load
// per 4 FMAs) and by one CTA per SM at B = 1024, and makes no use of the
// tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // users per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 128;                // items per staged tile
constexpr int kPerLane = kTile / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -3.0e38f;

// (v, id) ranks before (bv, bid): value descending, then id ascending
__device__ __forceinline__ bool ranks_before(float v, int id, float bv,
                                             int bid) {
  return v > bv || (v == bv && id < bid);
}

__global__ void __launch_bounds__(kThreads)
catalog_topk_kernel(const float* __restrict__ users,
                    const float* __restrict__ items,
                    const int8_t* __restrict__ mask,
                    int32_t* __restrict__ out_ids,
                    float* __restrict__ out_vals,
                    int B, int N, int f, int f4, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_items = reinterpret_cast<float4*>(smem);  // [kTile][f4]
  float4* s_users = s_items + kTile * f4;             // [kWarps][f4]
  float* s_items_f = reinterpret_cast<float*>(s_items);
  const int width = 4 * f4;                           // floats per row

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int user = blockIdx.x * kWarps + warp;
  const bool active = user < B;

  // zero the tile once: its pad columns stay zero
  for (int t = threadIdx.x; t < kTile * width; t += kThreads)
    s_items_f[t] = 0.f;
  float* su = reinterpret_cast<float*>(s_users + warp * f4);
  for (int c = lane; c < width; c += 32)
    su[c] = (active && c < f) ? users[(int64_t)user * f + c] : 0.f;

  // the running list; (-inf, INT_MAX) ranks after every real item
  const float kEmpty = __int_as_float((int)0xff800000u);
  float v0 = kEmpty, v1 = kEmpty;
  int i0 = 0x7fffffff, i1 = 0x7fffffff;
  float tv = kEmpty;                 // the k-th entry
  int ti = 0x7fffffff;
  const int k_lane = (k - 1) & 31;
  const bool k_high = k - 1 >= 32;
  const int8_t* mrow = (mask != nullptr && active)
                           ? mask + (int64_t)user * N : nullptr;

  for (int base = 0; base < N; base += kTile) {
    __syncthreads();  // the previous tile is consumed (and the zeroing done)
    const int n_floats = min(kTile, N - base) * f;
    const float* src = items + (int64_t)base * f;
    for (int t = threadIdx.x; t < n_floats; t += kThreads) {
      const int r = t / f;
      s_items_f[r * width + (t - r * f)] = __ldg(src + t);
    }
    __syncthreads();
    if (!active) continue;

    float acc[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;
    const float4* su4 = s_users + warp * f4;
    for (int c = 0; c < f4; ++c) {
      const float4 u = su4[c];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const float4 t = s_items[(lane + 32 * j) * f4 + c];
        acc[j] = fmaf(u.x, t.x, acc[j]);
        acc[j] = fmaf(u.y, t.y, acc[j]);
        acc[j] = fmaf(u.z, t.z, acc[j]);
        acc[j] = fmaf(u.w, t.w, acc[j]);
      }
    }

#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int id = base + lane + 32 * j;
      bool pending = id < N;
      float s = acc[j];
      if (pending && mrow != nullptr && mrow[id] == 0) s = kMasked;
      unsigned todo =
          __ballot_sync(kFull, pending && ranks_before(s, id, tv, ti));
      while (todo) {
        const int src_lane = __ffs(todo) - 1;
        const float nv = __shfl_sync(kFull, s, src_lane);
        const int ni = __shfl_sync(kFull, id, src_lane);
        const int pos =
            __popc(__ballot_sync(kFull, ranks_before(v0, i0, nv, ni))) +
            __popc(__ballot_sync(kFull, ranks_before(v1, i1, nv, ni)));
        // entries pos.. move down one place; entry 63 drops off
        const float up_v0 = __shfl_up_sync(kFull, v0, 1);
        const int up_i0 = __shfl_up_sync(kFull, i0, 1);
        const float up_v1 = __shfl_up_sync(kFull, v1, 1);
        const int up_i1 = __shfl_up_sync(kFull, i1, 1);
        const float v31 = __shfl_sync(kFull, v0, 31);
        const int i31 = __shfl_sync(kFull, i0, 31);
        if (lane > pos) {
          v0 = up_v0;
          i0 = up_i0;
        } else if (lane == pos) {
          v0 = nv;
          i0 = ni;
        }
        if (lane + 32 > pos) {
          v1 = lane == 0 ? v31 : up_v1;
          i1 = lane == 0 ? i31 : up_i1;
        } else if (lane + 32 == pos) {
          v1 = nv;
          i1 = ni;
        }
        tv = __shfl_sync(kFull, k_high ? v1 : v0, k_lane);
        ti = __shfl_sync(kFull, k_high ? i1 : i0, k_lane);
        if (lane == src_lane) pending = false;
        todo = __ballot_sync(kFull, pending && ranks_before(s, id, tv, ti));
      }
    }
  }

  if (active) {
    int32_t* oi = out_ids + (int64_t)user * k;
    float* ov = out_vals + (int64_t)user * k;
    if (lane < k) {
      oi[lane] = i0;
      ov[lane] = v0;
    }
    if (lane + 32 < k) {
      oi[lane + 32] = i1;
      ov[lane + 32] = v1;
    }
  }
}

}  // namespace

// C interface (bound with ctypes). users [B, f], items [N, f] float32,
// mask [B, N] bytes (nonzero = candidate) or null, out_ids / out_vals
// [B, k]; 1 <= k <= 64, k <= N, B >= 1, f <= 384 (checked by the wrapper,
// ops/catalog_topk.py). Launches on `stream`, does not synchronise, and
// returns the first CUDA error of the attribute call or the launch.
extern "C" int mml_catalog_topk(const float* users, const float* items,
                                const int8_t* mask, int32_t* out_ids,
                                float* out_vals, int B, int N, int f, int k,
                                void* stream) {
  int f4 = (f + 3) / 4;
  if ((f4 & 1) == 0) f4 += 1;  // odd row stride in float4s
  const size_t smem = (size_t)(kTile + kWarps) * f4 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      catalog_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kWarps - 1) / kWarps;
  catalog_topk_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      users, items, mask, out_ids, out_vals, B, N, f, f4, k);
  return (int)cudaGetLastError();
}
