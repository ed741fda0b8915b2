// Fused catalog scoring + per-user top-k: a split kernel and a merge
// kernel, both launched by one call.
//
// Replaces mymedialite_tpu/ops/pallas_topk.py:55 _topk_kernel (entry
// catalog_topk :108): scores = user_rows @ item_table.T, item by item,
// with masked items (mask[u, i] == 0) scored -3e38, and the k best of each
// user's row kept under the order (value descending, id ascending), which
// is the order of lax.top_k and of a stable descending sort. The score
// matrix never reaches device memory.
//
// The TPU kernel walks the catalog in order on one core, keeping a [BU, k]
// running list in VMEM and merging each [BU, T] tile into it with k rounds
// of (max, first argmax, mask). Here the catalog is cut into splits of
// whole 128-item tiles and the grid is (user tiles of 32) x (splits), so a
// block of 1,024 users fills the card (ops/catalog_topk.py picks the
// number of splits from B, N, the SM count and how many CTAs an SM holds,
// so that the grid is one round of resident CTAs). Each CTA keeps, for each
// of its 32 users, the top-k of its split; the merge kernel takes each
// user's S x k partial entries to the final k. Under a total order the
// top-k of the union of per-split top-k lists is the global top-k, so the
// result is exact; a split with fewer than k items leaves (-inf, INT_MAX)
// entries, which rank after every real item and never reach the output.
//
// Scoring. A CTA scores a tile of 32 users x 128 items; each thread
// accumulates a 4 x 4 micro-tile in registers (users uy + 8i, items
// ix + 32j), so per float4 column 8 shared 16-byte loads feed 64 FMAs.
// Each score is the sequential FP32 FMA over the columns, as in the
// previous kernel of this file, so the values do not move. The user tile
// is staged once; item tiles are staged in panels of 11 float4 columns
// with cp.async, double-buffered, so the next panel loads while this one
// is scored. Rows are 16-byte aligned because the caller pads the width
// to a multiple of 4 columns with zeros (0 * 0 added to an FP32 sum leaves
// it unchanged). Shared rows are an odd number of float4s apart, and a
// warp's lanes read 4 user rows and 8 consecutive item rows, so the loads
// are free of bank conflicts.
//
// Selection. The tile's scores go to shared memory; each warp owns 4
// users, each with a sorted list of k <= 64 entries in registers (lane l
// holds entries l and l + 32). A lane whose (score, id) ranks before the
// list's k-th entry is a candidate; candidates are inserted one at a time,
// picked by a ballot: the insert position is the number of entries that
// rank before the new one, the entries behind it move down one place
// through warp shuffles, and the k-th entry is read again. After the first
// tiles of a split few items beat the k-th entry. Ties are settled by the
// id in the comparison, so the order of insertion and the tile and split
// edges do not matter. The mask bytes are read coalesced (32 consecutive
// bytes per load), all of a warp's loads issued before the first is used.
//
// Bound: 2 B N f float32 operations against B f + N f floats and B N mask
// bytes read and B k (id, value) pairs written; at the serving shapes
// (B = 1,024, f = 41, N = 17,770 or 62,423) the operations bound it. The
// tensor cores stay out: TF32 or bf16 products move scores by far more
// than the 1e-5 near-tie that decides which ids win, and only a 3xTF32
// split could keep the ids, which is a design of its own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUsers = 32;                    // users per CTA
constexpr int kUsersPerWarp = kUsers / kWarps;
constexpr int kTile = 128;                    // items per tile
constexpr int kPanel = 11;                    // float4 columns per panel, odd
constexpr int kFrag = 4;                      // users and items per thread
constexpr int kScoreStride = kTile + 8;       // conflict-free score stores
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -3.0e38f;
constexpr int kNoId = 0x7fffffff;

// (v, id) ranks before (bv, bid): value descending, then id ascending
__device__ __forceinline__ bool ranks_before(float v, int id, float bv,
                                             int bid) {
  return v > bv || (v == bv && id < bid);
}

// A sorted list of k <= 64 (value, id) entries held by one warp: lane l
// holds entries l (v0, i0) and l + 32 (v1, i1); (tv, ti) is the k-th.
struct TopList {
  float v0, v1, tv;
  int i0, i1, ti;

  __device__ __forceinline__ void init() {
    const float empty = __int_as_float((int)0xff800000u);  // -inf
    v0 = v1 = tv = empty;
    i0 = i1 = ti = kNoId;
  }

  // Insert every lane's (s, id) that is pending and ranks before the k-th
  // entry; k_lane / k_high locate the k-th entry.
  __device__ __forceinline__ void offer(float s, int id, bool pending,
                                        int lane, int k_lane, bool k_high) {
    unsigned todo = __ballot_sync(kFull, pending && ranks_before(s, id, tv, ti));
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

  __device__ __forceinline__ void store(int32_t* oi, float* ov, int lane,
                                        int k) const {
    if (lane < k) {
      oi[lane] = i0;
      ov[lane] = v0;
    }
    if (lane + 32 < k) {
      oi[lane + 32] = i1;
      ov[lane + 32] = v1;
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every committed group but the newest has landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Grid (user tiles, splits). Split s covers items [s * split_items,
// min(N, (s + 1) * split_items)); part_ids / part_vals are [B, splits, k].
// Three CTAs per SM: registers capped at 80, 68 KB of shared memory each
// at f = 44.
__global__ void __launch_bounds__(kThreads, 3)
topk_split_kernel(const float4* __restrict__ users,
                  const float4* __restrict__ items,
                  const int8_t* __restrict__ mask,
                  int32_t* __restrict__ part_ids,
                  float* __restrict__ part_vals,
                  int B, int N, int f4, int k, int split_items) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f4s = f4 | 1;                     // odd user row stride
  float4* s_users = reinterpret_cast<float4*>(smem);       // [kUsers][f4s]
  float4* s_items = s_users + kUsers * f4s;                 // [2][kTile][kPanel]
  float* s_scores =
      reinterpret_cast<float*>(s_items + 2 * kTile * kPanel);  // [kUsers][stride]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int user0 = blockIdx.x * kUsers;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int lo = split * split_items;
  const int hi = min(N, lo + split_items);
  const int n_panels = (f4 + kPanel - 1) / kPanel;
  const int n_stages = (hi - lo + kTile - 1) / kTile * n_panels;
  // this thread's micro-tile: users uy + 8i, items ix + 32j
  const int uy = (warp >> 2) * 4 + (lane >> 3);
  const int ix = (warp & 3) * 8 + (lane & 7);

  // stage s = (tile s / n_panels, panel s % n_panels) into buffer s & 1
  auto stage = [&](int s) {
    const int t = s / n_panels;
    const int c0 = (s - t * n_panels) * kPanel;
    const int kw = min(kPanel, f4 - c0);
    const int base = lo + t * kTile;
    float4* dst = s_items + (s & 1) * kTile * kPanel;
    for (int e = tid; e < kTile * kw; e += kThreads) {
      const int r = e / kw;
      const int c = e - r * kw;
      const bool ok = base + r < hi;
      cp_async16(dst + r * kPanel + c,
                 items + (int64_t)(ok ? base + r : 0) * f4 + c0 + c, ok);
    }
  };

  for (int e = tid; e < kUsers * f4; e += kThreads) {
    const int r = e / f4;
    const int c = e - r * f4;
    const bool ok = user0 + r < B;
    cp_async16(s_users + r * f4s + c,
               users + (int64_t)(ok ? user0 + r : 0) * f4 + c, ok);
  }
  stage(0);
  cp_async_commit();

  TopList lists[kUsersPerWarp];
#pragma unroll
  for (int ul = 0; ul < kUsersPerWarp; ++ul) lists[ul].init();
  const int k_lane = (k - 1) & 31;
  const bool k_high = k - 1 >= 32;

  float acc[kFrag][kFrag];
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) stage(s + 1);
    cp_async_commit();             // an empty group at the last stage
    cp_async_wait_one();
    __syncthreads();               // stage s has landed for every thread

    const int t = s / n_panels;
    const int p = s - t * n_panels;
    const int base = lo + t * kTile;
    const bool last = p == n_panels - 1;
    if (p == 0) {
#pragma unroll
      for (int i = 0; i < kFrag; ++i)
#pragma unroll
        for (int j = 0; j < kFrag; ++j) acc[i][j] = 0.f;
    }
    const int c0 = p * kPanel;
    const int kw = min(kPanel, f4 - c0);
    const float4* su = s_users + c0;
    const float4* si = s_items + (s & 1) * kTile * kPanel;
    for (int c = 0; c < kw; ++c) {
      float4 b[kFrag];
#pragma unroll
      for (int j = 0; j < kFrag; ++j) b[j] = si[(ix + 32 * j) * kPanel + c];
#pragma unroll
      for (int i = 0; i < kFrag; ++i) {
        const float4 a = su[(uy + 8 * i) * f4s + c];
#pragma unroll
        for (int j = 0; j < kFrag; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
    if (last) {
#pragma unroll
      for (int i = 0; i < kFrag; ++i)
#pragma unroll
        for (int j = 0; j < kFrag; ++j)
          s_scores[(uy + 8 * i) * kScoreStride + ix + 32 * j] = acc[i][j];
    }
    // buffer s & 1 is free for stage s + 2, and the scores are written;
    // the next write of the scores follows the next stage's barrier,
    // which every warp reaches only after its selection below
    __syncthreads();
    if (!last) continue;
    // the mask bytes of this warp's users, all loads issued before the
    // first is used
    int mb[kUsersPerWarp][kFrag];
#pragma unroll
    for (int ul = 0; ul < kUsersPerWarp; ++ul) {
      const int u = user0 + warp * kUsersPerWarp + ul;
#pragma unroll
      for (int j = 0; j < kFrag; ++j) {
        const int id = base + lane + 32 * j;
        mb[ul][j] = (mask != nullptr && u < B && id < hi)
                        ? __ldg(mask + (int64_t)u * N + id) : 1;
      }
    }
#pragma unroll
    for (int ul = 0; ul < kUsersPerWarp; ++ul) {
      const int r = warp * kUsersPerWarp + ul;
      if (user0 + r >= B) continue;            // uniform across the warp
#pragma unroll
      for (int j = 0; j < kFrag; ++j) {
        const int id = base + lane + 32 * j;
        float sc = s_scores[r * kScoreStride + lane + 32 * j];
        if (mb[ul][j] == 0) sc = kMasked;
        lists[ul].offer(sc, id, id < hi, lane, k_lane, k_high);
      }
    }
  }

#pragma unroll
  for (int ul = 0; ul < kUsersPerWarp; ++ul) {
    const int u = user0 + warp * kUsersPerWarp + ul;
    if (u < B) {
      const int64_t row = ((int64_t)u * splits + split) * k;
      lists[ul].store(part_ids + row, part_vals + row, lane, k);
    }
  }
}

// One warp per user: the top-k of its splits x k partial entries.
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const int32_t* __restrict__ part_ids,
                  const float* __restrict__ part_vals,
                  int32_t* __restrict__ out_ids, float* __restrict__ out_vals,
                  int B, int k, int splits) {
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= B) return;                          // the whole warp
  TopList list;
  list.init();
  const int n = splits * k;
  const int32_t* pi = part_ids + (int64_t)u * n;
  const float* pv = part_vals + (int64_t)u * n;
  for (int e0 = 0; e0 < n; e0 += 32) {
    const int e = e0 + lane;
    const bool ok = e < n;
    list.offer(ok ? pv[e] : 0.f, ok ? pi[e] : kNoId, ok, lane, (k - 1) & 31,
               k - 1 >= 32);
  }
  list.store(out_ids + (int64_t)u * k, out_vals + (int64_t)u * k, lane, k);
}

size_t split_smem(int f) {
  return ((size_t)kUsers * ((f / 4) | 1) + 2 * kTile * kPanel) *
             sizeof(float4) +
         (size_t)kUsers * kScoreStride * sizeof(float);
}

}  // namespace

// How many CTAs of the split kernel an SM holds at width f (a multiple of
// 4), or a negative CUDA error; the wrapper sizes the grid by it.
extern "C" int mml_catalog_topk_ctas_per_sm(int f) {
  const size_t smem = split_smem(f);
  cudaError_t err = cudaFuncSetAttribute(
      topk_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, topk_split_kernel,
                                                      kThreads, smem);
  return err != cudaSuccess ? -(int)err : n;
}

// C interface (bound with ctypes). users [B, f], items [N, f] float32 with
// f a multiple of 4 (16-byte rows), mask [B, N] bytes (nonzero =
// candidate) or null, out_ids / out_vals [B, k]; part_ids / part_vals
// [B, splits, k] with splits = ceil(N / split_items), unread when splits
// is 1 (the split kernel then writes the output); split_items a multiple
// of 128; 1 <= k <= 64, k <= N, B >= 1, f <= 384 (checked by the wrapper,
// ops/catalog_topk.py). Launches on `stream`, does not synchronise, and
// returns the first CUDA error of the attribute call or the launches.
extern "C" int mml_catalog_topk(const float* users, const float* items,
                                const int8_t* mask, int32_t* part_ids,
                                float* part_vals, int32_t* out_ids,
                                float* out_vals, int B, int N, int f, int k,
                                int split_items, void* stream) {
  const int f4 = f / 4;
  const int splits = (N + split_items - 1) / split_items;
  const size_t smem = split_smem(f);
  cudaError_t err = cudaFuncSetAttribute(
      topk_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool direct = splits == 1;
  const dim3 grid((B + kUsers - 1) / kUsers, splits);
  topk_split_kernel<<<grid, kThreads, smem, st>>>(
      reinterpret_cast<const float4*>(users),
      reinterpret_cast<const float4*>(items), mask,
      direct ? out_ids : part_ids, direct ? out_vals : part_vals, B, N, f4,
      k, split_items);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  topk_merge_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      part_ids, part_vals, out_ids, out_vals, B, k, splits);
  return (int)cudaGetLastError();
}
