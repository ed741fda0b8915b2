// The slot-ordered owner scatter of the epoch kernels (sgd_epoch.cu,
// bpr_epoch.cu, svdpp_epoch.cu): a chunk's duplicate rows summed in one
// fixed order, with no atomics, so that two runs of one seed give the same
// tables bit for bit.
//
// Each chunk carries a segment table (ops/segments.py builds it once per
// plan; the BPR sampler builds it per epoch, csrc/bpr_epoch.cu): the runs
// of two or more entries of the chunk's list, and a code per slot and
// kind of entry. The list, the chunk's live entries sorted by (table,
// row, entry id), is not stored: the table is built from it.
// - A list entry is a uint16: the entry id in bits 0-13 (a slot, or for
//   the BPR item table C + slot for the sampled j), the table (0: the
//   user side, 1: the item side) in bit 14, and in bit 15 whether a run
//   of one row starts there.
// - An entry in a run of two or more has a compact index, its rank among
//   those entries in list order, so a run's entries have consecutive
//   ones. The runs block holds the counts of such runs and entries of
//   table 0 and 1, then each run's first list entry, first compact index
//   and length.
// - A code is a uint16 per slot and kind t (BPR: 0 for W, 1 for i, 2 for
//   j): kDead for a slot alone in its run, else its compact index, with
//   kStart where it starts its run.
// A row's value after the chunk is ((row + d_1) + d_2) + ... over its
// run's deltas in entry order: the order in which index_add_ on the CPU
// adds a chunk (slot order; the BPR item table's i entries before its j
// entries), which the plain versions of the kernels run.
//
// The work is split so that no L2 round trip waits on another:
// - phase 1 (the kernel's own gather and gradient) writes, for an entry
//   whose row is in no other entry of the chunk, row + d straight into
//   the table (no other slot of the chunk reads that row); for the first
//   entry of a longer run it writes row + d, for the others d, at its
//   compact index in a stage of shared memory, from the row it has just
//   gathered (in a global scratch where the chunk's values do not fit);
// - phase 2 (owner_chain below), after a barrier: each float4 of each run
//   is one thread's sum, in list order from shared memory, four loads
//   ahead of the adds, stored once (st.global.cg). From the scratch the
//   block first copies windows of whole runs into the stage (cp.async).
// A shared-memory load has a latency of tens of cycles, so a run of a
// popular item (over a hundred entries in a Netflix-shaped chunk of 640)
// or of a heavy user costs its adds, not a chain of L2 round trips, and
// the block's threads share the sums evenly: a run's owner waits on no
// other run, where a walk of the list by one group of lanes per run
// serialised its positions' shared-memory reads and the two groups of a
// warp, and a copy of every chunk's values through L2 put a round trip
// and a pass over the list in each step.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mml_owner {

constexpr uint16_t kDead = 0xFFFF;
constexpr uint16_t kStart = 0x8000;
constexpr uint16_t kIdMask = 0x3FFF;

__device__ __forceinline__ int side_of(uint16_t e) { return (e >> 14) & 1; }

__device__ __forceinline__ float4 f4_add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Where a chunk's values for phase 2 live: the values of the entries in
// runs of two or more, by compact index (a run's entries in a row), table
// 0's first at w0 float4s an entry, then table 1's at w1 (only the tables
// of this step's `sides`). In shared memory (`smem`) where they fit the
// stage, else in the global scratch, whence phase 2 copies them.
struct Stage {
  float4* base;
  int w0, w1;            // float4 pieces an entry of table 0, table 1
  int n0;                // entries of table 0 in runs
  int off1;              // the first float4 of table 1's entries
  bool smem;
  __device__ int off(int idx) const {
    return idx < n0 ? idx * w0 : off1 + (idx - n0) * w1;
  }
};

// The step's stage from its runs block (runs[0..3]: runs of table 0 and 1
// of two or more entries, their entries): in shared memory `stage_smem`
// (stage_f4 float4s) where they fit, else in `scratch`.
__device__ __forceinline__ Stage make_stage(const uint16_t* runs,
                                            unsigned sides, int w0, int w1,
                                            float4* stage_smem, int stage_f4,
                                            float4* scratch) {
  Stage st;
  st.w0 = w0;
  st.w1 = w1;
  st.n0 = runs[2];
  st.off1 = (sides & 1) ? st.n0 * w0 : 0;
  st.smem = st.off1 + ((sides & 2) ? (int)runs[3] * w1 : 0) <= stage_f4;
  st.base = st.smem ? stage_smem : scratch;
  return st;
}

// What phase 1 does with one entry's piece li (row + d for the first
// entry of a run, else d), by its code: the row itself for an entry alone
// in its run (no other slot of the chunk reads that row), else the stage.
__device__ __forceinline__ void put(uint16_t code, const Stage& st, int li,
                                    float4* row, float4 row_val, float4 d) {
  if (code == kDead) {
    __stcg(row, f4_add(row_val, d));
    return;
  }
  if (code & kStart) d = f4_add(row_val, d);
  st.base[st.off(code & 0x7fff) + li] = d;
}

// Phase 2 over a step's runs block `runs` (see make_stage; then each
// run's first list entry, first compact index and length), called by
// every thread of the block with the same arguments (it holds barriers).
// An entry of table t has pc.count(t) float4 pieces (st.w0, st.w1);
// pc.dst(t, id, li) is piece li's place in the table. Each (run, piece)
// pair is one thread's sum: the run's first value (row + d), plus the
// others in list order, four loads ahead of the adds, stored once
// (st.global.cg). Values in the global scratch come into `stage_smem` by
// windows of whole runs, copied by the block with cp.async; a run longer
// than the stage goes alone, in parts, its pieces' sums carried in the
// registers of threads 0..count-1.
template <class Pieces>
__device__ void owner_chain(const uint16_t* __restrict__ runs,
                            unsigned sides, const Stage& st,
                            float4* __restrict__ stage_smem, int stage_f4,
                            const Pieces& pc) {
  __syncthreads();    // phase 1 is done
  const int nr0 = runs[0];
  const uint16_t* run = runs + 4;             // (entry, compact, length)
  const int k_lo = (sides & 1) ? 0 : nr0;
  const int k_hi = (sides & 2) ? nr0 + (int)runs[1] : nr0;
  auto width = [&](int k) { return k < nr0 ? st.w0 : st.w1; };
  auto first = [&](int k) { return st.off(run[3 * k + 1]); };
  auto len = [&](int k) { return (int)run[3 * k + 2]; };
  // acc += the values of piece li at `at`, `at + w`, ... (n of them)
  auto add = [&](float4 acc, const float4* at, int n, int w) {
    int q = 0;
    for (; q + 4 <= n; q += 4, at += 4 * w) {
      const float4 x0 = at[0], x1 = at[w], x2 = at[2 * w], x3 = at[3 * w];
      acc = f4_add(f4_add(f4_add(f4_add(acc, x0), x1), x2), x3);
    }
    for (; q < n; ++q, at += w) acc = f4_add(acc, at[0]);
    return acc;
  };
  // the sums of runs [k0, k1), their values at base[off - from]
  auto sums = [&](int k0, int k1, const float4* base, int from) {
    const int n0 = max(0, min(k1, nr0) - k0);
    const int items = n0 * st.w0 + (k1 - k0 - n0) * st.w1;
    for (int x = threadIdx.x; x < items; x += blockDim.x) {
      int k, li;
      if (x < n0 * st.w0) {
        k = k0 + x / st.w0;
        li = x - (k - k0) * st.w0;
      } else {
        const int y = x - n0 * st.w0;
        k = k0 + n0 + y / st.w1;
        li = y - (k - k0 - n0) * st.w1;
      }
      const uint16_t e = run[3 * k];
      const int t = side_of(e), w = width(k);
      const float4* at = base + first(k) - from + li;
      __stcg(pc.dst(t, e & kIdMask, li), add(at[0], at + w, len(k) - 1, w));
    }
  };
  if (st.smem) {
    sums(k_lo, k_hi, stage_smem, 0);
    return;
  }
  // copy float4s [a, b) of the scratch into the stage
  auto copy = [&](int a, int b) {
    for (int x = threadIdx.x; x < b - a; x += blockDim.x)
      cp_async16(stage_smem + x, st.base + a + x);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  };
  bool used = false;                          // the stage holds a window
  for (int k0 = k_lo; k0 < k_hi;) {
    if (used) __syncthreads();                // its readers are done
    used = true;
    const int a = first(k0), w = width(k0);
    if (len(k0) * w > stage_f4) {
      // a run past the stage, in parts of whole entries
      const uint16_t e = run[3 * k0];
      const int li = threadIdx.x, part = stage_f4 / w;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c0 = 0; c0 < len(k0); c0 += part) {
        if (c0 > 0) __syncthreads();
        const int n = min(len(k0) - c0, part);
        copy(a + c0 * w, a + (c0 + n) * w);
        if (li < w)
          acc = c0 == 0 ? add(stage_smem[li], stage_smem + w + li, n - 1, w)
                        : add(acc, stage_smem + li, n, w);
      }
      if (li < w) __stcg(pc.dst(side_of(e), e & kIdMask, li), acc);
      ++k0;
      continue;
    }
    // the window: runs k0..k1-1, k1 the first run that ends past the stage
    int lo = k0 + 1, hi = k_hi;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (first(mid) + len(mid) * width(mid) - a <= stage_f4) lo = mid + 1;
      else hi = mid;
    }
    copy(a, first(lo - 1) + len(lo - 1) * width(lo - 1));
    sums(k0, lo, stage_smem, a);
    k0 = lo;
  }
}

}  // namespace mml_owner
