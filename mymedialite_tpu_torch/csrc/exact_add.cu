// The exact scatter-add of the plain epochs: table[ids[i]] += delta[i]
// with duplicate ids summing to the same bits in any order.
//
// Replaces no TPU kernel. The JAX package's XLA epochs scatter-add with
// `.at[ids].add` (mymedialite_tpu/ops/sgd.py:364-367, the blocked epoch),
// which sums each row's duplicates in one fixed order on its chip; the
// port's plain routes (the blocked and flat MF epochs, minibatch and
// sharded BPR, grouped and sharded SVD++, SocialMF, the time-aware
// baselines, BPRSLIM) call ops/sgd.py add_rows, which on the card is
// ops/sgd.py exact_add, whose plain version is a torch composition
// (torch.unique, an int64 index_add_, about ten launches). This kernel
// computes the same function bit for bit, in four launches:
// - init: an open-addressing table of the batch's distinct ids (2^m >= 2n
//   slots of int64 keys, all ones empty), the count of distinct ids and
//   max |delta|, zeroed;
// - insert: one thread a slot claims its id's entry (atomicCAS, linear
//   probing); the thread that claims it numbers the id (an atomic count)
//   and zeroes its int64 row of sums. Ids stay int64 from end to end (a
//   flat view of an [I, I] table passes 2^31 past 46,340 items); an id
//   outside [0, rows) traps, as index_add_'s device-side check does. The same kernel reduces max |delta|
//   over the batch: |x|'s bits order as unsigned integers, NaN above inf,
//   so an atomicMax on them is max(|delta|) with a NaN winning, as
//   torch.max;
// - accumulate: e = min(floor(61 - log2(max|delta| * n)), 100) in double,
//   as the composition computes it (the same libdevice log2 and exp2 that
//   torch's CUDA kernels call), each delta rounded to round(delta * 2^e)
//   in the table's type and converted to int64, and added into its id's
//   row by an integer atomicAdd: exact, so any order gives the same sums;
// - finish: each distinct id's sums converted to the table's type (round
//   to nearest), divided by 2^e, and added to the table row once; where
//   max |delta| is not finite every touched entry gets it added instead,
//   as the composition's torch.where does.
// float32 and float64 tables (the plain routes' float64 witnesses run on
// the card too). The work is a few passes over the batch (n ids, n x d deltas), so it is
// bound by bytes; at the sizes of the plain routes (thousands to a few
// hundred thousand slots) by launch latency and, on a batch heavy with
// duplicates, by the atomics on its hot rows' sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The table's type: its bits as an unsigned integer (|x| orders as one,
// NaN above inf), and the float operations of the composition, each
// rounded to nearest as torch's CUDA kernels round them.
template <class T> struct Traits;
template <> struct Traits<float> {
  using Bits = unsigned int;
  static constexpr Bits kAbs = 0x7fffffffu;
  __device__ static Bits abs_bits(float x) { return __float_as_uint(x) & kAbs; }
  __device__ static float from_bits(Bits b) { return __uint_as_float(b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float round(float a) { return rintf(a); }
  __device__ static float from_ll(long long a) { return __ll2float_rn(a); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};
template <> struct Traits<double> {
  using Bits = unsigned long long;
  static constexpr Bits kAbs = 0x7fffffffffffffffull;
  __device__ static Bits abs_bits(double x) {
    return (Bits)__double_as_longlong(x) & kAbs;
  }
  __device__ static double from_bits(Bits b) {
    return __longlong_as_double((long long)b);
  }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double round(double a) { return rint(a); }
  __device__ static double from_ll(long long a) { return __ll2double_rn(a); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
};

constexpr unsigned long long kEmpty = ~0ull;  // no id (ids are >= 0)

// meta[0]: distinct ids; meta[1]: bits of max |delta|
__global__ void exact_add_init(unsigned long long* __restrict__ keys,
                               unsigned long long* __restrict__ meta,
                               int cap) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t < cap) keys[t] = kEmpty;
  if (t < 2) meta[t] = 0;
}

__device__ __forceinline__ uint32_t hash_id(unsigned long long id) {
  return (uint32_t)((id * 0x9e3779b97f4a7c15ull) >> 32);
}

template <class T, class Id>
__global__ void exact_add_insert(const Id* __restrict__ ids,
                                 const T* __restrict__ delta,
                                 unsigned long long* __restrict__ keys,
                                 int32_t* __restrict__ dense_of,
                                 int32_t* __restrict__ slot_of,
                                 int64_t* __restrict__ rows,
                                 long long* __restrict__ sums,
                                 unsigned long long* __restrict__ meta,
                                 int n, int d, int cap, int64_t num_rows) {
  using Tr = Traits<T>;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  typename Tr::Bits top = 0;
  for (int64_t x = t; x < (int64_t)n * d; x += stride)
    top = max(top, Tr::abs_bits(delta[x]));
  for (int o = 16; o > 0; o >>= 1)
    top = max(top, __shfl_xor_sync(0xffffffffu, top, o));
  if ((threadIdx.x & 31) == 0)
    atomicMax(&meta[1], (unsigned long long)top);
  if (t >= n) return;
  const unsigned long long id = (unsigned long long)(int64_t)ids[t];
  if (id >= (unsigned long long)num_rows) __trap();
  const uint32_t mask = (uint32_t)cap - 1;
  uint32_t h = hash_id(id) & mask;
  while (true) {
    const unsigned long long prev = atomicCAS(&keys[h], kEmpty, id);
    if (prev == kEmpty) {
      const int r = (int)atomicAdd(&meta[0], 1ull);
      rows[r] = (int64_t)id;
      dense_of[h] = r;
      for (int c = 0; c < d; ++c) sums[(int64_t)r * d + c] = 0;
      break;
    }
    if (prev == id) break;
    h = (h + 1) & mask;
  }
  slot_of[t] = (int32_t)h;
}

// 2^e of the batch in the table's type, and whether max |delta| is finite
template <class T>
__device__ __forceinline__ T batch_scale(unsigned long long top_bits, int n,
                                         bool* finite) {
  const T top = Traits<T>::from_bits((typename Traits<T>::Bits)top_bits);
  *finite = isfinite(top);
  double e = floor(61.0 - log2((double)top * (double)n));
  if (e > 100.0) e = 100.0;  // NaN stays NaN, as torch.clamp
  return (T)exp2(e);
}

template <class T>
__global__ void exact_add_accumulate(const T* __restrict__ delta,
                                     const int32_t* __restrict__ dense_of,
                                     const int32_t* __restrict__ slot_of,
                                     unsigned long long* __restrict__ sums,
                                     const unsigned long long* __restrict__ meta,
                                     int n, int d) {
  using Tr = Traits<T>;
  bool finite;
  const T scale = batch_scale<T>(meta[1], n, &finite);
  if (!finite) return;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t x = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       x < (int64_t)n * d; x += stride) {
    const int64_t i = x / d;
    const int c = (int)(x - i * d);
    const long long fixed = (long long)Tr::round(Tr::mul(delta[x], scale));
    atomicAdd(&sums[(int64_t)dense_of[slot_of[i]] * d + c],
              (unsigned long long)fixed);
  }
}

template <class T>
__global__ void exact_add_finish(T* __restrict__ table,
                                 const int64_t* __restrict__ rows,
                                 const long long* __restrict__ sums,
                                 const unsigned long long* __restrict__ meta,
                                 int n, int d) {
  using Tr = Traits<T>;
  bool finite;
  const T scale = batch_scale<T>(meta[1], n, &finite);
  const T top = Tr::from_bits((typename Tr::Bits)meta[1]);
  const int64_t count = (int64_t)meta[0] * d;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t x = (int64_t)blockIdx.x * kThreads + threadIdx.x; x < count;
       x += stride) {
    const int64_t r = x / d;
    const int c = (int)(x - r * d);
    const T back = finite ? Tr::div(Tr::from_ll(sums[x]), scale) : top;
    T* p = table + rows[r] * d + c;
    *p = Tr::add(*p, back);
  }
}

template <class T>
int launch(T* table, const void* ids, const T* delta, void* work,
           int64_t num_rows, int n, int d, int cap, int ids64,
           cudaStream_t st) {
  unsigned long long* meta = static_cast<unsigned long long*>(work);
  long long* sums = reinterpret_cast<long long*>(meta + 2);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(sums + (int64_t)n * d);
  int64_t* rows = reinterpret_cast<int64_t*>(keys + cap);
  int32_t* dense_of = reinterpret_cast<int32_t*>(rows + n);
  int32_t* slot_of = dense_of + cap;
  const int64_t elems = (int64_t)n * d;
  const int64_t blocks = (elems + kThreads - 1) / kThreads;
  const int grid_all = (int)(blocks < 16384 ? blocks : 16384);
  const int grid_ids = (n + kThreads - 1) / kThreads;
  const int grid_ins = grid_ids > grid_all ? grid_ids : grid_all;
  exact_add_init<<<(cap + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      keys, meta, cap);
  if (ids64)
    exact_add_insert<T, int64_t><<<grid_ins, kThreads, 0, st>>>(
        static_cast<const int64_t*>(ids), delta, keys, dense_of, slot_of,
        rows, sums, meta, n, d, cap, num_rows);
  else
    exact_add_insert<T, int32_t><<<grid_ins, kThreads, 0, st>>>(
        static_cast<const int32_t*>(ids), delta, keys, dense_of, slot_of,
        rows, sums, meta, n, d, cap, num_rows);
  exact_add_accumulate<T><<<grid_all, kThreads, 0, st>>>(
      delta, dense_of, slot_of, reinterpret_cast<unsigned long long*>(sums),
      meta, n, d);
  exact_add_finish<T><<<grid_all, kThreads, 0, st>>>(table, rows, sums, meta,
                                                    n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns the first CUDA error of the launches. table
// [num_rows, d] and delta [n, d] float32 (f64 = 0) or float64 (f64 = 1),
// ids [n] int32 (ids64 = 0) or int64 (ids64 = 1) in [0, num_rows), all
// contiguous; `work` holds 2 uint64 (meta), n d int64 sums, cap int64
// keys and n int64 rows, then cap + n int32 (dense_of, slot_of); cap a
// power of two >= 2n (ops/sgd.py sizes it).
extern "C" int mml_exact_add(void* table, const void* ids, const void* delta,
                             void* work, int64_t num_rows, int n, int d,
                             int cap, int ids64, int f64, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    return launch(static_cast<double*>(table), ids,
                  static_cast<const double*>(delta), work, num_rows, n, d,
                  cap, ids64, st);
  return launch(static_cast<float*>(table), ids,
                static_cast<const float*>(delta), work, num_rows, n, d, cap,
                ids64, st);
}
