// seg_reduce: per-slot sum, count, minimum or maximum of int64 values,
// rows into `capacity` slots, skipping rows that are masked out or whose
// slot lies outside [0, capacity).
//
// Replaces the colliding index_add_ / scatter_reduce_ of the aggregation
// layer's integer segment reductions (ops/agg.py: seg_sum, seg_count,
// seg_min, seg_max).  The JAX package has no TPU kernel for these: its
// segment sums are XLA scatters (presto_tpu/ops/agg.py).  A library
// scatter sends one atomic per row to global memory; with few slots those
// collide, and the L2 serialises them: TPC-H Q1 groups 6 M (SF1) or 60 M
// (SF10) rows into 4 of 64 slots, where index_add_ took about 35 ms a call
// at SF10, about 150 times the time its bytes need.
//
// Bound on an H100: bytes.  A sum reads an int64 value, an int32 slot and
// a one-byte mask a row (13 bytes), a count the slot and the mask (5
// bytes): 0.233 ms and 0.090 ms for SF10's 60 M rows at 3.35 TB/s.
//
// Design for that bound:
// - A persistent grid (ops/cuda_kernels.py, seg_reduce_plan) walks the
//   rows a warp step at a time: each lane takes 4 consecutive rows with
//   16-byte loads (the mask in one 4-byte load) where every pointer is
//   aligned, with streaming hints, and loads its next step before it
//   reduces the current one.
// - Lanes that hit the same slot are combined first: __match_any_sync on
//   the slot gives each lane its peers, a shuffle tree reduces their values
//   to the lowest peer (a count needs only the peers' population count),
//   and that leader alone updates the slot.  Rows that are skipped form a
//   group of their own that updates nothing.
// - Privatised branch (few slots against many rows): each warp of a
//   block keeps its own copy of the slots in shared memory, which a leader
//   updates with a plain store, since leaders hold distinct slots.  At the
//   end the block merges its warps' copies and sends each slot it changed
//   to global memory with one atomic.  The global atomics are then at most
//   blocks x slots, not rows.
// - Global branch (many slots): the leaders' atomics go straight to global
//   memory, where collisions are rare.
// Integer addition mod 2^64, min and max are associative and commutative,
// so the result does not depend on the order of the atomics: it is
// bit-identical to the library scatter's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 4;            // rows a lane takes in one warp step
constexpr int kMaxThreads = 256;

enum Op { kAdd = 0, kMin = 1, kMax = 2 };

template <int OP>
struct Reduce;

template <>
struct Reduce<kAdd> {
  static __device__ __forceinline__ long long identity() { return 0; }
  static __device__ __forceinline__ long long apply(long long a,
                                                    long long b) {
    return (long long)((unsigned long long)a + (unsigned long long)b);
  }
  static __device__ __forceinline__ void atomic(long long* p, long long v) {
    atomicAdd((unsigned long long*)p, (unsigned long long)v);
  }
};

template <>
struct Reduce<kMin> {
  static __device__ __forceinline__ long long identity() {
    return 0x7fffffffffffffffLL;
  }
  static __device__ __forceinline__ long long apply(long long a,
                                                    long long b) {
    return a < b ? a : b;
  }
  static __device__ __forceinline__ void atomic(long long* p, long long v) {
    atomicMin(p, v);
  }
};

template <>
struct Reduce<kMax> {
  static __device__ __forceinline__ long long identity() {
    return -0x7fffffffffffffffLL - 1;
  }
  static __device__ __forceinline__ long long apply(long long a,
                                                    long long b) {
    return a > b ? a : b;
  }
  static __device__ __forceinline__ void atomic(long long* p, long long v) {
    atomicMax(p, v);
  }
};

// The 4 rows of a lane: each row's value and its slot, or -1 for a row
// that is skipped (masked out, outside [0, capacity), or past n).
struct Rows {
  long long v[kRows];
  int s[kRows];
};

template <bool VALUES, typename SlotT>
__device__ __forceinline__ Rows load_rows(const long long* __restrict__ values,
                                          const SlotT* __restrict__ slot,
                                          const unsigned char* __restrict__ mask,
                                          long long row0, long long n,
                                          long long capacity, bool vec) {
  Rows r;
  long long sl[kRows];
  unsigned char m[kRows];
  if (vec && row0 + kRows <= n) {
    if constexpr (sizeof(SlotT) == 4) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(slot + row0));
      sl[0] = q.x; sl[1] = q.y; sl[2] = q.z; sl[3] = q.w;
    } else {
      const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(slot + row0));
      const longlong2 b =
          __ldcs(reinterpret_cast<const longlong2*>(slot + row0 + 2));
      sl[0] = a.x; sl[1] = a.y; sl[2] = b.x; sl[3] = b.y;
    }
    const uchar4 mm = __ldcs(reinterpret_cast<const uchar4*>(mask + row0));
    m[0] = mm.x; m[1] = mm.y; m[2] = mm.z; m[3] = mm.w;
    if constexpr (VALUES) {
      const longlong2 a =
          __ldcs(reinterpret_cast<const longlong2*>(values + row0));
      const longlong2 b =
          __ldcs(reinterpret_cast<const longlong2*>(values + row0 + 2));
      r.v[0] = a.x; r.v[1] = a.y; r.v[2] = b.x; r.v[3] = b.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long long i = row0 + k;
      const bool in = i < n;
      sl[k] = in ? (long long)__ldcs(slot + i) : -1;
      m[k] = in ? __ldcs(mask + i) : 0;
      if constexpr (VALUES) r.v[k] = in ? __ldcs(values + i) : 0;
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if constexpr (!VALUES) r.v[k] = 1;
    r.s[k] = m[k] && (unsigned long long)sl[k] < (unsigned long long)capacity
                 ? (int)sl[k] : -1;
  }
  return r;
}

// Reduces x over the lanes of `peers` (the lanes holding this lane's slot)
// into the lowest of them: a pairwise tree over the peers' ranks, each
// round a shuffle from the next peer still in the tree.
template <int OP>
__device__ __forceinline__ long long reduce_peers(unsigned peers, long long x,
                                                  int lane) {
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xfffffffeu << lane);  // the peers above this lane
  while (__any_sync(kFull, rest)) {
    const int next = __ffs(rest);
    const long long t = __shfl_sync(kFull, x, (next - 1) & 31);
    if (next) x = Reduce<OP>::apply(x, t);
    // a lane at an odd rank has given its value to the lane below it
    rest &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
  return x;
}

template <int OP, bool VALUES, typename SlotT, bool PRIVATE>
__global__ void __launch_bounds__(kMaxThreads)
seg_reduce_kernel(const long long* __restrict__ values,
                  const SlotT* __restrict__ slot,
                  const unsigned char* __restrict__ mask, long long n,
                  long long capacity, bool vec,
                  long long* __restrict__ out) {
  using R = Reduce<OP>;
  extern __shared__ long long priv[];  // warps x capacity, PRIVATE only
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  long long* const acc = priv + (long long)warp * capacity;  // PRIVATE
  if constexpr (PRIVATE) {
    for (long long i = threadIdx.x; i < warps * capacity; i += blockDim.x)
      priv[i] = R::identity();
    __syncthreads();
  }
  constexpr long long kStep = 32LL * kRows;  // rows of a warp step
  const long long steps = (n + kStep - 1) / kStep;
  const long long stride = (long long)gridDim.x * warps;
  long long st = (long long)blockIdx.x * warps + warp;
  Rows cur;
  if (st < steps)
    cur = load_rows<VALUES>(values, slot, mask, st * kStep + lane * kRows, n,
                            capacity, vec);
  for (; st < steps; st += stride) {
    Rows nxt;
    if (st + stride < steps)
      nxt = load_rows<VALUES>(values, slot, mask,
                              (st + stride) * kStep + lane * kRows, n,
                              capacity, vec);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int s = cur.s[k];
      if (!__ballot_sync(kFull, s >= 0)) continue;
      const unsigned peers = __match_any_sync(kFull, s);
      const long long x = VALUES ? reduce_peers<OP>(peers, cur.v[k], lane)
                                 : (long long)__popc(peers);
      if (s >= 0 && (peers & ((1u << lane) - 1u)) == 0) {  // the leader
        if constexpr (PRIVATE)
          acc[s] = R::apply(acc[s], x);
        else
          R::atomic(out + s, x);
      }
      if constexpr (PRIVATE) __syncwarp();
    }
    cur = nxt;
  }
  if constexpr (PRIVATE) {
    __syncthreads();
    for (long long i = threadIdx.x; i < capacity; i += blockDim.x) {
      long long x = priv[i];
      for (int w = 1; w < warps; ++w)
        x = R::apply(x, priv[(long long)w * capacity + i]);
      if (x != R::identity()) R::atomic(out + i, x);
    }
  }
}

template <int OP, bool VALUES, typename SlotT>
const void* pick(bool priv) {
  return priv ? (const void*)&seg_reduce_kernel<OP, VALUES, SlotT, true>
              : (const void*)&seg_reduce_kernel<OP, VALUES, SlotT, false>;
}

template <int OP, bool VALUES>
const void* pick(int slot_bytes, bool priv) {
  return slot_bytes == 4 ? pick<OP, VALUES, int>(priv)
                         : pick<OP, VALUES, long long>(priv);
}

}  // namespace

// One array of 12 int64 arguments (ctypes converts one pointer):
//  [0] values: int64[n] device pointer, 0 for a count (op must be add)
//  [1] slot: int32 or int64 [n]   [2] slot element bytes, 4 or 8
//  [3] mask: bool[n]   [4] n   [5] capacity (< 2^31)
//  [6] op: 0 add, 1 min, 2 max   [7] out: int64[capacity], filled by the
//      caller with the op's identity
//  [8] blocks  [9] threads (a multiple of 32, <= 256)
//  [10] privatised (0/1): threads / 32 copies of the slots a block
//  [11] stream
// Launches on the stream; returns the launch status.
extern "C" cudaError_t seg_reduce_launch(const long long* a) {
  const void* values = (const void*)a[0];
  const void* slot = (const void*)a[1];
  const int slot_bytes = (int)a[2];
  const unsigned char* mask = (const unsigned char*)a[3];
  const long long n = a[4], capacity = a[5];
  const int op = (int)a[6];
  long long* out = (long long*)a[7];
  const int blocks = (int)a[8], threads = (int)a[9];
  const bool priv = a[10] != 0;
  if ((slot_bytes != 4 && slot_bytes != 8) || op < 0 || op > 2 ||
      (values == nullptr && op != kAdd) || threads <= 0 ||
      threads > kMaxThreads || threads % 32 || blocks <= 0)
    return cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)values % 16 == 0) &&
                   ((uintptr_t)slot % 16 == 0) && ((uintptr_t)mask % 4 == 0);
  const void* k;
  if (values == nullptr)
    k = pick<kAdd, false>(slot_bytes, priv);
  else if (op == kAdd)
    k = pick<kAdd, true>(slot_bytes, priv);
  else if (op == kMin)
    k = pick<kMin, true>(slot_bytes, priv);
  else
    k = pick<kMax, true>(slot_bytes, priv);
  const size_t smem =
      priv ? (size_t)(threads / 32) * capacity * sizeof(long long) : 0;
  long long nn = n, cap = capacity;
  bool v = vec;
  void* args[] = {&values, &slot, &mask, &nn, &cap, &v, &out};
  return cudaLaunchKernel(k, dim3(blocks), dim3(threads), args, smem,
                          (cudaStream_t)a[11]);
}
