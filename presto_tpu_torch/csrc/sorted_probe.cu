// sorted_probe: lower-bound position of each int64 probe in a sorted int64
// key column, searching [0, n_valid).
//
// Replaces the Pallas TPU kernel
// presto_tpu/ops/pallas_kernels.py:sorted_probe (body _bsearch_kernel).  The
// TPU version pins the sorted table in VMEM, compares keys as (signed hi,
// unsigned lo) int32 word pairs because its vector unit is 32-bit, and
// bisects every probe over the whole table.  Hopper compares int64
// directly, and its 50 MB L2 holds a join build side of the sizes this
// engine probes (1.5 M keys = 12 MB).
//
// Bound on an H100: bytes.  Each probe is read once (8 bytes) and its
// position written once (4 bytes), each valid key read at most once (8
// bytes): 12 bytes a probe plus 8 a key over 3.35 TB/s, 0.75 us for Q14's
// 75,143 probes into 200,000 keys and 25.1 us for SF1's 6,002,590 lineitem
// keys into 1,500,000 order keys.  Below those sits a floor no search
// removes: a launch that only reads the probes and writes positions takes
// a few microseconds at Q14's size (tools/sorted_probe_sweep.py, "floor").
//
// What held the first design back (one thread per probe bisecting global
// memory): every search made all log2(n) dependent reads, 18 at Q14's
// table and 21 at orders'.  The top levels come from L1, the rest each cost
// a 32-byte L2 sector, so with probes in random order the L2's sector rate
// bounds the kernel; with probes in key order (lineitem's l_orderkey) the
// dependent rounds of each wave of threads do.
//
// This design reads fewer keys per probe:
// - Each block reads n_valid (a device scalar, or a value the host passes)
//   and stages S <= 256 keys, evenly spaced over [0, n_valid), in shared
//   memory (the whole valid table when n_valid <= S).  A search takes the
//   lower bound b in that sample (log2 S rounds in shared memory); the
//   answer then lies in the bucket (pos[b-1], pos[b]], n_valid standing for
//   pos[S].  That is exact under runs of equal keys that cross sample
//   positions: every key at or before pos[b-1] is below the probe and the
//   key at pos[b] is not.
// - The bucket is searched in global memory by interpolation: each round
//   reads the key where the probe would lie if the keys rose evenly between
//   the nearest keys known below it and at or above it (two sampled keys at
//   first).  Join keys are mostly dense or evenly spread (TPC-H's part and
//   order keys), where a guess lands at or next to the answer and a few
//   reads settle a probe that bisection needs 12 or 13 for (buckets of
//   3,125 keys at Q14's shape, 5,860 at the lineitem shape).  After any read
//   that does not halve the range the next round bisects, so skewed keys
//   cost at most about twice bisection's rounds.  The guess is computed in
//   float from exact unsigned 64-bit differences, so no key range
//   overflows it; it only picks which key to read, so the result stays
//   exact.  Nothing at or beyond n_valid is ever read.
// - With interpolation a small sample suffices: a block stages each sample
//   key from L2, so larger samples cost more than they save (measured with
//   the script above, PERF.md).  The host's plan (ops/cuda_kernels.py,
//   sorted_probe_plan) runs one persistent 1024-thread block per SM for
//   many probes and 128-thread blocks, one search a thread, for fewer, so
//   that every SM searches; the sample holds half a block's probes, at most
//   256 keys.
// - Probes are read and positions written coalesced and with streaming
//   hints, so the probe stream does not evict the keys from L2; each
//   thread reads its next probe while it searches the current one.
//
// nvcc -Xptxas -v (sm_90a), as chip_smoke.py's "build" phase prints it:
// 32 registers, no spills, 2048 bytes of static shared memory (the largest
// sample).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSampleLog2 = 8;  // 256 keys, 2 KB of shared memory

// Position of sample key j: the last key of the j-th of S equal slices of
// [0, n), or key j itself when the valid keys fit in the sample.
__device__ __forceinline__ int sample_pos(int j, int n, bool whole,
                                          int sample_log2) {
  return whole ? j
               : (int)((((long long)(j + 1) * n) >> sample_log2) - 1);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
sorted_probe_kernel(const long long* __restrict__ keys, long long cap,
                    const long long* __restrict__ n_valid_ptr,
                    long long n_valid_value,
                    const long long* __restrict__ probes, long long p,
                    int* __restrict__ out, int sample_log2) {
  __shared__ long long sample[1 << kMaxSampleLog2];
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the first probe is read while the sample is staged, and each next one
  // while the one before it is searched
  long long next = i < p ? __ldcs(probes + i) : 0;
  const long long nv = n_valid_ptr ? *n_valid_ptr : n_valid_value;
  const int n = (int)(nv < 0 ? 0 : (nv > cap ? cap : nv));
  const bool whole = n <= (1 << sample_log2);
  const int m = whole ? n : 1 << sample_log2;
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    sample[j] = __ldg(keys + sample_pos(j, n, whole, sample_log2));
  __syncthreads();

  for (; i < p; i += stride) {
    const long long x = next;
    if (i + stride < p) next = __ldcs(probes + i + stride);
    // lower bound b in the shared-memory sample (branch-free, the same
    // number of rounds for every search)
    int b = 0;
    if (m > 0) {
      for (int len = m; len > 1;) {
        const int half = len >> 1;
        b = sample[b + half] < x ? b + half : b;
        len -= half;
      }
      b += sample[b] < x;
    }
    // the answer lies in (pos[b-1], pos[b]]: a search of that bucket in
    // global memory
    int lo = b == 0 ? 0 : sample_pos(b - 1, n, whole, sample_log2) + 1;
    int hi = b == m ? n : sample_pos(b, n, whole, sample_log2);
    // keys known to lie below x (klo, at lo - 1) and at or above it (khi,
    // at hi): each round reads where x would lie if the keys rose evenly
    // between them, but bisects after a read that did not halve the range
    long long klo = b > 0 ? sample[b - 1] : 0;
    long long khi = b < m ? sample[b] : 0;
    const bool bounded = b > 0 && b < m;
    bool interp = bounded;
    while (lo < hi) {
      const int len = hi - lo;
      int g = lo + (len >> 1);
      if (interp) {
        const float f = __fdividef(
            (float)((unsigned long long)x - (unsigned long long)klo),
            (float)((unsigned long long)khi - (unsigned long long)klo));
        g = lo + (int)fminf(f * (float)len, (float)(len - 1));
      }
      const long long v = __ldg(keys + g);
      if (v < x) {
        lo = g + 1;
        klo = v;
      } else {
        hi = g;
        khi = v;
      }
      interp = bounded && hi - lo <= len >> 1;
    }
    __stcs(out + i, lo);
  }
}

}  // namespace

// One argument array, so that the ctypes call converts a single pointer:
// args = {keys, cap, n_valid_ptr, n_valid_value, probes, p, out, blocks,
// threads, sample_log2, stream}.  keys: int64[cap] sorted over
// [0, n_valid), cap < 2^31; n_valid: the int64 at n_valid_ptr on the
// device, or n_valid_value when n_valid_ptr is 0; probes: int64[p]; out:
// int32[p]; blocks x threads (<= 1024) with 2^sample_log2 (<= 2^8) sampled
// keys, as the host's plan gives them.  Launches on `stream`; returns the
// launch status.
extern "C" cudaError_t sorted_probe_launch(const long long* args) {
  const int blocks = (int)args[7], threads = (int)args[8];
  const int sample_log2 = (int)args[9];
  if (blocks < 1 || threads < 1 || threads > kMaxThreads ||
      sample_log2 < 0 || sample_log2 > kMaxSampleLog2)
    return cudaErrorInvalidValue;
  sorted_probe_kernel<<<blocks, threads, 0, (cudaStream_t)args[10]>>>(
      (const long long*)args[0], args[1], (const long long*)args[2],
      args[3], (const long long*)args[4], args[5], (int*)args[6],
      sample_log2);
  return cudaGetLastError();
}
