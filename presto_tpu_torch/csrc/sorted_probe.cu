// sorted_probe: lower-bound position of each int64 probe in a sorted int64
// key column, searching [0, n_valid).
//
// Replaces the Pallas TPU kernel
// presto_tpu/ops/pallas_kernels.py:sorted_probe (body _bsearch_kernel).  The
// TPU version pins the sorted table in VMEM and compares keys as
// (signed hi, unsigned lo) int32 word pairs, because its vector unit is
// 32-bit.  Hopper compares int64 directly, and its 50 MB L2 holds a join
// build side of the sizes this engine probes (200 k keys = 1.6 MB).
//
// Bound on an H100: bytes.  Each probe is read once (8 bytes) and its
// position written once (4 bytes): 12 bytes a probe over 3.35 TB/s.  The
// log2(n) dependent table reads per probe come from L2 and are latency,
// not device-memory traffic.  Design: one thread per probe, so a warp runs
// 32 independent searches and the card keeps enough of them in flight to
// hide the L2 latency of each step; n_valid is read from a device scalar so
// the caller never waits on the device to learn the table size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sorted_probe_kernel(const long long* __restrict__ keys, long long cap,
                    const long long* __restrict__ n_valid,
                    const long long* __restrict__ probes, long long p,
                    int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  long long hi = *n_valid;
  hi = hi < 0 ? 0 : (hi > cap ? cap : hi);
  long long lo = 0;
  const long long x = probes[i];
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  out[i] = (int)lo;
}

}  // namespace

// keys: int64[cap] sorted over [0, n_valid); n_valid: int64[1] on the
// device; probes: int64[p]; out: int32[p].  Launches on `stream`; returns
// the launch status.
extern "C" cudaError_t sorted_probe_launch(const void* keys, long long cap,
                                           const void* n_valid,
                                           const void* probes, long long p,
                                           void* out, void* stream) {
  long long blocks = (p + kThreads - 1) / kThreads;
  sorted_probe_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const long long*)keys, cap, (const long long*)n_valid,
      (const long long*)probes, p, (int*)out);
  return cudaGetLastError();
}
