// masked_sum: sum of int64 values where mask, modulo 2^64.
//
// Replaces the Pallas TPU kernel presto_tpu/ops/pallas_kernels.py:masked_sum
// (body _masked_sum_kernel).  The TPU version splits each int64 into
// 18-bit/46-bit int32 words because its vector unit is 32-bit, which makes
// it exact only for |v| < 2^43.  Hopper loads and adds int64 natively, so
// this kernel accumulates whole 64-bit words and is exact for every input
// (the sum wraps mod 2^64 exactly like jnp.sum / torch.sum over int64).
//
// Bound on an H100: bytes.  Each row is read once: 8 bytes of value and
// 1 byte of mask, so N rows need 9N bytes over 3.35 TB/s (6 M rows: 16 us).
// Design for that bound: a grid-stride loop so a fixed grid of a few blocks
// per SM streams the whole input with coalesced loads; the reduction (warp
// shuffles, then one shared-memory pass per block, then one atomicAdd per
// block) costs nothing next to the stream.  Integer addition mod 2^64 is
// associative, so the atomics leave the result deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
masked_sum_kernel(const long long* __restrict__ values,
                  const unsigned char* __restrict__ mask, long long n,
                  unsigned long long* __restrict__ out) {
  unsigned long long acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (mask[i]) acc += (unsigned long long)values[i];
  }
  __shared__ unsigned long long warp_part[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  acc = warp_sum(acc);
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_part[lane] : 0ull;
    acc = warp_sum(acc);
    if (lane == 0) atomicAdd(out, acc);
  }
}

}  // namespace

// values: int64[n], mask: bool[n] (one byte each), out: int64[1] zeroed by
// the caller.  Launches on `stream`; returns the launch status.
extern "C" cudaError_t masked_sum_launch(const void* values, const void* mask,
                                         long long n, void* out,
                                         void* stream) {
  static int sms = 0;  // SM count of the card, read once
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return cudaGetLastError();
  }
  long long want = (n + kThreads - 1) / kThreads;
  long long cap = (long long)sms * 8;
  int blocks = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  masked_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)values, (const unsigned char*)mask, n,
      (unsigned long long*)out);
  return cudaGetLastError();
}
