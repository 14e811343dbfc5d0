// Onebit sign unpacking for Hopper (sm_90a): 32-bit words [m] -> f32 [n],
// n <= 32·m.
//
// Replaces the Pallas kernel
// byteps_tpu/ops/compression/pallas_kernels.py::_unpack_kernel (wrapper
// onebit_unpack, pallas_call at :92), run 1 + world times per compressed
// gradient bucket per step (error feedback's decompress, then one per
// gathered payload).
//
// Contract (the Pallas kernel's): element i is 1 - 2·bit, bit = (word[i / 32]
// >> (31 - i % 32)) & 1, as f32, UNSCALED: the caller multiplies by the
// payload's scale.
//
// What bounds it on an H100: one word read per 32 floats written (4n +
// n/8 bytes: 4.22 MB for a 1,024,000-float bucket) and a few integer
// operations per float: device memory, and the writes above all. So:
//   - one wave: the wrapper's launch plan (kernels.py::stream_plan) sizes
//     the grid to at most kMinBlocks CTAs a SM, fewer when the bucket
//     needs fewer (a bucket is 125 CTAs), and a larger n walks the same
//     grid in a stride loop;
//   - wide stores: a warp covers 32 words (1,024 floats). Lane l reads
//     word w0 + l with one coalesced 4-byte load (the words may be a view
//     at any 4-byte offset, a gathered payload). Then for j in 0..7 it
//     writes float4 number 32j + l of the warp's 256, whose four bits sit
//     in the word of lane 4j + l / 8 (taken by __shfl_sync): each store
//     instruction writes 512 contiguous bytes, and a thread has 8 of them,
//     128 B, in flight.
// The output is the wrapper's own torch.empty (16-byte aligned, checked
// there), so the float4s start at element 0; the n % 4 floats past them
// are written one by one by CTA 0. Plain stores: the next launch
// (signs * scale) reads the signs, and wants them in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;   // resident CTAs a SM (kernels.py::CTAS_PER_SM)
constexpr int kVecs = 8;        // float4 stores a thread: a warp's 32 words

__device__ __forceinline__ float sign_of(uint32_t bit) {
  return 1.f - 2.f * static_cast<float>(bit);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
onebit_unpack_kernel(const uint32_t* __restrict__ words,
                     float* __restrict__ out, long long n, long long vecs) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const long long nwords = (n + 31) / 32;
  float4* ov = reinterpret_cast<float4*>(out);
  const long long chunk = static_cast<long long>(kThreads) * kVecs;
  const int shift = 28 - 4 * (lane & 7);  // this lane's 4 bits in a word
  for (long long c0 = blockIdx.x * chunk; c0 < vecs;
       c0 += static_cast<long long>(gridDim.x) * chunk) {
    const long long g0 = c0 + (t >> 5) * 32 * kVecs;   // the warp's float4 0
    const long long wi = g0 / 8 + lane;
    const uint32_t w = wi < nwords ? words[wi] : 0u;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const uint32_t src = __shfl_sync(0xFFFFFFFFu, w, 4 * j + (lane >> 3));
      const uint32_t nib = src >> shift;
      const long long f = g0 + 32 * j + lane;
      if (f < vecs)
        ov[f] = make_float4(sign_of((nib >> 3) & 1u), sign_of((nib >> 2) & 1u),
                            sign_of((nib >> 1) & 1u), sign_of(nib & 1u));
    }
  }
  if (blockIdx.x == 0 && 4 * vecs + t < n) {   // the tail, one by one
    const long long i = 4 * vecs + t;
    out[i] = sign_of((words[i >> 5] >> (31 - (i & 31))) & 1u);
  }
}

}  // namespace

// Launches on `stream`, allocates nothing (`words` holds at least
// ceil(n / 32) words, `out` n floats, 16-byte aligned); returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan that does not
// cover [0, n) as vecs float4s and a tail (< 4), a misaligned `out`, or
// no CTA.
extern "C" int bps_onebit_unpack_planned(const void* words, void* out,
                                         long long n, long long vecs,
                                         int grid, void* stream) {
  const long long tail = n - 4 * vecs;
  if (n <= 0 || vecs < 0 || tail < 0 || tail > 3 || grid <= 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  onebit_unpack_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<float*>(out), n, vecs);
  return static_cast<int>(cudaGetLastError());
}
