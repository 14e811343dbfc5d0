// Onebit sign packing for Hopper (sm_90a): f32 [n] -> 32-bit words
// [ceil(n / 32)].
//
// Replaces the Pallas kernel
// byteps_tpu/ops/compression/pallas_kernels.py::_pack_kernel (wrapper
// onebit_pack, pallas_call at :72), run once per compressed gradient bucket
// per step by the onebit compressor.
//
// Contract (the Pallas kernel's, and the reference's packing): bit =
// (x < 0), 32 consecutive elements per word, element 0 of each group in the
// most significant bit, the tail past n zero-padded. The comparison, not
// the sign bit, decides: -0.0 and NaN pack as 0, as `x < 0` does there.
// The TPU and XLA's CPU backend flush denormals to zero, so a negative
// denormal packs as 0 there too; Hopper keeps denormals (no fast math), so
// the kernel compares with -FLT_MIN: x <= -FLT_MIN is x < 0 with denormals
// taken as zero.
//
// What bounds it on an H100: one float read per bit and one word written
// per 32 floats (4n + n/8 bytes: 4.22 MB for a 1,024,000-float bucket)
// and a compare per float: device memory, the reads above all. Keeping
// the memory busy takes megabytes of loads in flight (Little's law: its
// rate times its latency). So:
//   - one wave: the wrapper's launch plan (kernels.py::pack_plan, on
//     stream_plan) sizes the grid to at most kMinBlocks CTAs a SM, fewer
//     when the bucket needs fewer (a bucket is 125 CTAs), and a larger n
//     walks the same grid in a stride loop;
//   - wide loads, all in flight before the first compare: a warp covers
//     32 words (1,024 floats, 256 float4s). For j in 0..7 lane l loads
//     float4 number 32j + l of the warp's 256, so each load instruction
//     reads 512 contiguous bytes and a thread holds 8 of them (128 B);
//   - the words in one vote and one store: float4 32j + l holds bits
//     4(l % 8)..4(l % 8) + 3, from the top, of word 4j + l / 8. For each j
//     the warp takes four ballots, one per element k of the float4, so bit
//     8g + m of ballot k is element 4m + k of word 4j + g. Lane L keeps
//     the four ballots of j = L / 4 and builds word L from their byte
//     g = L % 4: each byte's bits spread to stride 4, shifted by k, ORed,
//     then bit-reversed (element 0 at the top). The warp stores its 32
//     words, 128 contiguous bytes, in one instruction.
// The plan's vectors start at element 0 (x 16-byte aligned; the trainer's
// buckets are fresh tensors): the n % 4 floats past them ride in one more
// float4 slot, read one by one. x may be a view at any 4-byte offset, and
// then its float4s would straddle words (word boundaries are fixed by
// x[0]): that case takes the kVector = false instance, whose warp covers 8
// words with 8 coalesced 4-byte loads a thread (all in flight before the
// first ballot), one ballot each; lanes 0..7 store the 8 words. A CTA
// then takes 2,048 floats a pass, not 8,192, and the wrapper sizes the
// grid to that (kernels.py::pack_plan; one wave, 500 CTAs a bucket). No
// copy is made.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // kernels.py::CTA_THREADS
constexpr int kMinBlocks = 4;   // resident CTAs a SM (kernels.py::CTAS_PER_SM)
constexpr int kVecs = 8;        // float4 loads a thread (kernels.py::PACK_VECS)
constexpr int kScalars = 8;     // 4-byte loads a thread, kVector = false
                                // (kernels.py::PACK_SCALARS)

__device__ __forceinline__ bool neg(float v) { return v <= -FLT_MIN; }

// bit m of the byte b to bit 4m
__device__ __forceinline__ uint32_t spread4(uint32_t b) {
  b = (b | (b << 12)) & 0x000F000Fu;
  b = (b | (b << 6)) & 0x03030303u;
  return (b | (b << 3)) & 0x11111111u;
}

// float4 slot f: the vector itself below `vecs`, else the floats of
// [4f, 4f + 4) below n one by one (the tail), 0 (no bit) past n
__device__ __forceinline__ float4 slot(const float* __restrict__ x,
                                      long long f, long long vecs,
                                      long long n) {
  if (f < vecs) return reinterpret_cast<const float4*>(x)[f];
  const long long i = 4 * f;
  return make_float4(i < n ? x[i] : 0.f, i + 1 < n ? x[i + 1] : 0.f,
                     i + 2 < n ? x[i + 2] : 0.f, i + 3 < n ? x[i + 3] : 0.f);
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
onebit_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                   long long n, long long vecs) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const long long nwords = (n + 31) / 32;
  if (kVector) {
    const long long slots = (n + 3) / 4;
    const long long chunk = static_cast<long long>(kThreads) * kVecs;
    for (long long c0 = blockIdx.x * chunk; c0 < slots;
         c0 += static_cast<long long>(gridDim.x) * chunk) {
      const long long g0 = c0 + (t >> 5) * 32 * kVecs;   // the warp's float4 0
      float4 v[kVecs];
#pragma unroll
      for (int j = 0; j < kVecs; ++j)
        v[j] = slot(x, g0 + 32 * j + lane, vecs, n);
      uint32_t mine[4] = {0u, 0u, 0u, 0u};   // the ballots of j = lane / 4
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const uint32_t b0 = __ballot_sync(0xFFFFFFFFu, neg(v[j].x));
        const uint32_t b1 = __ballot_sync(0xFFFFFFFFu, neg(v[j].y));
        const uint32_t b2 = __ballot_sync(0xFFFFFFFFu, neg(v[j].z));
        const uint32_t b3 = __ballot_sync(0xFFFFFFFFu, neg(v[j].w));
        if ((lane >> 2) == j) {
          mine[0] = b0;
          mine[1] = b1;
          mine[2] = b2;
          mine[3] = b3;
        }
      }
      const int sh = 8 * (lane & 3);
      const uint32_t w = spread4((mine[0] >> sh) & 0xFFu) |
                         (spread4((mine[1] >> sh) & 0xFFu) << 1) |
                         (spread4((mine[2] >> sh) & 0xFFu) << 2) |
                         (spread4((mine[3] >> sh) & 0xFFu) << 3);
      const long long wi = g0 / 8 + lane;
      if (wi < nwords) words[wi] = __brev(w);
    }
  } else {
    const long long chunk = static_cast<long long>(kThreads) * kScalars;
    for (long long c0 = blockIdx.x * chunk; c0 < n;
         c0 += static_cast<long long>(gridDim.x) * chunk) {
      const long long e0 = c0 + (t >> 5) * 32 * kScalars;   // a word's start
      float v[kScalars];
#pragma unroll
      for (int j = 0; j < kScalars; ++j) {
        const long long i = e0 + 32 * j + lane;
        v[j] = i < n ? x[i] : 0.f;
      }
      uint32_t w = 0u;
#pragma unroll
      for (int j = 0; j < kScalars; ++j) {
        const uint32_t b = __ballot_sync(0xFFFFFFFFu, neg(v[j]));
        if (lane == j) w = b;
      }
      const long long wi = e0 / 32 + lane;
      if (lane < kScalars && wi < nwords) words[wi] = __brev(w);
    }
  }
}

}  // namespace

// Launches on `stream`, allocates nothing (`words` holds ceil(n / 32)
// 32-bit words); returns cudaGetLastError(), or cudaErrorInvalidValue for
// a plan that does not cover [0, n) as head (< 4 elements), vecs float4s
// from x + head (16-byte aligned) and a tail (< 4), a 16-byte aligned x
// with a head, misaligned words, or no CTA. An aligned x takes the float4
// instance (the plan's vectors from element 0), any other the 4-byte one.
extern "C" int bps_onebit_pack_planned(const void* x, void* words,
                                       long long n, int head, long long vecs,
                                       int grid, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const long long tail = n - head - 4 * vecs;
  const bool aligned = reinterpret_cast<uintptr_t>(xf) % 16 == 0;
  if (n <= 0 || head < 0 || head > 3 || vecs < 0 || tail < 0 || tail > 3 ||
      grid <= 0 || (aligned && head != 0) ||
      (vecs > 0 && reinterpret_cast<uintptr_t>(xf + head) % 16 != 0) ||
      reinterpret_cast<uintptr_t>(words) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* wp = static_cast<uint32_t*>(words);
  if (aligned)
    onebit_pack_kernel<true><<<grid, kThreads, 0, st>>>(xf, wp, n, vecs);
  else
    onebit_pack_kernel<false><<<grid, kThreads, 0, st>>>(xf, wp, n, vecs);
  return static_cast<int>(cudaGetLastError());
}
