// int8 dequantization for Hopper (sm_90a): int8 [n] -> f32 [n].
//
// Replaces the Pallas kernel
// byteps_tpu/ops/compression/pallas_kernels.py::_int8_dq_kernel (wrapper
// int8_dequantize, pallas_call at :256). On the parameter-server path the
// device encode (compress/device.py) runs it once per int8 bucket per step
// for the error-feedback residual x - q·s, the same function as the JAX
// encode's q.astype(f32) * scale.
//
// Contract: out = (float) q · s, one correctly rounded multiply
// (__fmul_rn, which the compiler never contracts into an FMA; no fast
// math, so a subnormal product stays subnormal). The scale is taken as
// given. The subtraction x - out stays a separate tensor operation in the
// wrapper's caller, so nothing rounds the residual differently from the
// host codec.
//
// What bounds it on an H100: 1 byte read and 4 written per element (5n
// bytes, 4n of them writes: 5.12 MB for a 1,024,000-element bucket) and
// one multiply: device memory, the writes above all, as in
// onebit_unpack.cu, whose traffic it shares. So:
//   - one wave: the wrapper's launch plan (kernels.py::stream_plan with no
//     head: `out` is the wrapper's own torch.empty, 16-byte aligned,
//     checked there) sizes the grid to at most kMinBlocks CTAs a SM, fewer
//     when the bucket needs fewer (a bucket is 125 CTAs), and a larger n
//     walks the same grid in a stride loop;
//   - wide stores: a warp covers 32 · kVecs float4s. For j in
//     0..kVecs-1 lane l writes float4 number 32j + l of the warp's block,
//     so each store instruction writes 512 contiguous bytes, and a thread
//     has kVecs of them (128 B) in flight;
//   - the codes of float4 f are the 4-byte word at q + 4f: a warp load
//     reads 128 contiguous bytes, and a thread issues its kVecs loads
//     before its first multiply.
// Plain stores: the caller's next operation (x - out) reads the output,
// and wants it in L2.
// q may be a contiguous view at any byte offset (check_quant_input admits
// q[k:]). Where q is not 4-byte aligned its words straddle the float4s,
// and the kWords = false instance reads each float4's codes with four
// coalesced 1-byte loads (the warp's 128 bytes four times over; L1 serves
// the repeats) and stores the same float4s. No copy is made. The two
// tie on one flushed bucket, but the word instance is the faster with q
// warm in L2, as the encode leaves it, and on four buckets (PERF.md §6),
// so an aligned q takes it. The n % 4 elements past the float4s are
// written one by one by CTA 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // kernels.py::CTA_THREADS
constexpr int kMinBlocks = 4;   // resident CTAs a SM (kernels.py::CTAS_PER_SM)
constexpr int kVecs = 8;        // float4 stores a thread
                                // (kernels.py::DEQUANT_VECS)

// The four codes of float4 f as loaded: one aligned 4-byte word, code k
// in its byte k (kWords), or four bytes. Each code converts straight from
// the register its load wrote: a char4 rebuilt from the word put PRMTs
// between each load and its convert, and that form lost to byte loads on
// the card (PERF.md §6).
template <bool kWords>
struct Codes {
  uint32_t v[kWords ? 1 : 4];

  __device__ __forceinline__ void load(const int8_t* __restrict__ q,
                                       long long f, bool in) {
    if (kWords) {
      v[0] = in ? reinterpret_cast<const uint32_t*>(q)[f] : 0u;
    } else {
      const uint8_t* p = reinterpret_cast<const uint8_t*>(q) + 4 * f;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = in ? p[k] : 0u;
    }
  }

  __device__ __forceinline__ float operator[](int k) const {
    return static_cast<float>(
        static_cast<int8_t>(kWords ? v[0] >> (8 * k) : v[k]));
  }
};

template <bool kWords>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
int8_dequantize_kernel(const int8_t* __restrict__ q, float* __restrict__ out,
                       long long n, long long vecs, float s) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  float4* ov = reinterpret_cast<float4*>(out);
  const long long chunk = static_cast<long long>(kThreads) * kVecs;
  for (long long c0 = blockIdx.x * chunk; c0 < vecs;
       c0 += static_cast<long long>(gridDim.x) * chunk) {
    const long long g0 = c0 + (t >> 5) * 32 * kVecs;   // the warp's float4 0
    Codes<kWords> c[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long f = g0 + 32 * j + lane;
      c[j].load(q, f, f < vecs);
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long f = g0 + 32 * j + lane;
      if (f < vecs)
        ov[f] = make_float4(__fmul_rn(c[j][0], s), __fmul_rn(c[j][1], s),
                            __fmul_rn(c[j][2], s), __fmul_rn(c[j][3], s));
    }
  }
  if (blockIdx.x == 0 && 4 * vecs + t < n) {   // the tail, one by one
    const long long i = 4 * vecs + t;
    out[i] = __fmul_rn(static_cast<float>(q[i]), s);
  }
}

}  // namespace

// Launches on `stream`, allocates nothing (`out` holds n floats, 16-byte
// aligned); `words` picks the instance (kernels.py::dequantize_reads_words:
// 1 the word one, 0 the byte one). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan that does not cover [0, n) as vecs
// float4s and a tail (< 4), a misaligned `out`, no CTA, or the word
// instance on a q that is not 4-byte aligned.
extern "C" int bps_int8_dequantize_planned(const void* q, void* out,
                                           long long n, long long vecs,
                                           int grid, int words, float scale,
                                           void* stream) {
  if (n <= 0 || vecs < 0 || vecs > n / 4 || n - 4 * vecs > 3 || grid <= 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (words && reinterpret_cast<uintptr_t>(q) % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qc = static_cast<const int8_t*>(q);
  auto* of = static_cast<float*>(out);
  if (words)
    int8_dequantize_kernel<true><<<grid, kThreads, 0, st>>>(qc, of, n, vecs,
                                                           scale);
  else
    int8_dequantize_kernel<false><<<grid, kThreads, 0, st>>>(qc, of, n, vecs,
                                                            scale);
  return static_cast<int>(cudaGetLastError());
}
