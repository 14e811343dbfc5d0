// The walk shared by the one-wave quantize kernels (int8_quantize.cu,
// fp8_sr_quantize.cu): f32 [n] -> one code byte per element, on the launch
// plan that ops/compression/kernels.py::stream_plan computes.
//
// The plan covers [0, n) as a head of `head` (< 4) elements up to the first
// 16-byte boundary of x, `vecs` float4s from x + head, and a tail (< 4).
// CTA 0 codes the head and the tail one by one. The float4s are walked in
// chunks of kThreads · kVecs, CTA b taking chunks b, b + grid, ... (one
// wave, a stride loop beyond it). Each thread issues its kVecs 16-byte
// loads (64 B at kVecs 4) before its first code, and for each of them the
// warp reads 512 contiguous bytes.
//
// The codes of a float4 leave as one 4-byte word (128 contiguous bytes a
// warp) when q + head is 4-byte aligned. x may be a view at any 4-byte
// offset (a single-leaf bucket without error feedback), and then q + head
// is aligned only to head bytes: that case takes kAlignedStore = false,
// whose warp regathers its 128 codes by shuffles and writes them as 4 byte
// stores of 32 contiguous bytes each.
//
// A `Codes` type gives the function: `one(x, i)`, the code byte of element
// i, and `four(v, i)`, the codes of the float4 v holding elements i..i+3,
// element i in the low byte (memory order).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // kernels.py::CTA_THREADS
constexpr int kMinBlocks = 4;   // resident CTAs a SM (kernels.py::CTAS_PER_SM)

template <int kVecs, bool kAlignedStore, class Codes>
__device__ __forceinline__ void stream_codes(const float* __restrict__ x,
                                             uint8_t* __restrict__ q,
                                             long long n, int head,
                                             long long vecs,
                                             const Codes& codes) {
  const int t = threadIdx.x;
  if (blockIdx.x == 0) {               // the head and the tail, one by one
    const long long end = head + 4 * vecs;
    if (t < head) {
      q[t] = codes.one(x[t], t);
    } else if (t >= 4 && end + (t - 4) < n) {
      q[end + t - 4] = codes.one(x[end + t - 4], end + t - 4);
    }
  }
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  uint8_t* qb = q + head;
  const long long chunk = static_cast<long long>(kThreads) * kVecs;
  const int lane = t & 31;
  for (long long c0 = blockIdx.x * chunk; c0 < vecs;
       c0 += static_cast<long long>(gridDim.x) * chunk) {
    float4 v[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long i = c0 + j * kThreads + t;
      v[j] = i < vecs ? xv[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long i = c0 + j * kThreads + t;
      const uint32_t c = codes.four(v[j], head + 4 * i);
      if (kAlignedStore) {
        if (i < vecs) reinterpret_cast<uint32_t*>(qb)[i] = c;
      } else {
        // the warp's 128 codes from vector i - lane on: byte store r writes
        // codes 32r..32r+31, code 32r + lane held by lane 8r + lane / 4
        const long long w0 = i - lane;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int src = 8 * r + (lane >> 2);
          const uint32_t word = __shfl_sync(0xFFFFFFFFu, c, src);
          if (w0 + src < vecs)
            qb[4 * w0 + 32 * r + lane] =
                static_cast<uint8_t>(word >> (8 * (lane & 3)));
        }
      }
    }
  }
}

}  // namespace
