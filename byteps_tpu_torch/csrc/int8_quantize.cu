// int8 quantization for Hopper (sm_90a): f32 [n] -> int8 [n].
//
// Replaces the Pallas kernel
// byteps_tpu/ops/compression/pallas_kernels.py::_int8_q_kernel (wrapper
// int8_quantize, pallas_call at :151), run once per compressed gradient
// bucket per step by the parameter-server path's device encode
// (compress/device.py) under BPS_COMPRESS=int8.
//
// Contract (the codec's, compress/wire.py CODEC_INT8): q = clip(
// round-half-even(x / s), -127, 127), s <= 0 taken as 1.0. The payload must
// be byte-identical to numpy's rint(x / s), so the division is correctly
// rounded (__fdiv_rn; a reciprocal multiply flips round-half-even ties on
// a few elements in ten million) and the rounding is rintf, never roundf.
// The file is never built with fast math. NaN inputs are outside the
// contract (the codec's scale is then meaningless).
//
// What bounds it on an H100: 4 bytes read and 1 written per element (5n
// bytes: 5.12 MB for a 1,024,000-float bucket) and a handful of
// operations: device memory. Keeping the memory busy takes megabytes of
// loads in flight (Little's law: its rate times its latency). So:
//   - one wave: the wrapper's launch plan (kernels.py::stream_plan) sizes
//     the grid to at most kMinBlocks CTAs a SM, fewer when the bucket
//     needs fewer (a bucket is 250 CTAs), and a larger n walks the same
//     grid in a stride loop;
//   - wide loads, all in flight before the arithmetic: each thread issues
//     its kVecs 16-byte loads (64 B) before its first code, so no
//     arithmetic sits between a load and the next; for each of them the
//     warp reads 512 contiguous bytes;
//   - the codes of a float4 leave as one 4-byte word (128 contiguous bytes
//     a warp);
//   - few instructions after the last load: a correctly rounded divide and
//     a float-to-int conversion per element both run on the SM's
//     quarter-rate units, and in one wave every thread reaches them at
//     once. So each code comes from the host's correctly rounded
//     reciprocal r (x · r, a clip, and an add that rounds half to even
//     into the low byte: full-rate instructions only), and a float4 takes
//     the divide only where x · r lies too close to a half-integer to be
//     sure of rint(x / s) (codes4_recip), or every element does where r is
//     not a normal float. Every code is the divide's.
// The walk (the head and tail, the float4 loop, the aligned and shuffled
// stores) is codec_stream.cuh's, shared with fp8_sr_quantize.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "codec_stream.cuh"

namespace {

constexpr int kVecs = 4;   // float4 loads a thread (kernels.py::QUANT_VECS)

__device__ __forceinline__ uint32_t code(float x, float s) {
  float v = rintf(__fdiv_rn(x, s));
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(v)) & 0xFFu;
}

// The four codes of a float4, element 0 in the low byte (memory order).
__device__ __forceinline__ uint32_t codes4(float4 v, float s) {
  return code(v.x, s) | (code(v.y, s) << 8) | (code(v.z, s) << 16) |
         (code(v.w, s) << 24);
}

// v + kRound holds rint(v), rounded half to even by the add itself, in the
// low bits of its pattern for |v| < 2^22: no conversion instruction
constexpr float kRound = 12582912.0f;          // 1.5 · 2^23
constexpr float kMargin = 4.76837158203125e-7f;  // 2^-21

// The same four codes by the reciprocal r = RN(1 / s) (a normal float):
// y = clip(RN(x · r), ±127), its code the low byte of y + kRound. RN(x · r)
// lies within |y| · 2^-22 of RN(x / s) (three roundings of relative 2^-24
// each), and clipping is monotone, so where y is farther than |y| · 2^-21
// from every half-integer, rint of both is one integer and the code is
// exact. `gap` takes the least such distance less the margin over the
// four; where it is not > 0 the caller takes codes4. NaN clips to -127 on
// both paths.
__device__ __forceinline__ uint32_t codes4_recip(float4 v, float r,
                                                 float& gap) {
  const float e[4] = {v.x, v.y, v.z, v.w};
  uint32_t b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float y = fminf(fmaxf(__fmul_rn(e[k], r), -127.0f), 127.0f);
    const float t = __fadd_rn(y, kRound);
    const float d = fabsf(__fsub_rn(y, __fsub_rn(t, kRound)));
    gap = fminf(gap, __fsub_rn(__fmaf_rn(-fabsf(y), kMargin, 0.5f), d));
    b[k] = __float_as_uint(t);
  }
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                     __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// The codes of the int8 codec, for codec_stream.cuh's walk.
struct Int8Codes {
  float s, r;
  bool recip;   // r = RN(1 / s) is a normal float

  __device__ __forceinline__ uint8_t one(float x, long long) const {
    return static_cast<uint8_t>(code(x, s));
  }
  __device__ __forceinline__ uint32_t four(float4 v, long long) const {
    float gap = 1.0f;
    uint32_t c = recip ? codes4_recip(v, r, gap) : 0u;
    if (!(gap > 0.0f) || !recip) c = codes4(v, s);
    return c;
  }
};

template <bool kAlignedStore>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
int8_quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     long long n, int head, long long vecs, Int8Codes codes) {
  stream_codes<kVecs, kAlignedStore>(x, reinterpret_cast<uint8_t*>(q), n,
                                     head, vecs, codes);
}

}  // namespace

// Launches on `stream`, allocates nothing (`q` holds n bytes); returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan that does not
// cover [0, n) as head (< 4 elements), vecs float4s from x + head (16-byte
// aligned) and a tail (< 4), or for no CTA.
extern "C" int bps_int8_quantize_planned(const void* x, void* q, long long n,
                                         int head, long long vecs, int grid,
                                         float scale, void* stream) {
  const float* xf = static_cast<const float*>(x);
  int8_t* qb = static_cast<int8_t*>(q);
  const long long tail = n - head - 4 * vecs;
  if (n <= 0 || head < 0 || head > 3 || vecs < 0 || tail < 0 || tail > 3 ||
      grid <= 0 ||
      (vecs > 0 && reinterpret_cast<uintptr_t>(xf + head) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const float s = scale > 0.0f ? scale : 1.0f;
  const float r = 1.0f / s;   // correctly rounded on the host too
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Int8Codes codes{s, r, std::isnormal(r)};
  if (reinterpret_cast<uintptr_t>(qb + head) % 4 == 0)
    int8_quantize_kernel<true><<<grid, kThreads, 0, st>>>(
        xf, qb, n, head, vecs, codes);
  else
    int8_quantize_kernel<false><<<grid, kThreads, 0, st>>>(
        xf, qb, n, head, vecs, codes);
  return static_cast<int>(cudaGetLastError());
}
