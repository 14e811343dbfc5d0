// fp8 stochastic rounding for Hopper (sm_90a): f32 [n] -> fp8 bytes [n].
//
// Replaces the Pallas kernel
// byteps_tpu/ops/compression/pallas_kernels.py::_fp8_sr_kernel (wrapper
// fp8_sr_quantize, pallas_call at :234), run once per compressed gradient
// bucket per step by the parameter-server path's device encode
// (compress/device.py) under BPS_COMPRESS=fp8_e4m3 or fp8_e5m2.
//
// Contract: the bytes of ops/compression/fp8sr.py::sr_quantize_bits, bit
// for bit, for the same (x, scale, seed, kind):
//   y = clip(x / s, ±MAX) with a correctly rounded division (s <= 0 taken
//   as 1.0); the noise h = fmix32((i * 0x9E3779B9) ^ seed) with i the
//   element's flat index in the bucket (uint32 multiplies wrap); noise of
//   the discard width added to the magnitude bits and the low bits cut;
//   under the subnormal quantum a Bernoulli draw, comparing (h >> 8) · 2^-24
//   with |y| · 2^(127 - e_sub) in fp32; then the on-grid magnitude packed
//   into sign | exponent | mantissa. Hopper's native fp8 conversion
//   (__nv_cvt_float_to_fp8) rounds to nearest and is not this function, so
//   the kernel stays in uint32 arithmetic. Templated on the format: E4M3
//   (bias 7, max 448) and E5M2 (bias 15, max 57344).
//
// What bounds it on an H100: 4 bytes read and 1 written per element (5n
// bytes: 5.12 MB for a 1,024,000-float bucket) at the memory's rate. Its
// integer operations come close: a quotient in the normal range needs
// about 18 an element (the hash 10, the code 8), about 70% of the bytes'
// time at the card's INT32 rate (132 SMs · 64 lanes a clock), and the
// kernel issues more instructions than that (the divide's, the clip, the
// loads and stores), so the instruction count matters as much as the
// bytes in flight. So:
//   - the walk of codec_stream.cuh: one wave on the wrapper's launch plan,
//     each thread's kVecs 16-byte loads issued before its first divide,
//     the codes of a float4 stored as one 4-byte word, misaligned views
//     handled by a head and a byte-store instance. kVecs is 2 (32 B a
//     thread; a bucket is 500 CTAs, about 30 warps a SM): a bucket is in
//     flight whole at 2, 4 or 8 alike, and the operations after the loads
//     finish sooner spread over more warps (on an H100, 2 beat 4 and 8:
//     PERF.md);
//   - no quarter-rate instruction on the common path. The division comes
//     from the host's r = RN(1 / s) (Markstein): q0 = RN(x · r), the
//     remainder x - q0 · s exact by an fma, y = RN(q0 + (x - q0 · s) · r).
//     Markstein's theorem makes y = RN(x / s) when r is RN(1 / s), q0 lies
//     within one ulp of x / s and nothing under- or overflows. The guard
//     (`Fp8Codes::fast`) asks of each element of a float4 lo <= |x| <= hi
//     with lo = max(2^-100, 2^-99 · s) and hi = min(2^124 · s, FLT_MAX)
//     (r normal): then |x| >= 2^-100 and 2^-99 <= |x / s| <= 2^124, so
//     q0, the remainder and y are normal and finite with room to spare
//     (the remainder is about 2^-24 |x|, q0 · s at most 2^125 · s). x = ±0
//     passes too: the remainder is taken as q0 · s - x and subtracted, so
//     y is q0 = ±0 with x's sign. Elsewhere (an element under 2^-100 or
//     beyond hi, inf, NaN) the float4's four elements take __fdiv_rn (a
//     head or tail element alone), and where r is not normal the host
//     sets r = 1, lo = inf, hi = 0, so that every element but ±0 does;
//   - the rounding: a float4 whose four quotients are all zero or at
//     least the format's smallest normal (every element of a gradient
//     bucket but a few) takes the normal-range form of the contract, the
//     code ((|y| + (h & mask)) >> base) - ((emin - 1) << mant), which is
//     the contract's pack when the exponent is at least emin, and max(., 0)
//     gives 0 for ±0; others take the contract's arithmetic as it stands,
//     the Bernoulli draw's uint32-to-float conversion included;
//   - the hash of the four elements of a float4 shares its first multiply
//     (i · 0x9E3779B9 + k · 0x9E3779B9).
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "codec_stream.cuh"

namespace {

constexpr int kVecs = 2;        // float4 loads a thread (kernels.py::FP8_VECS)

template <int MANT, int EMIN>
struct Fp8Codes {
  static constexpr int BASE = 23 - MANT;
  static constexpr int E_SUB = EMIN - MANT;
  static constexpr uint32_t QBITS = static_cast<uint32_t>(E_SUB) << 23;
  // 2^(127 - e_sub): |y| / quantum for the subnormal branch (exact)
  static constexpr float T_SCALE = static_cast<float>(1u << (127 - E_SUB));
  // the format's smallest normal, 2^(emin - 127)
  static constexpr float MIN_NORMAL =
      static_cast<float>(1.0 / static_cast<double>(1ull << (127 - EMIN)));
  static constexpr uint32_t MASK = (1u << BASE) - 1u;   // a normal's discard
  static constexpr int REBIAS = (EMIN - 1) << MANT;

  float s, r, lo, hi, mx;   // r = RN(1 / s), or 1 where that is not normal
  uint32_t seed;

  __device__ __forceinline__ uint32_t mix(uint32_t i) const {
    uint32_t h = (i * 0x9E3779B9u) ^ seed;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
  }

  // inside the guard: markstein(x) is RN(x / s)
  __device__ __forceinline__ bool fast(float x) const {
    const float a = fabsf(x);
    return ((a >= lo) & (a <= hi)) | (x == 0.0f);
  }

  __device__ __forceinline__ float markstein(float x) const {
    const float q0 = __fmul_rn(x, r);
    const float rem = __fmaf_rn(q0, s, -x);       // q0 · s - x, exact
    return __fmaf_rn(-rem, r, q0);
  }

  __device__ __forceinline__ float quotient(float x) const {
    return fast(x) ? markstein(x) : __fdiv_rn(x, s);
  }

  // The contract's code of y = RN(x / s), as it stands.
  __device__ __forceinline__ uint32_t code_any(float y, uint32_t h) const {
    // numpy's clip, which keeps a NaN (fminf / fmaxf would drop it). NaN
    // inputs are outside the contract all the same: the card's division
    // returns its one canonical NaN, numpy keeps the input's bits.
    y = y < -mx ? -mx : (y > mx ? mx : y);
    const uint32_t bits = __float_as_uint(y);
    const uint32_t sign = bits >> 31;
    const uint32_t mag = bits & 0x7FFFFFFFu;
    const int e = static_cast<int>(mag >> 23);
    const int d = min(max(EMIN + BASE - e, BASE), 23);
    const uint32_t mask = (1u << d) - 1u;
    const uint32_t mag_grid = (mag + (h & mask)) & ~mask;
    const float u24 = __fmul_rn(static_cast<float>(h >> 8), 0x1p-24f);
    const float t = __fmul_rn(fabsf(y), T_SCALE);
    const uint32_t mag_tiny = u24 < t ? QBITS : 0u;
    uint32_t mag2 = e < E_SUB ? mag_tiny : mag_grid;
    if (mag == 0u) mag2 = 0u;
    const uint32_t e2 = mag2 >> 23;
    const uint32_t f2 = mag2 & 0x7FFFFFu;
    uint32_t out;
    if (mag2 == 0u) {
      out = 0u;
    } else if (e2 >= static_cast<uint32_t>(EMIN)) {
      out = ((e2 - (EMIN - 1)) << (23 - BASE)) | (f2 >> BASE);
    } else {
      const int sh = min(max(EMIN + BASE - static_cast<int>(e2), 0), 31);
      out = ((1u << 23) | f2) >> sh;
    }
    return (sign << 7) | out;
  }

  // The same code where y is ±0 or at least MIN_NORMAL (or inf): the
  // discard width is BASE, and the pack of an exponent >= EMIN is the
  // on-grid magnitude's top bits less the rebias.
  __device__ __forceinline__ uint32_t code_normal(float y, uint32_t h) const {
    const uint32_t bits = __float_as_uint(fminf(fmaxf(y, -mx), mx));
    const int grid = static_cast<int>(((bits & 0x7FFFFFFFu) + (h & MASK)) >>
                                      BASE);
    return static_cast<uint32_t>(max(grid - REBIAS, 0)) |
           ((bits >> 24) & 0x80u);
  }

  __device__ __forceinline__ uint8_t one(float x, long long i) const {
    return static_cast<uint8_t>(
        code_any(quotient(x), mix(static_cast<uint32_t>(i))));
  }

  __device__ __forceinline__ uint32_t four(float4 v, long long i) const {
    const float e[4] = {v.x, v.y, v.z, v.w};
    float y[4];
    bool all_fast = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      y[k] = markstein(e[k]);
      all_fast &= fast(e[k]);
    }
    if (!all_fast) {   // the guard is the float4's: all four divide
#pragma unroll
      for (int k = 0; k < 4; ++k) y[k] = __fdiv_rn(e[k], s);
    }
    bool normal = true;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      normal &= (fabsf(y[k]) >= MIN_NORMAL) | (y[k] == 0.0f);
    const uint32_t i0 = static_cast<uint32_t>(i);
    uint32_t b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t h = mix(i0 + k);
      b[k] = normal ? code_normal(y[k], h) : code_any(y[k], h);
    }
    return __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                       __byte_perm(b[2], b[3], 0x0040), 0x5410);
  }
};

template <int MANT, int EMIN, bool kAlignedStore>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fp8_sr_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
              long long n, int head, long long vecs,
              Fp8Codes<MANT, EMIN> codes) {
  stream_codes<kVecs, kAlignedStore>(x, q, n, head, vecs, codes);
}

template <int MANT, int EMIN>
void launch(const float* x, uint8_t* q, long long n, int head,
            long long vecs, int grid, Fp8Codes<MANT, EMIN> codes,
            cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(q + head) % 4 == 0)
    fp8_sr_kernel<MANT, EMIN, true><<<grid, kThreads, 0, st>>>(
        x, q, n, head, vecs, codes);
  else
    fp8_sr_kernel<MANT, EMIN, false><<<grid, kThreads, 0, st>>>(
        x, q, n, head, vecs, codes);
}

}  // namespace

// kind 0 = E4M3, 1 = E5M2 (ops/compression/fp8sr.py's ids). Launches on
// `stream`, allocates nothing (`q` holds n bytes); returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown kind, a plan
// that does not cover [0, n) as head (< 4 elements), vecs float4s from
// x + head (16-byte aligned) and a tail (< 4), or no CTA.
extern "C" int bps_fp8_sr_quantize_planned(const void* x, void* q,
                                           long long n, int head,
                                           long long vecs, int grid,
                                           float scale, unsigned int seed,
                                           int kind, void* stream) {
  const float* xf = static_cast<const float*>(x);
  uint8_t* qb = static_cast<uint8_t*>(q);
  const long long tail = n - head - 4 * vecs;
  if (n <= 0 || (kind != 0 && kind != 1) || head < 0 || head > 3 ||
      vecs < 0 || tail < 0 || tail > 3 || grid <= 0 ||
      (vecs > 0 && reinterpret_cast<uintptr_t>(xf + head) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const float s = scale > 0.0f ? scale : 1.0f;
  float r = 1.0f / s;   // correctly rounded on the host too
  // the guard's bounds (exact: s · 2^k is a float wherever it is taken)
  float lo = static_cast<float>(
      std::max(std::ldexp(1.0, -100), std::ldexp(static_cast<double>(s), -99)));
  float hi = static_cast<float>(std::min(
      std::ldexp(static_cast<double>(s), 124), static_cast<double>(FLT_MAX)));
  if (!std::isnormal(r)) {   // every element but ±0 divides; ±0 · 1 is ±0
    r = 1.0f;
    lo = INFINITY;
    hi = 0.0f;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    launch<3, 121>(xf, qb, n, head, vecs, grid,
                   {s, r, lo, hi, 448.0f, seed}, st);
  else
    launch<2, 113>(xf, qb, n, head, vecs, grid,
                   {s, r, lo, hi, 57344.0f, seed}, st);
  return static_cast<int>(cudaGetLastError());
}
