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
// What bounds it on an H100: 4 bytes read and 1 written per element, about
// forty integer operations: device memory still (at 3.35 TB/s the bytes
// take longer than the operations at the CUDA cores' integer rate). One
// element per thread, coalesced, the tail masked; the flat index is the
// thread's element index, so no padded tile layout enters the noise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int MANT, int EMIN>
__global__ void __launch_bounds__(kThreads)
fp8_sr_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
              long long n, float s, float mx, uint32_t seed) {
  constexpr int BASE = 23 - MANT;
  constexpr int E_SUB = EMIN - MANT;
  constexpr uint32_t QBITS = static_cast<uint32_t>(E_SUB) << 23;
  // 2^(127 - e_sub): |y| / quantum for the subnormal branch (exact)
  constexpr float T_SCALE = static_cast<float>(1u << (127 - E_SUB));
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  float y = __fdiv_rn(x[i], s);
  // numpy's clip, which keeps a NaN (fminf / fmaxf would drop it). NaN
  // inputs are outside the contract all the same: the card's division
  // returns its one canonical NaN, numpy keeps the input's bits.
  y = y < -mx ? -mx : (y > mx ? mx : y);
  const uint32_t bits = __float_as_uint(y);
  const uint32_t sign = bits >> 31;
  const uint32_t mag = bits & 0x7FFFFFFFu;
  const int e = static_cast<int>(mag >> 23);

  uint32_t h = (static_cast<uint32_t>(i) * 0x9E3779B9u) ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;

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
  q[i] = static_cast<uint8_t>((sign << 7) | out);
}

}  // namespace

// kind 0 = E4M3, 1 = E5M2 (ops/compression/fp8sr.py's ids). Launches on
// `stream`, allocates nothing (`q` holds n bytes); returns
// cudaGetLastError().
extern "C" int bps_fp8_sr_quantize(const void* x, void* q, long long n,
                                   float scale, unsigned int seed, int kind,
                                   void* stream) {
  if (n <= 0 || (kind != 0 && kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const float s = scale > 0.0f ? scale : 1.0f;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  auto* qb = static_cast<uint8_t*>(q);
  if (kind == 0)
    fp8_sr_kernel<3, 121><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        xf, qb, n, s, 448.0f, seed);
  else
    fp8_sr_kernel<2, 113><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        xf, qb, n, s, 57344.0f, seed);
  return static_cast<int>(cudaGetLastError());
}
