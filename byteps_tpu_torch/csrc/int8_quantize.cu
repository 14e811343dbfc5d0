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
// x may be a view at any 4-byte offset (a single-leaf bucket without error
// feedback), so the plan peels `head` (< 4) elements to reach a 16-byte
// boundary. The codes then start at q + head, aligned only to head bytes:
// that case takes the kAlignedStore = false instance, whose warp regathers
// its 128 codes by shuffles and writes them as 4 byte stores of 32
// contiguous bytes each. The `tail` (< 4) elements past the vectors and the
// head are read one by one by CTA 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;   // resident CTAs a SM (kernels.py::CTAS_PER_SM)
constexpr int kVecs = 4;        // float4 loads a thread, all in flight

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

template <bool kAlignedStore>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
int8_quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     long long n, int head, long long vecs, float s,
                     float r, bool recip) {
  const int t = threadIdx.x;
  if (blockIdx.x == 0) {               // the head and the tail, one by one
    const long long end = head + 4 * vecs;
    if (t < head) {
      q[t] = static_cast<int8_t>(code(x[t], s));
    } else if (t >= 4 && end + (t - 4) < n) {
      q[end + t - 4] = static_cast<int8_t>(code(x[end + t - 4], s));
    }
  }
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  int8_t* qb = q + head;
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
      float gap = 1.0f;
      uint32_t c = recip ? codes4_recip(v[j], r, gap) : 0u;
      if (!(gap > 0.0f) || !recip) c = codes4(v[j], s);
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
                static_cast<int8_t>(word >> (8 * (lane & 3)));
        }
      }
    }
  }
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
  const bool recip = std::isnormal(r);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(qb + head) % 4 == 0)
    int8_quantize_kernel<true><<<grid, kThreads, 0, st>>>(
        xf, qb, n, head, vecs, s, r, recip);
  else
    int8_quantize_kernel<false><<<grid, kThreads, 0, st>>>(
        xf, qb, n, head, vecs, s, r, recip);
  return static_cast<int>(cudaGetLastError());
}
