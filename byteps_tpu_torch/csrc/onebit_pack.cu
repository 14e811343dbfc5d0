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
// per 32 floats, a handful of integer operations per byte moved: device
// memory bounds it, and a bucket of the default 4,096,000 bytes is smaller
// than the cost of a launch. The design reads each float once, coalesced
// (a warp reads 32 neighbouring floats, 128 bytes), and builds the word in
// one warp vote: __ballot_sync sets bit `lane` for each lane whose element
// is negative, and __brev turns lane 0 into the top bit. Lanes past n vote
// 0, as the zero pad does.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
onebit_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                   long long n, long long nwords) {
  const long long word = (static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = word * 32 + lane;
  const bool neg = i < n && x[i] <= -FLT_MIN;
  // every lane of the warp votes, in range or not (the grid is whole warps)
  const uint32_t bits = __ballot_sync(0xffffffffu, neg);
  if (lane == 0 && word < nwords) words[word] = __brev(bits);
}

}  // namespace

// Launches on `stream`, allocates nothing (`words` holds ceil(n / 32)
// 32-bit words); returns cudaGetLastError().
extern "C" int bps_onebit_pack(const void* x, void* words, long long n,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nwords = (n + 31) / 32;
  const long long blocks = (nwords * 32 + kThreads - 1) / kThreads;
  onebit_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint32_t*>(words), n, nwords);
  return static_cast<int>(cudaGetLastError());
}
