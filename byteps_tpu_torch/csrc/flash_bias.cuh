// Bias sources of the attention kernels (forward, dq, dk/dv): the Pallas
// kernels' `has_bias` and `rel` forms, chosen at compile time.
//
//   kBiasNone   S = q·kᵀ·scale (BERT, GPT-2, T5's cross-attention); the
//               code is the same as before these forms existed.
//   kBiasDense  S = q·kᵀ·scale + bias[h, q, k], an fp32 [h, sq, sk] tensor
//               read from device memory per score.
//   kBiasTable  S = q·kᵀ·scale + table[h, bucket(k - q)], T5's relative
//               position bias. The head's table row (nb <= 128 floats)
//               sits in shared memory. The bucket of each offset comes
//               from an int vector over the sq + sk - 1 offsets, computed
//               on the host in float32 exactly as the JAX package does, so
//               the kernel takes no logarithm (a device logf one ulp low
//               at |n| = 16, 32, 64 would move an offset one bucket down).
//               A 64x64 tile spans 127 offsets: per tile the kernel
//               gathers their buckets and table values into a strip in
//               shared memory, and each score reads strip[kl - ql + 63].
//               On the TPU the same bias took a 32-way select-sum per
//               block; here it is one shared-memory read.
//
// The sum is rounded after the product and again after the addition
// (__fmul_rn, __fadd_rn: never one fused multiply-add), as the plain
// versions and the Pallas kernels compute it, so the dense and the table
// forms given the same bias values run the same arithmetic.
#pragma once

#include "hopper.cuh"

enum BiasForm : int { kBiasNone = 0, kBiasDense = 1, kBiasTable = 2 };
constexpr int kMaxBuckets = 128;
constexpr int kStrip = 2 * kTile - 1;  // offsets one kTile x kTile tile spans

struct BiasArgs {
  const float* dense;  // [h, sq, sk] fp32 (dense form)
  const int* bucket;   // [sq + sk - 1]: the bucket of offset key - query
                       // at index offset + sq - 1 (table form)
  const float* table;  // [h, nb] fp32 (table form)
  int nb;
};

template <int kForm>
struct BiasSmem {};

template <>
struct BiasSmem<kBiasTable> {
  float tab[kMaxBuckets];  // this head's table row
  float strip[kStrip + 1];  // this tile's bias, by offset
  int bucket[kStrip + 1];  // this tile's bucket, by offset
};

// Stage head hh's table row (consumer threads); before the consumers'
// first consumer_sync.
template <int kForm>
__device__ __forceinline__ void load_table_row(BiasSmem<kForm>& sb,
                                               const BiasArgs& ba, int hh,
                                               int tid) {
  if constexpr (kForm == kBiasTable) {
    for (int i = tid; i < ba.nb; i += kConsumers)
      sb.tab[i] = ba.table[static_cast<long long>(hh) * ba.nb + i];
  }
}

// The strip of the tile whose queries start at q0 and keys at k0:
// entry j is offset (k0 - q0) + j - (kTile - 1). Written by the consumer
// threads between two consumer_syncs (strip_for below).
template <int kForm>
__device__ __forceinline__ void load_strip(BiasSmem<kForm>& sb,
                                           const BiasArgs& ba, int q0, int k0,
                                           int sq, int tid) {
  if constexpr (kForm == kBiasTable) {
    for (int j = tid; j < kStrip; j += kConsumers) {
      const int b = ba.bucket[k0 - q0 + j - (kTile - 1) + sq - 1];
      sb.bucket[j] = b;
      sb.strip[j] = sb.tab[b];
    }
  }
}

// The table form's strip for the tile (q0, k0), fenced so that no
// consumer still reads the previous tile's; nothing in the other forms.
template <int kForm>
__device__ __forceinline__ void strip_for(BiasSmem<kForm>& sb,
                                          const BiasArgs& ba, int q0, int k0,
                                          int sq, int tid) {
  if constexpr (kForm == kBiasTable) {
    consumer_sync();
    load_strip<kForm>(sb, ba, q0, k0, sq, tid);
    consumer_sync();
  }
}

// The head's [sq, sk] slice of the dense bias (dense form), else null.
template <int kForm>
__device__ __forceinline__ const float* dense_head(const BiasArgs& ba, int hh,
                                                   int sq, int sk) {
  if constexpr (kForm == kBiasDense)
    return ba.dense + static_cast<long long>(hh) * sq * sk;
  return nullptr;
}

// The bias of the score of (query qg, key kg), which sit at ql and kl in
// their tiles. The dense bias is always indexed [query][key], whichever
// of the two the caller's fragment rows are.
template <int kForm>
__device__ __forceinline__ float bias_at(const BiasSmem<kForm>& sb,
                                         const float* dense, int sk, int qg,
                                         int kg, int ql, int kl) {
  if constexpr (kForm == kBiasDense) {
    return dense[static_cast<long long>(qg) * sk + kg];
  } else if constexpr (kForm == kBiasTable) {
    return sb.strip[kl - ql + kTile - 1];
  }
  return 0.f;
}

// q·kᵀ·scale + B with two roundings.
__device__ __forceinline__ float biased(float s, float scale, float b) {
  return __fadd_rn(__fmul_rn(s, scale), b);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Whether an entry point's bias arguments fit `form`.
inline bool bias_args_ok(int form, const void* bias, const void* bucket,
                         const void* table, int nb) {
  switch (form) {
    case kBiasNone:
      return true;
    case kBiasDense:
      return bias != nullptr;
    case kBiasTable:
      return bucket != nullptr && table != nullptr && nb >= 1 &&
             nb <= kMaxBuckets;
    default:
      return false;
  }
}

// Call f(std::integral_constant<int, form>) for a bias form, or return
// cudaErrorInvalidValue.
template <typename F>
inline cudaError_t with_form(int form, F&& f) {
  switch (form) {
    case kBiasNone:
      return f(std::integral_constant<int, kBiasNone>{});
    case kBiasDense:
      return f(std::integral_constant<int, kBiasDense>{});
    case kBiasTable:
      return f(std::integral_constant<int, kBiasTable>{});
    default:
      return cudaErrorInvalidValue;
  }
}

inline BiasArgs bias_args(const void* bias, const void* bucket,
                          const void* table, int nb) {
  return BiasArgs{static_cast<const float*>(bias),
                  static_cast<const int*>(bucket),
                  static_cast<const float*>(table), nb};
}

// The bytes of dynamic shared memory a launch of a kernel whose layout is
// Layout<kD, kForm> asks for, at head dim d in bias form `form`; -1 for a
// width or form with no instantiation.
template <template <int, int> class Layout>
inline int layout_bytes(int d, int form) {
  int bytes = -1;
  with_d(d, [&](auto D) {
    return with_form(form, [&](auto F) {
      bytes = smem_bytes<Layout<decltype(D)::value, decltype(F)::value>>;
      return cudaSuccess;
    });
  });
  return bytes;
}
