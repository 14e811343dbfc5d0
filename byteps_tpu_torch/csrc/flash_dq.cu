// dq of the split flash-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// byteps_tpu/ops/flash_attention.py::_dq_kernel (wrapper _flash_bwd, no-bias
// form, pallas_call at :646), which the backward takes when a sequence
// spans more than one 512 block (GPT-2 at seq 1024).
//
// Contract (the Pallas kernel's): P = exp(q·kᵀ·scale - lse), zeroed where
// row < col under causal masking; dP = dO·vᵀ; dS = P∘(dP - delta) cast to
// bf16 with delta GIVEN (rowsum(dO∘out), taken by the caller from the
// forward's bf16 output); dq = dS·k·scale accumulated in fp32, stored as
// bf16.
//
// What bounds it on an H100: three s×s×d products per (batch, head)
// (S, dP, dS·K) against five [s, d] bf16 tensors moved; at seq 1024, d 64
// that is far above the card's ~295 FLOP/byte ridge, so tensor-core
// throughput bounds it. The design is the fused backward's first launch
// without its delta pass (flash_bwd_dq.cuh): one CTA per (batch, head,
// 64-query tile) walks the key tiles once, keeps S, P, dP and dS in
// registers, and accumulates dq there; no atomics, no [s, s] buffer.
#include "flash_bwd_dq.cuh"

// Launches on `stream`, allocates nothing (dq is [b, sq, h, d] contiguous;
// lse and delta are [b, h, sq] fp32); returns cudaGetLastError().
extern "C" int bps_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int b, int h, int sq,
                            int sk, int d, long long q_sb, long long q_ss,
                            long long k_sb, long long k_ss, long long v_sb,
                            long long v_ss, long long do_sb, long long do_ss,
                            float scale, int causal, void* stream) {
  if (d != kD || sq % kTile != 0 || sk % kTile != 0 || b <= 0 || h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row = static_cast<long long>(h) * kD;
  flash_bwd_dq_kernel<true><<<dim3(sq / kTile, h, b), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse),
      const_cast<float*>(static_cast<const float*>(delta)),  // read only
      static_cast<bf16*>(dq), h, sq, sk, BshdStrides{q_sb, q_ss},
      BshdStrides{k_sb, k_ss}, BshdStrides{v_sb, v_ss},
      BshdStrides{do_sb, do_ss}, BshdStrides{sq * row, row}, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
