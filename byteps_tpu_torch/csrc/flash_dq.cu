// dq of the split flash-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// byteps_tpu/ops/flash_attention.py::_dq_kernel (wrapper _flash_bwd,
// pallas_call at :646) in its three forms: no bias, which the backward
// takes when a sequence spans more than one 512 block (GPT-2 at seq 1024,
// T5's cross-attention over a 1024-token source); the additive bias with
// its dbias output (:362-367, :400-401, summed over batch at :659-661);
// and T5's in-kernel relative-position table with its dtable output
// (:353-358, :403, :415-418, :662-665), the route every biased call takes.
//
// Contract (the Pallas kernel's): P = exp(q·kᵀ·scale (+ B) - lse), zeroed
// where row < col under causal masking; dP = dO·vᵀ; dS = P∘(dP - delta)
// cast to bf16 with delta GIVEN (rowsum(dO∘out), taken by the caller from
// the forward's bf16 output); dq = dS·k·scale accumulated in fp32, stored
// as bf16. dbias = Σ_b dS and dtable = Σ dS over each bucket's positions,
// both from the fp32 dS.
//
// What bounds it on an H100: three s×s×d products per (batch, head)
// (S, dP, dS·K) against five [s, d] bf16 tensors moved; at seq 1024, d 64
// that is far above the card's ~295 FLOP/byte ridge, so tensor-core
// throughput bounds it. The dense bias moves 4 bytes per score in and 4
// per (batch, score) out, which makes that form bound by memory. The
// table form adds the per-bucket reduction of dS: up to ~30 buckets per
// tile near the diagonal, one or a few far from it. The design is the
// fused backward's first launch without its delta pass
// (flash_bwd_dq.cuh): one CTA per (batch, head, 64-query tile) walks the
// key tiles once, fed by TMA through a ring of tiles, keeps S, P, dP and
// dS in registers, and accumulates dq there on the tensor cores (wgmma);
// no atomics, no [s, s] buffer but the dense form's dbias output. Head dim
// 64 or 128 (the register plan of each is in flash_bwd_dq.cuh).
#include "flash_bwd_dq.cuh"

// Launches on `stream`, allocates nothing (dq is [b, sq, h, d] contiguous;
// lse and delta are [b, h, sq] fp32); returns a cudaError_t (the tensor
// maps' encoding, then cudaGetLastError()). `form` and the bias arguments
// as in bps_flash_fwd; `grad` is the dense form's [b, h, sq, sk] fp32 dS
// or the table form's [b, h, sq / 64, nb] fp32 partials, null without a
// bias.
extern "C" int bps_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int b, int h, int sq,
                            int sk, int d, long long q_sb, long long q_ss,
                            long long k_sb, long long k_ss, long long v_sb,
                            long long v_ss, long long do_sb, long long do_ss,
                            float scale, int causal, int form,
                            const void* bias, const void* bucket,
                            const void* table, int nb, void* grad,
                            void* stream) {
  if (sq % kTile != 0 || sk % kTile != 0 || b <= 0 || h <= 0 ||
      !bias_args_ok(form, bias, bucket, table, nb) ||
      (form != kBiasNone && grad == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BiasArgs ba = bias_args(bias, bucket, table, nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_d(d, [&](auto D) {
    constexpr int kD = decltype(D)::value;
    QkvoMaps m;
    const cudaError_t err = encode_qkvo(
        m, q, k, v, dout, b, h, sq, sk, kD, {q_sb, q_ss}, {k_sb, k_ss},
        {v_sb, v_ss}, {do_sb, do_ss});
    if (err != cudaSuccess) return err;
    return with_form(form, [&](auto F) {
      // read only: the kDeltaIn kernel never writes delta
      return launch_dq<true, kD, decltype(F)::value>(
          m, lse, const_cast<void*>(delta), dq, b, h, sq, sk, scale, causal,
          ba, grad, st);
    });
  }));
}

// The dynamic shared memory a launch of `kernel` (0 the forward, 1 dq, 2
// dk/dv) asks for at head dim d in bias form `form`, for the kernels this
// library holds; -1 for the others.
extern "C" int bps_flash_smem(int kernel, int d, int form) {
  return kernel == 1 ? layout_bytes<DqSmem>(d, form) : -1;
}
