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
// key tiles once, keeps S, P, dP and dS in registers, and accumulates dq
// there; no atomics, no [s, s] buffer but the dense form's dbias output.
// Head dim 64 or 128 (the register plan of each is in flash_bwd_dq.cuh).
#include "flash_bwd_dq.cuh"

namespace {

template <int kD, int kForm>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int b, int h, int sq, int sk, BshdStrides qs,
                   BshdStrides ks, BshdStrides vs, BshdStrides dos,
                   float scale, int causal, const BiasArgs& ba, void* grad,
                   cudaStream_t stream) {
  constexpr int kSmem = sizeof(DqSmem<kD, kForm>);
  const cudaError_t attr =
      smem_attr(flash_bwd_dq_kernel<true, kD, kForm>, kSmem);
  if (attr != cudaSuccess) return attr;
  const long long row = static_cast<long long>(h) * kD;
  flash_bwd_dq_kernel<true, kD, kForm>
      <<<dim3(sq / kTile, h, b), kThreads, kSmem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse),
          const_cast<float*>(static_cast<const float*>(delta)),  // read only
          static_cast<bf16*>(dq), h, sq, sk, qs, ks, vs, dos,
          BshdStrides{sq * row, row}, scale, causal, ba,
          static_cast<float*>(grad));
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, allocates nothing (dq is [b, sq, h, d] contiguous;
// lse and delta are [b, h, sq] fp32); returns cudaGetLastError(). `form`
// and the bias arguments as in bps_flash_fwd; `grad` is the dense form's
// [b, h, sq, sk] fp32 dS or the table form's [b, h, sq / 64, nb] fp32
// partials, null without a bias.
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
  const BshdStrides qs{q_sb, q_ss}, ks{k_sb, k_ss}, vs{v_sb, v_ss},
      dos{do_sb, do_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_d(d, [&](auto D) {
    return with_form(form, [&](auto F) {
      return launch<decltype(D)::value, decltype(F)::value>(
          q, k, v, dout, lse, delta, dq, b, h, sq, sk, qs, ks, vs, dos, scale,
          causal, ba, grad, st);
    });
  }));
}
