// dq of the flash-attention backward for Hopper (sm_90a): one CTA per
// (batch, head, 64-query tile) walks the key tiles and accumulates
// dq = Σ_k dS·K·scale in registers, dS = P∘(dP - delta) rounded to bf16.
//
// Shared by two entry points:
//   - flash_bwd.cu (the fused backward, no `out` input): kDeltaIn = false,
//     the CTA first walks its key tiles once for delta = rowsum(P∘dP) over
//     the whole key row and writes it to the caller's [b, h, sq] scratch,
//     where the dk/dv launch reads it;
//   - flash_dq.cu (the split backward's `_dq_kernel`): kDeltaIn = true,
//     delta is read from its input, computed by the caller from the
//     forward's output as rowsum(dO∘out).
// S and dP are recomputed on the tensor cores (mma.sync.m16n8k16, bf16 x
// bf16 -> fp32) and never reach device memory; key tiles above the
// diagonal are skipped under causal masking.
#pragma once

#include "mma_bf16.cuh"

namespace {

template <bool kDeltaIn>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int h, int sq, int sk,
                    BshdStrides qs, BshdStrides ks, BshdStrides vs,
                    BshdStrides dos, BshdStrides dqs, float scale,
                    int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kLD];
  __shared__ __align__(16) bf16 sO[kTile * kLD];
  __shared__ __align__(16) bf16 sK[kTile * kLD];
  __shared__ __align__(16) bf16 sV[kTile * kLD];

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile(sQ, q + bb * qs.b + q0 * qs.s + hh * kD, qs.s, tid);
  load_tile(sO, dout + bb * dos.b + q0 * dos.s + hh * kD, dos.s, tid);
  __syncthreads();
  uint32_t qf[kD / 16][4], of[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    load_a(qf[kk], sQ, warp * 16, kk * 16, g, t);
    load_a(of[kk], sO, warp * 16, kk * 16, g, t);
  }
  const long long head_row = ((long long)bb * h + hh) * sq;
  const float lse_r[2] = {lse[head_row + row[0]], lse[head_row + row[1]]};

  int nkt = sk / kTile;
  if (causal) nkt = min(nkt, (q0 + kTile - 1) / kTile + 1);

  float s[kTile / 8][4], dp[kTile / 8][4];
  // S and dP of key tile kt for this warp's 16 rows; P = exp(S - lse)
  // replaces S in place, masked entries 0.
  auto scores = [&](int kt) {
    __syncthreads();
    load_tile(sK, k + bb * ks.b + (long long)kt * kTile * ks.s + hh * kD, ks.s, tid);
    load_tile(sV, v + bb * vs.b + (long long)kt * kTile * vs.s + hh * kD, vs.s, tid);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b[2];
        load_b_nk(b, sK, n * 8, kk * 16, g, t);
        mma16816(s[n], qf[kk], b);
        load_b_nk(b, sV, n * 8, kk * 16, g, t);
        mma16816(dp[n], of[kk], b);
      }
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int col = kt * kTile + n * 8 + 2 * t + (i & 1);
        float p = expf(s[n][i] * scale - lse_r[r]);
        if (causal && row[r] < col) p = 0.f;
        s[n][i] = p;
      }
    }
  };

  float dl[2];
  if (kDeltaIn) {
    dl[0] = delta[head_row + row[0]];
    dl[1] = delta[head_row + row[1]];
  } else {
    float dsum[2] = {0.f, 0.f};
    for (int kt = 0; kt < nkt; ++kt) {
      scores(kt);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dsum[i >> 1] += s[n][i] * dp[n][i];
      }
    }
    dl[0] = quad_sum(dsum[0]);
    dl[1] = quad_sum(dsum[1]);
    if (t == 0) {
      delta[head_row + row[0]] = dl[0];
      delta[head_row + row[1]] = dl[1];
    }
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    scores(kt);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] *= dp[n][i] - dl[i >> 1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        uint32_t b[2];
        load_b_kn(b, sK, kk * 16, n * 8, g, t);
        mma16816(acc[n], da, b);
      }
    }
  }

  bf16* gp = dq + bb * dqs.b + hh * kD;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(gp + row[0] * dqs.s + col) =
        pack_f32(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(gp + row[1] * dqs.s + col) =
        pack_f32(acc[n][2] * scale, acc[n][3] * scale);
  }
}

}  // namespace
