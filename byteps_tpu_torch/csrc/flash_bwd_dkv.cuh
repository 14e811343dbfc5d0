// dk and dv of the flash-attention backward for Hopper (sm_90a): one CTA
// per (batch, head, 64-key tile) walks the query tiles and accumulates
// dk = Σ_q dSᵀ·Q·scale and dv = Σ_q bf16(P)ᵀ·dO in registers, reading lse
// and delta ([b, h, sq] fp32) from its inputs. Query tiles wholly above
// the diagonal are skipped under causal masking.
//
// Rows of every product are keys: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so Pᵀ and dSᵀ
// come out of the tensor cores already in the A layout of dv += Pᵀ·dO and
// dk += dSᵀ·Q, and never touch shared or device memory.
//
// Shared by flash_bwd.cu (the fused backward's second launch, delta from
// its first) and flash_dkv.cu (the split backward's `_dkv_kernel`, delta
// from the caller).
//
// kForm is the bias source (flash_bias.cuh; the fused backward takes no
// bias). Because the fragments are transposed, the bias of fragment row
// `key` and column `query` is the offset key - query's (the table form's
// strip entry kl - ql + 63, as in the forward) and the dense form reads
// bias[h, query, key]: the column, not the row, picks the bias row.
#pragma once

#include "flash_bias.cuh"

namespace {

template <int kForm>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int h, int sq, int sk,
                     BshdStrides qs, BshdStrides ks, BshdStrides vs,
                     BshdStrides dos, BshdStrides dks, float scale,
                     int causal, BiasArgs ba) {
  __shared__ __align__(16) bf16 sK[kTile * kLD];
  __shared__ __align__(16) bf16 sV[kTile * kLD];
  __shared__ __align__(16) bf16 sQ[kTile * kLD];
  __shared__ __align__(16) bf16 sO[kTile * kLD];
  __shared__ float sL[kTile], sDl[kTile];
  __shared__ BiasSmem<kForm> sb;

  const int kt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kTile;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  load_tile(sK, k + bb * ks.b + k0 * ks.s + hh * kD, ks.s, tid);
  load_tile(sV, v + bb * vs.b + k0 * vs.s + hh * kD, vs.s, tid);
  load_table_row<kForm>(sb, ba, hh, tid);
  __syncthreads();
  uint32_t kf[kD / 16][4], vf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    load_a(kf[kk], sK, warp * 16, kk * 16, g, t);
    load_a(vf[kk], sV, warp * 16, kk * 16, g, t);
  }
  const float* lp = lse + ((long long)bb * h + hh) * sq;
  const float* dlp = delta + ((long long)bb * h + hh) * sq;
  const float* dense = dense_head<kForm>(ba, hh, sq, sk);

  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  const int nqt = sq / kTile;
  for (int qt = causal ? k0 / kTile : 0; qt < nqt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile(sQ, q + bb * qs.b + q0 * qs.s + hh * kD, qs.s, tid);
    load_tile(sO, dout + bb * dos.b + q0 * dos.s + hh * kD, dos.s, tid);
    if (tid < kTile) {
      sL[tid] = lp[q0 + tid];
      sDl[tid] = dlp[q0 + tid];
    }
    load_strip<kForm>(sb, ba, q0, k0, sq, tid);
    __syncthreads();

    float st[kTile / 8][4], dpt[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b[2];
        load_b_nk(b, sQ, n * 8, kk * 16, g, t);
        mma16816(st[n], kf[kk], b);
        load_b_nk(b, sO, n * 8, kk * 16, g, t);
        mma16816(dpt[n], vf[kk], b);
      }
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = n * 8 + 2 * t + (i & 1);
        float p;
        if constexpr (kForm == kBiasNone) {
          p = expf(st[n][i] * scale - sL[qi]);
        } else {
          p = expf(biased(st[n][i], scale,
                          bias_at<kForm>(sb, dense, sk, q0 + qi,
                                         key[i >> 1], qi,
                                         key[i >> 1] - k0)) -
                   sL[qi]);
        }
        if (causal && q0 + qi < key[i >> 1]) p = 0.f;
        st[n][i] = p;
        dpt[n][i] = p * (dpt[n][i] - sDl[qi]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      c_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        uint32_t b[2];
        load_b_kn(b, sO, kk * 16, n * 8, g, t);
        mma16816(dva[n], pa, b);
        load_b_kn(b, sQ, kk * 16, n * 8, g, t);
        mma16816(dka[n], da, b);
      }
    }
  }

  bf16* kp = dk + bb * dks.b + hh * kD;
  bf16* vp = dv + bb * dks.b + hh * kD;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<uint32_t*>(kp + key[r] * dks.s + col) =
          pack_f32(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(vp + key[r] * dks.s + col) =
          pack_f32(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

}  // namespace
