// dq of the flash-attention backward for Hopper (sm_90a): one CTA per
// (batch, head, 64-query tile) walks the key tiles and accumulates
// dq = Σ_k dS·K·scale in registers, dS = P∘(dP - delta) rounded to bf16.
//
// Shared by two entry points:
//   - flash_bwd.cu (the fused backward, no `out` input): kDeltaIn = false,
//     the CTA first walks its key tiles once for delta = rowsum(P∘dP) over
//     the whole key row and writes it to the caller's [b, h, sq] scratch,
//     where the dk/dv launch reads it;
//   - flash_dq.cu (the split backward's `_dq_kernel`), and flash_bwd.cu
//     when its caller gives delta (ring attention): kDeltaIn = true,
//     delta is read from its input, computed by the caller from the
//     forward's output as rowsum(dO∘out).
// S and dP are recomputed on the tensor cores (mma.sync.m16n8k16, bf16 x
// bf16 -> fp32) and never reach device memory; key tiles above the
// diagonal are skipped under causal masking.
//
// kForm is the bias source (flash_bias.cuh; the fused backward takes no
// bias). With a bias, the gradient of the scores' addend comes out too,
// from the fp32 dS before its bf16 rounding:
//   - dense: dS of every (b, h, q, k) to `grad` [b, h, sq, sk] fp32, the
//     causally skipped key tiles written as 0 (the caller sums over b);
//   - table: dS summed by bucket into one row of `grad` [b, h, sq / kTile,
//     nb] fp32 per CTA (the caller sums the rows). Each warp walks the
//     buckets its 16 x 64 scores of a tile cover, sums each with a shuffle
//     butterfly and adds it to its own shared-memory row; the four rows
//     are added in a fixed order at the end. No atomics: the same inputs
//     give the same bits.
//
// Head dim kD is a template parameter (64 and 128). The Q, dO, K and V
// tiles sit in dynamic shared memory, 4 · 64 · (kD + 8) · 2 bytes: 36,864
// at d 64, 69,632 at d 128 (plus the table form's strip and partials).
// Register plan: a warp's dq accumulator (kD / 2 fp32) and its S and dP
// tiles (64 fp32) are live across the whole key walk. At d 64 the warp
// also holds its Q and dO A fragments (kD / 4 registers each); at d 128
// those would bring the count past 255, so they are re-read from the Q
// and dO tiles, which stay in shared memory, at each product (AFrags).
#pragma once

#include <climits>

#include "flash_bias.cuh"

namespace {

template <int kForm>
struct DtableSmem {};

template <>
struct DtableSmem<kBiasTable> {
  float dt[kThreads / 32][kMaxBuckets];  // per-warp partial dtable
};

template <int kD, int kForm>
struct DqSmem {
  bf16 q[kTileElems<kD>];
  bf16 o[kTileElems<kD>];
  bf16 k[kTileElems<kD>];
  bf16 v[kTileElems<kD>];
  BiasSmem<kForm> sb;
  DtableSmem<kForm> sdt;
};
static_assert(sizeof(DqSmem<64, kBiasNone>) == 36866 &&
                  sizeof(DqSmem<64, kBiasTable>) == 40448 &&
                  sizeof(DqSmem<128, kBiasNone>) == 69634 &&
                  sizeof(DqSmem<128, kBiasTable>) == 73216,
              "dq's dynamic shared memory at d 64 and d 128");

template <bool kDeltaIn, int kD, int kForm>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int h, int sq, int sk,
                    BshdStrides qs, BshdStrides ks, BshdStrides vs,
                    BshdStrides dos, BshdStrides dqs, float scale,
                    int causal, BiasArgs ba, float* __restrict__ grad) {
  auto& sm = dyn_smem<DqSmem<kD, kForm>>();
  bf16* sQ = sm.q;
  bf16* sO = sm.o;
  bf16* sK = sm.k;
  bf16* sV = sm.v;
  BiasSmem<kForm>& sb = sm.sb;
  DtableSmem<kForm>& sdt = sm.sdt;

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<kD>(sQ, q + bb * qs.b + q0 * qs.s + hh * kD, qs.s, tid);
  load_tile<kD>(sO, dout + bb * dos.b + q0 * dos.s + hh * kD, dos.s, tid);
  load_table_row<kForm>(sb, ba, hh, tid);
  if constexpr (kForm == kBiasTable) {
    for (int i = tid; i < (kThreads / 32) * kMaxBuckets; i += kThreads)
      (&sdt.dt[0][0])[i] = 0.f;
  }
  __syncthreads();
  constexpr bool kHold = kD <= 64;
  const AFrags<kD, kHold> qf(sQ, warp * 16, g, t);
  const AFrags<kD, kHold> of(sO, warp * 16, g, t);
  const long long head_row = ((long long)bb * h + hh) * sq;
  const float lse_r[2] = {lse[head_row + row[0]], lse[head_row + row[1]]};

  int nkt = sk / kTile;
  if (causal) nkt = min(nkt, (q0 + kTile - 1) / kTile + 1);
  const float* dense = dense_head<kForm>(ba, hh, sq, sk);

  float s[kTile / 8][4], dp[kTile / 8][4];
  // S and dP of key tile kt for this warp's 16 rows; P = exp(S - lse)
  // replaces S in place, masked entries 0.
  auto scores = [&](int kt) {
    __syncthreads();
    load_tile<kD>(sK, k + bb * ks.b + (long long)kt * kTile * ks.s + hh * kD,
                  ks.s, tid);
    load_tile<kD>(sV, v + bb * vs.b + (long long)kt * kTile * vs.s + hh * kD,
                  vs.s, tid);
    load_strip<kForm>(sb, ba, q0, kt * kTile, sq, tid);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qa[4], oa[4];
      qf.get(qa, kk);
      of.get(oa, kk);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b[2];
        load_b_nk<kD>(b, sK, n * 8, kk * 16, g, t);
        mma16816(s[n], qa, b);
        load_b_nk<kD>(b, sV, n * 8, kk * 16, g, t);
        mma16816(dp[n], oa, b);
      }
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int col = kt * kTile + n * 8 + 2 * t + (i & 1);
        float p;
        if constexpr (kForm == kBiasNone) {
          p = expf(s[n][i] * scale - lse_r[r]);
        } else {
          p = expf(biased(s[n][i], scale,
                          bias_at<kForm>(sb, dense, sk, row[r], col,
                                         row[r] - q0, col - kt * kTile)) -
                   lse_r[r]);
        }
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
    if constexpr (kForm == kBiasDense) {
      float* gp = grad + (((long long)bb * h + hh) * sq) * sk + kt * kTile;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const int col = n * 8 + 2 * t;
        *reinterpret_cast<float2*>(gp + (long long)row[0] * sk + col) =
            make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(gp + (long long)row[1] * sk + col) =
            make_float2(s[n][2], s[n][3]);
      }
    }
    if constexpr (kForm == kBiasTable) {
      // strip index of element (n, i): its key's and query's local offset
      const int j0 = 2 * t - (warp * 16 + g) + kTile - 1;
      int lo = INT_MAX, hi = -1;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int bk = sb.bucket[j0 + n * 8 + (i & 1) - 8 * (i >> 1)];
          lo = min(lo, bk);
          hi = max(hi, bk);
        }
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      for (int bk = lo; bk <= hi; ++bk) {
        float part = 0.f;
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (sb.bucket[j0 + n * 8 + (i & 1) - 8 * (i >> 1)] == bk)
              part += s[n][i];
          }
        }
        part = warp_sum(part);
        if (lane == 0) sdt.dt[warp][bk] += part;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        uint32_t b[2];
        load_b_kn<kD>(b, sK, kk * 16, n * 8, g, t);
        mma16816(acc[n], da, b);
      }
    }
  }

  if constexpr (kForm == kBiasDense) {
    // the key tiles the causal walk skipped: their dS is 0
    const int c0 = nkt * kTile, quads = (sk - c0) / 4;
    float* gp = grad + (((long long)bb * h + hh) * sq + q0) * sk + c0;
    for (int i = tid; i < kTile * quads; i += kThreads) {
      *reinterpret_cast<float4*>(gp + (long long)(i / quads) * sk +
                                 (i % quads) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if constexpr (kForm == kBiasTable) {
    __syncthreads();
    float* gp = grad + (((long long)bb * h + hh) * (sq / kTile) + qt) * ba.nb;
    for (int i = tid; i < ba.nb; i += kThreads)
      gp[i] = ((sdt.dt[0][i] + sdt.dt[1][i]) + sdt.dt[2][i]) + sdt.dt[3][i];
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
