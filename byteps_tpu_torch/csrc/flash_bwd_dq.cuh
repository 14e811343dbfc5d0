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
//
// Design (hopper.cuh): the producer warp loads the Q and dO tiles once
// and streams the K and V tiles of the walk (twice over when the CTA
// computes delta) through a ring of kStages stages by TMA. Per key tile
// the consumer warpgroup issues S = Q·Kᵀ and dP = dO·Vᵀ together (wgmma,
// all four operands K-major in shared memory), forms P = exp2(S·scale·
// log2(e) - lse·log2(e)) and dS in registers, and adds dS·K with dS from
// registers and K read MN-major from the tile that fed S. S, P, dP and dS
// never reach shared or device memory; key tiles above the diagonal are
// skipped under causal masking. No atomics: the same inputs give the same
// bits.
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
//     are added in a fixed order at the end.
//
// Head dim kD is a template parameter (64 and 128). Shared memory: the Q
// and dO tiles and kStages K/V pairs, 48 KB at d 64 and 96 KB at d 128
// (plus the table form's strip and partials): two CTAs fit an SM.
// Registers of a consumer thread: S and dP (64 fp32), the dq accumulator
// (kD / 2 fp32) and dS as bf16 A operands (16); the Q and dO operands stay
// in shared memory, where wgmma reads them.
#pragma once

#include <climits>

#include "flash_bias.cuh"

namespace {

constexpr int kDqStages = 2;

template <int kForm>
struct DtableSmem {};

template <>
struct DtableSmem<kBiasTable> {
  float dt[kConsumers / 32][kMaxBuckets];  // per-warp partial dtable
};

template <int kD, int kForm>
struct DqSmem {
  Tile<kD> q;
  Tile<kD> o;
  Tile<kD> k[kDqStages];
  Tile<kD> v[kDqStages];
  uint64_t qo_full;
  uint64_t full[kDqStages];
  uint64_t empty[kDqStages];
  BiasSmem<kForm> sb;
  DtableSmem<kForm> sdt;
};

// CTAs per SM that ptxas is asked to fit (the registers it may use):
// two, so at most 168 registers a thread (five warps a CTA, three on one
// sub-partition), except for the dense form at d 128, which would spill
// there and takes what it needs instead.
template <int kD, int kForm>
constexpr int kDqBlocks = kD > 64 && kForm == kBiasDense ? 1 : 2;

template <bool kDeltaIn, int kD, int kForm>
__global__ void __launch_bounds__(kThreads, (kDqBlocks<kD, kForm>))
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int h, int sq, int sk,
                    BshdStrides dqs, float scale, int causal, BiasArgs ba,
                    float* __restrict__ grad) {
  auto& sm = dyn_smem<DqSmem<kD, kForm>>();
  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int q0 = qt * kTile;
  int nkt = sk / kTile;
  if (causal) nkt = min(nkt, qt + 1);
  // the walk: delta's pass over the key tiles first, unless delta is given
  const int walk = kDeltaIn ? nkt : 2 * nkt;

  if (tid == 0) {
    mbar_init(&sm.qo_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: lane 0 issues every load
    if (tid == kConsumers) {
      mbar_expect_tx(&sm.qo_full, 2 * kTileBytes<kD>);
      load_tile<kD>(&sm.q, &tq, &sm.qo_full, q0, hh, bb);
      load_tile<kD>(&sm.o, &tdo, &sm.qo_full, q0, hh, bb);
      for (int i = 0; i < walk; ++i) {
        const int st = i % kDqStages, k0 = (i % nkt) * kTile;
        mbar_wait(&sm.empty[st], ((i / kDqStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * kTileBytes<kD>);
        load_tile<kD>(&sm.k[st], &tk, &sm.full[st], k0, hh, bb);
        load_tile<kD>(&sm.v[st], &tv, &sm.full[st], k0, hh, bb);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  BiasSmem<kForm>& sb = sm.sb;
  DtableSmem<kForm>& sdt = sm.sdt;
  load_table_row<kForm>(sb, ba, hh, tid);
  if constexpr (kForm == kBiasTable) {
    for (int i = tid; i < (kConsumers / 32) * kMaxBuckets; i += kConsumers)
      (&sdt.dt[0][0])[i] = 0.f;
  }
  const long long head_row = ((long long)bb * h + hh) * sq;
  const float lse_l2[2] = {lse[head_row + row[0]] * kLog2e,
                           lse[head_row + row[1]] * kLog2e};
  const float* dense = dense_head<kForm>(ba, hh, sq, sk);
  const float scale_l2 = scale * kLog2e;
  mbar_wait(&sm.qo_full, 0);

  float s[32], dp[32];
  // S and dP of walk step i (key tile i % nkt, ring stage st) for this
  // warp's 16 rows; P = exp2(S·log2(e) - lse·log2(e)) replaces S in place,
  // masked entries 0. The caller releases the stage.
  auto scores = [&](int i, int st) {
    const int k0 = (i % nkt) * kTile;
    strip_for<kForm>(sb, ba, q0, k0, sq, tid);
    mbar_wait(&sm.full[st], (i / kDqStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(s, desc_k(sm.q, kk), desc_k(sm.k[st], kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(dp, desc_k(sm.o, kk), desc_k(sm.v[st], kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);
    fence_acc(dp);
    const bool diag = causal && k0 == q0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      const int col = k0 + (j >> 2) * 8 + 2 * t + (j & 1);
      float p;
      if constexpr (kForm == kBiasNone) {
        p = exp2_sfu(s[j] * scale_l2 - lse_l2[r]);
      } else {
        p = exp2_sfu(biased(s[j], scale,
                         bias_at<kForm>(sb, dense, sk, row[r], col,
                                        row[r] - q0, col - k0)) *
                      kLog2e -
                  lse_l2[r]);
      }
      if (diag && row[r] < col) p = 0.f;
      s[j] = p;
    }
  };

  float dl[2];
  if constexpr (kDeltaIn) {
    dl[0] = delta[head_row + row[0]];
    dl[1] = delta[head_row + row[1]];
  } else {
    float dsum[2] = {0.f, 0.f};
    for (int i = 0; i < nkt; ++i) {
      const int st = i % kDqStages;
      scores(i, st);
      mbar_arrive(&sm.empty[st]);
#pragma unroll
      for (int j = 0; j < 32; ++j) dsum[(j >> 1) & 1] += s[j] * dp[j];
    }
    dl[0] = quad_sum(dsum[0]);
    dl[1] = quad_sum(dsum[1]);
    if (t == 0) {
      delta[head_row + row[0]] = dl[0];
      delta[head_row + row[1]] = dl[1];
    }
  }

  float acc[kD / 64][32];
#pragma unroll
  for (int c = 0; c < kD / 64; ++c) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[c][j] = 0.f;
  }
  for (int i = walk - nkt; i < walk; ++i) {
    const int st = i % kDqStages, kt = i % nkt;
    scores(i, st);
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] *= dp[j] - dl[(j >> 1) & 1];
    if constexpr (kForm == kBiasDense) {
      float* gp = grad + (((long long)bb * h + hh) * sq) * sk + kt * kTile;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = n * 8 + 2 * t;
        *reinterpret_cast<float2*>(gp + (long long)row[0] * sk + col) =
            make_float2(s[4 * n], s[4 * n + 1]);
        *reinterpret_cast<float2*>(gp + (long long)row[1] * sk + col) =
            make_float2(s[4 * n + 2], s[4 * n + 3]);
      }
    }
    if constexpr (kForm == kBiasTable) {
      // strip index of entry j: its key's and query's local offset
      const int j0 = 2 * t - (warp * 16 + g) + kTile - 1;
      int lo = INT_MAX, hi = -1;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int bk =
            sb.bucket[j0 + (j >> 2) * 8 + (j & 1) - 8 * ((j >> 1) & 1)];
        lo = min(lo, bk);
        hi = max(hi, bk);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      for (int bk = lo; bk <= hi; ++bk) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          if (sb.bucket[j0 + (j >> 2) * 8 + (j & 1) - 8 * ((j >> 1) & 1)] ==
              bk)
            part += s[j];
        }
        part = warp_sum(part);
        if (lane == 0) sdt.dt[warp][bk] += part;
      }
    }
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      c_to_a(da[kk], &s[8 * kk]);
      fence_frag(da[kk]);
    }
#pragma unroll
    for (int c = 0; c < kD / 64; ++c) fence_acc(acc[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kD / 64; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[c], da[kk], desc_mn(sm.k[st], c, kk));
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < kD / 64; ++c) fence_acc(acc[c]);
    mbar_arrive(&sm.empty[st]);
  }

  if constexpr (kForm == kBiasDense) {
    // the key tiles the causal walk skipped: their dS is 0
    const int c0 = nkt * kTile, quads = (sk - c0) / 4;
    float* gp = grad + (((long long)bb * h + hh) * sq + q0) * sk + c0;
    for (int i = tid; i < kTile * quads; i += kConsumers) {
      *reinterpret_cast<float4*>(gp + (long long)(i / quads) * sk +
                                 (i % quads) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if constexpr (kForm == kBiasTable) {
    consumer_sync();
    float* gp = grad + (((long long)bb * h + hh) * (sq / kTile) + qt) * ba.nb;
    for (int i = tid; i < ba.nb; i += kConsumers)
      gp[i] = ((sdt.dt[0][i] + sdt.dt[1][i]) + sdt.dt[2][i]) + sdt.dt[3][i];
  }

  bf16* gp = dq + bb * dqs.b + hh * kD;
#pragma unroll
  for (int c = 0; c < kD / 64; ++c) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = c * 64 + n * 8 + 2 * t;
      const float* a = &acc[c][4 * n];
      *reinterpret_cast<uint32_t*>(gp + row[0] * dqs.s + col) =
          pack_f32(a[0] * scale, a[1] * scale);
      *reinterpret_cast<uint32_t*>(gp + row[1] * dqs.s + col) =
          pack_f32(a[2] * scale, a[3] * scale);
    }
  }
}

// One launch of the dq kernel; dq is [b, sq, h, d] contiguous.
template <bool kDeltaIn, int kD, int kForm>
cudaError_t launch_dq(const QkvoMaps& m, const void* lse, void* delta,
                      void* dq, int b, int h, int sq, int sk, float scale,
                      int causal, const BiasArgs& ba, void* grad,
                      cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<DqSmem<kD, kForm>>;
  const cudaError_t attr =
      smem_attr(flash_bwd_dq_kernel<kDeltaIn, kD, kForm>, kSmem);
  if (attr != cudaSuccess) return attr;
  const long long row = static_cast<long long>(h) * kD;
  flash_bwd_dq_kernel<kDeltaIn, kD, kForm>
      <<<dim3(sq / kTile, h, b), kThreads, kSmem, stream>>>(
          m.q, m.k, m.v, m.o, static_cast<const float*>(lse),
          static_cast<float*>(delta), static_cast<bf16*>(dq), h, sq, sk,
          BshdStrides{sq * row, row}, scale, causal, ba,
          static_cast<float*>(grad));
  return cudaGetLastError();
}

}  // namespace
