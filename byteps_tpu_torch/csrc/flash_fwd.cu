// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the Pallas kernel byteps_tpu/ops/flash_attention.py::_fwd_kernel
// (wrapper _flash_fwd, pallas_call at :284) for the one-block geometry of
// the flagship step (s <= 512, d = 64, no bias, no rel table).
//
// Contract (the same as the Pallas kernel's): q [b,sq,h,d], k/v [b,sk,h,d]
// bf16 -> out [b,sq,h,d] bf16 and lse [b,h,sq] fp32. S = q·kᵀ·scale in fp32;
// causal masks entries with row < col to -1e30 and skips kv tiles above
// the diagonal; online max/sum; P is cast to bf16 before P·V; out =
// acc / max(l, 1e-30) and lse = m + log(l).
//
// What bounds it on an H100: at seq 512 and d 64 the work is 4·s·d FLOP
// per score against 2·d bytes per row read, about 256 FLOP/byte, just
// under the card's ~295 FLOP/byte ridge, so the least time is set by
// memory (q, k, v read once and out written once). The design keeps S and
// P out of device memory entirely: one CTA of 4 warps per (batch, head,
// 64-query tile) holds its Q fragments in registers, walks the key tiles
// through shared memory, and keeps the running max, sum and the output
// accumulator in registers. Products run on the tensor cores through
// mma.sync.m16n8k16 (bf16 x bf16 -> fp32). wgmma, TMA and a pipelined
// ring of tiles are later work.
#include "mma_bf16.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int h, int sq, int sk,
                 BshdStrides qs, BshdStrides ks, BshdStrides vs,
                 BshdStrides os, float scale, int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kLD];
  __shared__ __align__(16) bf16 sK[kTile * kLD];
  __shared__ __align__(16) bf16 sV[kTile * kLD];

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile(sQ, q + bb * qs.b + q0 * qs.s + hh * kD, qs.s, tid);
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) load_a(qf[kk], sQ, warp * 16, kk * 16, g, t);

  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int nkt = sk / kTile;
  if (causal) nkt = min(nkt, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, k + bb * ks.b + (long long)kt * kTile * ks.s + hh * kD, ks.s, tid);
    load_tile(sV, v + bb * vs.b + (long long)kt * kTile * vs.s + hh * kD, vs.s, tid);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b[2];
        load_b_nk(b, sK, n * 8, kk * 16, g, t);
        mma16816(s[n], qf[kk], b);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int col = kt * kTile + n * 8 + 2 * t + (i & 1);
        float x = s[n][i] * scale;
        if (causal && row[r] < col) x = kNegInf;
        s[n][i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mnew = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - mnew);
      m[r] = mnew;
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[n][i] - m[i >> 1]);
        s[n][i] = p;
        rs[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        uint32_t b[2];
        load_b_kn(b, sV, kk * 16, n * 8, g, t);
        mma16816(o[n], pa, b);
      }
    }
  }

  const float lc[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  bf16* op = out + bb * os.b + hh * kD;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(op + row[0] * os.s + col) =
        pack_f32(o[n][0] / lc[0], o[n][1] / lc[0]);
    *reinterpret_cast<uint32_t*>(op + row[1] * os.s + col) =
        pack_f32(o[n][2] / lc[1], o[n][3] / lc[1]);
  }
  if (t == 0) {
    float* lp = lse + ((long long)bb * h + hh) * sq;
    lp[row[0]] = m[0] + logf(lc[0]);
    lp[row[1]] = m[1] + logf(lc[1]);
  }
}

}  // namespace

// Launches on `stream`, allocates nothing; returns cudaGetLastError().
extern "C" int bps_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int b, int h, int sq,
                             int sk, int d, long long q_sb, long long q_ss,
                             long long k_sb, long long k_ss, long long v_sb,
                             long long v_ss, long long o_sb, long long o_ss,
                             float scale, int causal, void* stream) {
  if (d != kD || sq % kTile != 0 || sk % kTile != 0 || b <= 0 || h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(sq / kTile, h, b);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), h, sq, sk, BshdStrides{q_sb, q_ss},
      BshdStrides{k_sb, k_ss}, BshdStrides{v_sb, v_ss},
      BshdStrides{o_sb, o_ss}, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
