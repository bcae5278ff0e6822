// The one-pass wgmma attention tile shared by K1's core
// (fused_encoder_layer.cu: attention_core_kernel) and K5's forward
// (flash_attention.cu: attention_fwd): Q K^T from q in registers against a
// K-major k tile, the online softmax on the accumulators, and P V with P
// packed from the accumulators into the A fragment and v an MN-major B
// operand. The k and v tiles are 64 rows of DH bf16 each, as a TMA load
// swizzled by the row width (DH * 2 bytes) writes them.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

// P3's probability without the exp: (s - m) + m, IEEE-rounded twice, and 0
// for a key past L (s = -inf there).
__device__ __forceinline__ float noexp_prob(float s, float m) {
  return s == -INFINITY ? 0.f : __fadd_rn(__fsub_rn(s, m), m);
}

// exp2 on the special-function unit (MUFU.EX2)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int CORE_KT = 64;  // keys per tile (the wgmma's N), query rows per warpgroup tile

// One key tile of the core for one warpgroup's 64 query rows: NT = 64
// columns, or 16 for a last tile of at most 16 keys. s: scratch for the
// scores; o: the P V accumulators; lsum: the thread's f32 partial sums of p
// for its two rows (the quad holds a row's sum).
// RAW (K5): q arrives unscaled, so the scores s and the running max m are
// raw products; each p is exp2(scale2 s - scale2 m) (one FFMA and one
// MUFU.EX2), the rescale exp2(scale2 (m_old - m_new)), and the denominator
// sums the unrounded p. Without RAW (K1) q carries scale2 and the
// denominator sums the rounded p; scale2 is not read.
template <int DH, bool NOEXP, int NT, bool RAW = false>
__device__ __forceinline__ void core_tile(float* s, float* o, float* lsum, float& m_lo,
                                          float& m_hi, const uint32_t (*qa)[4], uint32_t k_tile,
                                          uint32_t v_tile, int valid,
                                          bool live, int t, float scale2 = 1.f) {
  constexpr int SPAN = DH * 2;
  constexpr uint32_t SBO = 8 * SPAN;
  constexpr int NG = NT / 16;  // 16-key groups
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    Wgmma<NT>::template rs<0>(s, qa[kk], smem_desc(k_tile + kk * 32, SPAN, SBO, SBO), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<NT / 2>(s);
  // P is packed into the first NT / 4 score registers (each 16-key group's
  // eight scores become its four bf16 pairs, in order, so no score is
  // overwritten before it is read): the score and P registers are the same
  if (live) {
    const int groups = valid < NT ? (valid + 15) >> 4 : NG;  // live 16-key groups, uniform
    if (valid < NT) {
#pragma unroll
      for (int e = 0; e < NT / 2; ++e)
        if ((e >> 2) * 8 + 2 * t + (e & 1) >= valid) s[e] = -INFINITY;
    }
    float tm_lo = -INFINITY, tm_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      if (j / 2 < groups) {
        tm_lo = fmaxf(tm_lo, fmaxf(s[4 * j], s[4 * j + 1]));
        tm_hi = fmaxf(tm_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
    }
    const float mn_lo = fmaxf(m_lo, quad_max(tm_lo)), mn_hi = fmaxf(m_hi, quad_max(tm_hi));
    float a_lo, a_hi;
    if constexpr (NOEXP) {
      const float d_lo = __fsub_rn(m_lo, mn_lo), d_hi = __fsub_rn(m_hi, mn_hi);
      a_lo = d_lo == -INFINITY ? 1.f : __fadd_rn(__fmul_rn(d_lo, 0.f), 1.f);
      a_hi = d_hi == -INFINITY ? 1.f : __fadd_rn(__fmul_rn(d_hi, 0.f), 1.f);
    } else if constexpr (RAW) {
      a_lo = exp2_sfu((m_lo - mn_lo) * scale2);
      a_hi = exp2_sfu((m_hi - mn_hi) * scale2);
    } else {
      a_lo = exp2_sfu(m_lo - mn_lo);
      a_hi = exp2_sfu(m_hi - mn_hi);
    }
    m_lo = mn_lo;
    m_hi = mn_hi;
    // RAW: the max in log2 units, negated, the addend of each p's FFMA
    const float ms_lo = -mn_lo * scale2, ms_hi = -mn_hi * scale2;
    // the rescale, skipped where no row of the warp raised its max (most
    // tiles past the first few): a warp-uniform branch
    if (__any_sync(0xffffffffu, a_lo != 1.f || a_hi != 1.f)) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j] = __fmul_rn(o[4 * j], a_lo);
        o[4 * j + 1] = __fmul_rn(o[4 * j + 1], a_lo);
        o[4 * j + 2] = __fmul_rn(o[4 * j + 2], a_hi);
        o[4 * j + 3] = __fmul_rn(o[4 * j + 3], a_hi);
      }
      lsum[0] = __fmul_rn(lsum[0], a_lo);
      lsum[1] = __fmul_rn(lsum[1], a_hi);
    }
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      float p[8];
      if (q < groups) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float si = s[8 * q + i], mi = (i & 2) ? mn_hi : mn_lo;
          if constexpr (NOEXP)
            p[i] = noexp_prob(si, mi);
          else if constexpr (RAW)
            p[i] = exp2_sfu(fmaf(si, scale2, (i & 2) ? ms_hi : ms_lo));
          else
            p[i] = exp2_sfu(si - mi);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 pb = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
        s[4 * q + i] = __uint_as_float(*reinterpret_cast<const uint32_t*>(&pb));
        // K1: the sum of the rounded p; NOEXP and RAW: of the unrounded ones
        const float2 pf = __bfloat1622float2(pb);
        lsum[i & 1] += NOEXP || RAW ? p[2 * i] + p[2 * i + 1] : pf.x + pf.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NT / 4; ++i) s[i] = 0.f;
  }
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const uint32_t pa[4] = {__float_as_uint(s[4 * q]), __float_as_uint(s[4 * q + 1]),
                            __float_as_uint(s[4 * q + 2]), __float_as_uint(s[4 * q + 3])};
    Wgmma<DH>::template rs<1>(o, pa, smem_desc(v_tile + q * 16 * SPAN, SPAN, SBO, SBO), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<DH / 2>(o);
}

}  // namespace
