// Standalone packed multi-head attention on Hopper (sm_90a): K5, a flash
// forward and a flash backward.
//
// Replaces (TPU Pallas kernel of the JAX reference package):
//   K5-fwd  vitiq/ops/pallas/flash_attention.py: _attention_kernel (pallas_call
//           in _pallas_attention, reached through fused_attention ->
//           _fused_attention_tpu), packed [B, L, D] bf16 attention without a
//           mask or dropout
//   K5-bwd  the backward of _fused_attention_tpu (_bwd): XLA there, which
//           recomputes attention batch-chunked under VITIQ_ATTN_BWD_BUDGET and
//           holds [chunk, H, L, L] f32 scores; here a flash backward that
//           recomputes P tile by tile from q, k and the forward's log-sum-exp.
//
// Function, per frame b and head h (dh = D / H, heads are dh-wide column
// slices of the packed [B, L, D] q, k, v):
//   s_ij  = (q_i . k_j) * log2(e) / sqrt(dh)          f32, log2 units
//   p_ij  = exp2(s_ij - m_i)                           f32, m_i a running max
//   l_i   = sum_j p_ij                                 f32, unrounded p
//   out_i = bf16( sum_j bf16(p_ij) v_j / l_i )         f32 accumulate
//   lse_i = m_i + log2(l_i)                            f32 [B, H, L]
// The TPU kernel takes p = exp2(s) with no max at all (it relies on |s| < 88)
// and rounds bf16(exp2(s)) for the P V product. Subtracting a max is the same
// function, safe for any score; it moves where bf16(p) rounds. Here the max is
// a running one (the flash recurrence: when a key tile raises it, the f32
// accumulators are rescaled by exp2(m_old - m_new)), so a p is rounded at the
// scale of the max over the keys seen so far, not the final one. The f32
// denominator is the sum of the unrounded p, as in the TPU kernel.
//
// Backward, from q, k, v, out, dout and lse (natural-log softmax gradient):
//   P_ij  = exp2(s_ij - lse_i)                  f32, recomputed per tile
//   delta_i = sum_d dout_id out_id              f32 (the flash identity
//                                               sum_j dP_ij P_ij = dO_i . O_i)
//   dS_ij = P_ij (dout_i . v_j - delta_i)       f32, rounded to bf16 for the MMA
//   dq_i = bf16( sum_j dS_ij k_j / sqrt(dh) )
//   dk_j = bf16( sum_i dS_ij q_i / sqrt(dh) )
//   dv_j = bf16( sum_i bf16(P_ij) dout_i )
//
// Design: tiles of 64 queries and 64 keys, 4 warps a block, 16 rows a warp;
// Q K^T, P V, dO V^T, dS K, dS^T Q and P^T dO on the tensor cores
// (mma.sync.m16n8k16, bf16 fragments, f32 accumulators), the score, P and dS
// tiles in registers only.
//   attention_fwd<DH>     one block per (frame-head, query tile): the warps'
//                         q fragments stay in registers while K and V^T tiles
//                         of 64 keys stream through shared memory; a running
//                         max and sum per row, so L is unbounded.
//   attention_bwd_dq<DH>  one block per (frame-head, query tile): delta for
//                         its rows (also written for the next pass), then K,
//                         V and K^T tiles stream through shared memory and dQ
//                         accumulates in registers (K3's query-major pass).
//   attention_bwd_dkdv<DH>
//                         one block per (frame-head, key tile): the warps'
//                         k and v fragments stay in registers while Q, dO,
//                         Q^T and dO^T tiles, with lse and delta, stream
//                         through; dK and dV accumulate in registers (K3's
//                         key-major pass).
// K3's attention backward (fused_layer_train.cu: train_attention_bwd) holds
// a whole frame-head's L rows in shared memory; these passes take the same
// products over 64-row tiles instead, so neither pass is bounded by L.
// Rows past L: queries read as zero; in the backward their lse is +inf and
// their delta 0, so P = dS = 0. Keys past L are -inf scores in the forward
// and P = dS = 0 in both backward passes, so a padded key contributes
// nothing. No pass stores a row past L: out, dq, dk and dv are [B, L, D].
//
// What bounds it on the card: per score element the forward does 4 dh tensor
// FLOPs (Q K^T and P V) and one exp2, the backward 10 dh FLOPs (recompute, dP,
// dV, dQ, dK) and two exp2 (one per pass). At dh = 16 that is 64 FLOPs per
// exp2 in the forward; the H100's special-function units give ~16 exp2 per
// clock per SM (~3.9e12/s at 1.83 GHz) against 989e12 dense bf16 FLOP/s, so
// the exponentials, not the tensor cores, set the floor at this width (about
// 0.55 ms per pass at B = 256, L = 1025, H = 8, against 0.14 ms of forward
// FLOPs). Bytes are small: q, k, v and out once each. This first port makes
// no attempt at that floor (no exp2 emulation on the FMA pipes, no
// warp-specialized pipeline, no wgmma); it is simple and right first.

#include "common.cuh"

namespace {

constexpr int FA_WARPS = 4;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int TILE = FA_WARPS * 16;  // rows of a query tile and of a key tile
constexpr int TLD = TILE + 8;        // stride of a transposed tile [DH][TLD]
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
__host__ __device__ constexpr int rld() { return DH + 8; }  // stride of a row tile

// Copy rows [r0, r0 + TILE) of one head (columns [0, DH) at `base`, row stride
// `ld`) into `rows` [TILE][rld] and/or transposed into `tr` [DH][TLD] (either
// may be null); rows >= L are zero.
template <int DH>
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ base, long long ld, int r0,
                                           int L, bf16* rows, bf16* tr) {
  constexpr int CH = DH / 8;  // 16-byte chunks per head row
  for (int i = threadIdx.x; i < TILE * CH; i += FA_THREADS) {
    const int j = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + j < L) val = *reinterpret_cast<const uint4*>(base + (long long)(r0 + j) * ld + c);
    if (rows) *reinterpret_cast<uint4*>(rows + j * rld<DH>() + c) = val;
    if (tr) {
      const bf16* v8 = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) tr[(c + e) * TLD + j] = v8[e];
    }
  }
}

// A fragments (16 rows, DH columns) of rows r_lo = r0 + g and r_hi = r_lo + 8
// of one head in device memory (row stride ld); rows >= L are zero.
template <int DH>
__device__ __forceinline__ void load_a_global(uint32_t a[DH / 16][4], const bf16* base,
                                              long long ld, int r_lo, int r_hi, int L, int t) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const bf16* lo = base + (long long)r_lo * ld + kk * 16 + 2 * t;
    const bf16* hi = base + (long long)r_hi * ld + kk * 16 + 2 * t;
    a[kk][0] = r_lo < L ? ld_b32(lo) : 0u;
    a[kk][1] = r_hi < L ? ld_b32(hi) : 0u;
    a[kk][2] = r_lo < L ? ld_b32(lo + 8) : 0u;
    a[kk][3] = r_hi < L ? ld_b32(hi + 8) : 0u;
  }
}

// Two 16 x 8 blocks of A B^T: the warp's 16 A rows against rows
// [j0, j0 + 16) of the row tile `rows` (B^T's rows), unscaled.
template <int DH>
__device__ __forceinline__ void product16(float c[2][4], const uint32_t a[DH / 16][4],
                                          const bf16* rows, int j0, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    c[nb][0] = c[nb][1] = c[nb][2] = c[nb][3] = 0.f;
    const bf16* r = rows + (j0 + nb * 8 + g) * rld<DH>() + 2 * t;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      mma_bf16_16816(c[nb], a[kk], ld_b32(r + kk * 16), ld_b32(r + kk * 16 + 8));
  }
}

// acc[DH/8] += A (16 x 16, fragment `a`) times rows [j0, j0 + 16) of the
// tile whose transpose is `tr` [DH][TLD]
template <int DH>
__device__ __forceinline__ void accumulate16(float acc[DH / 8][4], const uint32_t a[4],
                                             const bf16* tr, int j0, int g, int t) {
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    const bf16* p = tr + (nd * 8 + g) * TLD + j0 + 2 * t;
    mma_bf16_16816(acc[nd], a, ld_b32(p), ld_b32(p + 8));
  }
}

// Store a warp's 16-row accumulator times `scale` as bf16 rows r_lo, r_hi
// (those < n_rows) of one head: dst + r * D.
template <int DH>
__device__ __forceinline__ void store16(const float acc[DH / 8][4], float scale, bf16* dst,
                                       int D, int r_lo, int r_hi, int n_rows, int t) {
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    bf16* p = dst + nd * 8 + 2 * t;
    if (r_lo < n_rows)
      *reinterpret_cast<uint32_t*>(p + (long long)r_lo * D) =
          pack_bf16x2(acc[nd][0] * scale, acc[nd][1] * scale);
    if (r_hi < n_rows)
      *reinterpret_cast<uint32_t*>(p + (long long)r_hi * D) =
          pack_bf16x2(acc[nd][2] * scale, acc[nd][3] * scale);
  }
}

// K5-fwd. grid (B * H, ceil(L / TILE)). q, k, v: head h of frame b at
// x + b * L * ld + h * DH, row stride ld; out [B, L, D]; lse [B, H, L] (log2).
template <int DH>
__global__ void __launch_bounds__(FA_THREADS) attention_fwd(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    int ldq, int ldk, int ldv, bf16* __restrict__ out, float* __restrict__ lse, int L, int H,
    float scale2) {
  __shared__ __align__(16) bf16 ks[TILE * rld<DH>()];
  __shared__ __align__(16) bf16 vt[DH * TLD];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, D = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = blockIdx.y * TILE + warp * 16 + g, r_hi = r_lo + 8;
  const bf16* kb = k + (long long)b * L * ldk + h * DH;
  const bf16* vb = v + (long long)b * L * ldv + h * DH;

  uint32_t qa[DH / 16][4];
  load_a_global<DH>(qa, q + (long long)b * L * ldq + h * DH, ldq, r_lo, r_hi, L, t);
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[DH / 8][4] = {};

  for (int j0 = 0; j0 < L; j0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<DH>(kb, ldk, j0, L, ks, nullptr);
    stage_tile<DH>(vb, ldv, j0, L, nullptr, vt);
    __syncthreads();

    float sc[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) product16<DH>(&sc[2 * j], qa, ks, j * 16, g, t);
    float t_lo = -INFINITY, t_hi = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < TILE / 8; ++nb) {
      const int key = j0 + nb * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = key + (e & 1) < L ? sc[nb][e] * scale2 : -INFINITY;
      t_lo = fmaxf(t_lo, fmaxf(sc[nb][0], sc[nb][1]));
      t_hi = fmaxf(t_hi, fmaxf(sc[nb][2], sc[nb][3]));
    }
    // every tile holds key j0 < L, so the new max is finite
    const float n_lo = fmaxf(m_lo, quad_max(t_lo)), n_hi = fmaxf(m_hi, quad_max(t_hi));
    const float a_lo = exp2f(m_lo - n_lo), a_hi = exp2f(m_hi - n_hi);
    m_lo = n_lo;
    m_hi = n_hi;
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      o[nd][0] *= a_lo;
      o[nd][1] *= a_lo;
      o[nd][2] *= a_hi;
      o[nd][3] *= a_hi;
    }
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) {
      uint32_t pa[4];  // P as the A operand: [g | g+8][16 keys]
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* s = sc[2 * j + u];
        const float p0 = exp2f(s[0] - m_lo), p1 = exp2f(s[1] - m_lo);
        const float p2 = exp2f(s[2] - m_hi), p3 = exp2f(s[3] - m_hi);
        l_lo += p0 + p1;
        l_hi += p2 + p3;
        pa[2 * u] = pack_bf16x2(p0, p1);
        pa[2 * u + 1] = pack_bf16x2(p2, p3);
      }
      accumulate16<DH>(o, pa, vt, j * 16, g, t);
    }
  }
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);

  bf16* ob = out + (long long)b * L * D + h * DH;
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    bf16* p = ob + nd * 8 + 2 * t;
    if (r_lo < L)
      *reinterpret_cast<uint32_t*>(p + (long long)r_lo * D) =
          pack_bf16x2(o[nd][0] / l_lo, o[nd][1] / l_lo);
    if (r_hi < L)
      *reinterpret_cast<uint32_t*>(p + (long long)r_hi * D) =
          pack_bf16x2(o[nd][2] / l_hi, o[nd][3] / l_hi);
  }
  if (t == 0) {
    float* lb = lse + (long long)bh * L;
    if (r_lo < L) lb[r_lo] = m_lo + log2f(l_lo);
    if (r_hi < L) lb[r_hi] = m_hi + log2f(l_hi);
  }
}

// K5-bwd, query-major pass. grid (B * H, ceil(L / TILE)). Writes delta
// [B, H, L] and dq [B, L, D] for its rows.
template <int DH>
__global__ void __launch_bounds__(FA_THREADS) attention_bwd_dq(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    int ldq, int ldk, int ldv, const bf16* __restrict__ out, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq, int L,
    int H, float scale2, float scale) {
  __shared__ __align__(16) bf16 ks[TILE * rld<DH>()];
  __shared__ __align__(16) bf16 vs[TILE * rld<DH>()];
  __shared__ __align__(16) bf16 kt[DH * TLD];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, D = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = blockIdx.y * TILE + warp * 16 + g, r_hi = r_lo + 8;
  const long long frame = (long long)b * L * D + h * DH;
  const bf16* kb = k + (long long)b * L * ldk + h * DH;
  const bf16* vb = v + (long long)b * L * ldv + h * DH;

  uint32_t qa[DH / 16][4], da[DH / 16][4], oa[DH / 16][4];
  load_a_global<DH>(qa, q + (long long)b * L * ldq + h * DH, ldq, r_lo, r_hi, L, t);
  load_a_global<DH>(da, dout + frame, D, r_lo, r_hi, L, t);
  load_a_global<DH>(oa, out + frame, D, r_lo, r_hi, L, t);
  // delta of rows r_lo, r_hi: this thread's 4 * DH/16 columns of each, then
  // the quad's sum
  float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&da[kk][e]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&oa[kk][e]));
      (e & 1 ? d_hi : d_lo) += x.x * y.x + x.y * y.y;
    }
  d_lo = quad_sum(d_lo);
  d_hi = quad_sum(d_hi);
  const float* lb = lse + (long long)bh * L;
  const float e_lo = r_lo < L ? lb[r_lo] : INFINITY, e_hi = r_hi < L ? lb[r_hi] : INFINITY;
  if (t == 0) {
    if (r_lo < L) delta[(long long)bh * L + r_lo] = d_lo;
    if (r_hi < L) delta[(long long)bh * L + r_hi] = d_hi;
  }

  float acc[DH / 8][4] = {};
  for (int j0 = 0; j0 < L; j0 += TILE) {
    __syncthreads();
    stage_tile<DH>(kb, ldk, j0, L, ks, kt);
    stage_tile<DH>(vb, ldv, j0, L, vs, nullptr);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) {
      float sc[2][4], dp[2][4];
      product16<DH>(sc, qa, ks, j * 16, g, t);
      product16<DH>(dp, da, vs, j * 16, g, t);
      uint32_t dsa[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int key = j0 + j * 16 + u * 8 + 2 * t;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = key + (e & 1) < L ? exp2f(sc[u][e] * scale2 - (e < 2 ? e_lo : e_hi)) : 0.f;
          ds[e] = p * (dp[u][e] - (e < 2 ? d_lo : d_hi));
        }
        dsa[2 * u] = pack_bf16x2(ds[0], ds[1]);
        dsa[2 * u + 1] = pack_bf16x2(ds[2], ds[3]);
      }
      accumulate16<DH>(acc, dsa, kt, j * 16, g, t);
    }
  }
  store16<DH>(acc, scale, dq + frame, D, r_lo, r_hi, L, t);
}

// K5-bwd, key-major pass. grid (B * H, ceil(L / TILE)). Reads delta from
// the query-major pass; writes dk and dv [B, L, D] for its key rows.
template <int DH>
__global__ void __launch_bounds__(FA_THREADS) attention_bwd_dkdv(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    int ldq, int ldk, int ldv, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int L,
    int H, float scale2, float scale) {
  __shared__ __align__(16) bf16 qs[TILE * rld<DH>()];
  __shared__ __align__(16) bf16 dos[TILE * rld<DH>()];
  __shared__ __align__(16) bf16 qt[DH * TLD];
  __shared__ __align__(16) bf16 dot[DH * TLD];
  __shared__ float lse_s[TILE], delta_s[TILE];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, D = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c_lo = blockIdx.y * TILE + warp * 16 + g, c_hi = c_lo + 8;
  const bf16* qb = q + (long long)b * L * ldq + h * DH;
  const bf16* db = dout + (long long)b * L * D + h * DH;
  const float* lb = lse + (long long)bh * L;
  const float* deb = delta + (long long)bh * L;

  uint32_t ka[DH / 16][4], va[DH / 16][4];
  load_a_global<DH>(ka, k + (long long)b * L * ldk + h * DH, ldk, c_lo, c_hi, L, t);
  load_a_global<DH>(va, v + (long long)b * L * ldv + h * DH, ldv, c_lo, c_hi, L, t);
  const bool live_lo = c_lo < L, live_hi = c_hi < L;

  float dka[DH / 8][4] = {}, dva[DH / 8][4] = {};
  for (int i0 = 0; i0 < L; i0 += TILE) {
    __syncthreads();
    stage_tile<DH>(qb, ldq, i0, L, qs, qt);
    stage_tile<DH>(db, D, i0, L, dos, dot);
    for (int i = threadIdx.x; i < TILE; i += FA_THREADS) {
      lse_s[i] = i0 + i < L ? lb[i0 + i] : INFINITY;
      delta_s[i] = i0 + i < L ? deb[i0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) {
      float st[2][4], dpt[2][4];  // [key][query]
      product16<DH>(st, ka, qs, j * 16, g, t);
      product16<DH>(dpt, va, dos, j * 16, g, t);
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float pv[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 16 + u * 8 + 2 * t + (e & 1);
          const bool live = e < 2 ? live_lo : live_hi;
          pv[e] = live ? exp2f(st[u][e] * scale2 - lse_s[qi]) : 0.f;
          ds[e] = pv[e] * (dpt[u][e] - delta_s[qi]);
        }
        pa[2 * u] = pack_bf16x2(pv[0], pv[1]);
        pa[2 * u + 1] = pack_bf16x2(pv[2], pv[3]);
        dsa[2 * u] = pack_bf16x2(ds[0], ds[1]);
        dsa[2 * u + 1] = pack_bf16x2(ds[2], ds[3]);
      }
      accumulate16<DH>(dva, pa, dot, j * 16, g, t);
      accumulate16<DH>(dka, dsa, qt, j * 16, g, t);
    }
  }
  const long long fo = (long long)b * L * D + h * DH;
  store16<DH>(dka, scale, dk + fo, D, c_lo, c_hi, L, t);
  store16<DH>(dva, 1.f, dv + fo, D, c_lo, c_hi, L, t);
}

bool shapes_ok(int B, int L, int H, int D, int ldq, int ldk, int ldv) {
  if (B <= 0 || L <= 0 || H <= 0 || D % H) return false;
  const int dh = D / H;
  if (dh != 16 && dh != 32 && dh != 64) return false;
  // rows are read 16 bytes at a time
  return ldq >= D && ldk >= D && ldv >= D && ldq % 8 == 0 && ldk % 8 == 0 && ldv % 8 == 0;
}

int round_tile(int L) { return (L + TILE - 1) / TILE * TILE; }

template <int DH>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, int ldq, int ldk,
        int ldv, int B, int L, int H, cudaStream_t s) {
  const dim3 grid((unsigned)B * H, (unsigned)(round_tile(L) / TILE));
  attention_fwd<DH><<<grid, FA_THREADS, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      ldq, ldk, ldv, static_cast<bf16*>(out), static_cast<float*>(lse), L, H,
      LOG2E / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int DH>
int bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
        const void* lse, void* delta, void* dq, void* dk, void* dv, int ldq, int ldk, int ldv,
        int B, int L, int H, cudaStream_t s) {
  const dim3 grid((unsigned)B * H, (unsigned)(round_tile(L) / TILE));
  const float scale2 = LOG2E / sqrtf((float)DH), scale = 1.f / sqrtf((float)DH);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *dob = static_cast<const bf16*>(dout);
  attention_bwd_dq<DH><<<grid, FA_THREADS, 0, s>>>(
      qb, kb, vb, ldq, ldk, ldv, static_cast<const bf16*>(out), dob,
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf16*>(dq), L, H,
      scale2, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv<DH><<<grid, FA_THREADS, 0, s>>>(
      qb, kb, vb, ldq, ldk, ldv, dob, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, H,
      scale2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K5-fwd. q, k, v: bf16, frame b's row i of head h at x + (b*L + i)*ld + h*dh
// (ld a multiple of 8, >= D); out [B, L, D] bf16; lse [B, H, L] f32 (log2).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for shapes it does
// not take (d_head 16, 32 or 64).
extern "C" int vitiq_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int ldq, int ldk, int ldv, int B, int L, int H,
                                   int D, void* stream_ptr) {
  if (!shapes_ok(B, L, H, D, ldq, ldk, ldv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (D / H) {
    case 16: return fwd<16>(q, k, v, out, lse, ldq, ldk, ldv, B, L, H, s);
    case 32: return fwd<32>(q, k, v, out, lse, ldq, ldk, ldv, B, L, H, s);
    default: return fwd<64>(q, k, v, out, lse, ldq, ldk, ldv, B, L, H, s);
  }
}

// K5-bwd. q, k, v as for the forward; out, dout [B, L, D] bf16; lse the
// forward's; delta [B, H, L] f32 scratch; dq, dk, dv [B, L, D] bf16.
extern "C" int vitiq_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int ldq, int ldk, int ldv, int B, int L,
                                   int H, int D, void* stream_ptr) {
  if (!shapes_ok(B, L, H, D, ldq, ldk, ldv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (D / H) {
    case 16:
      return bwd<16>(q, k, v, out, dout, lse, delta, dq, dk, dv, ldq, ldk, ldv, B, L, H, s);
    case 32:
      return bwd<32>(q, k, v, out, dout, lse, delta, dq, dk, dv, ldq, ldk, ldv, B, L, H, s);
    default:
      return bwd<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, ldq, ldk, ldv, B, L, H, s);
  }
}
