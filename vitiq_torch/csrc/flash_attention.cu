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
// a running one over 64-key tiles (the flash recurrence: when a tile raises
// it, the f32 accumulators are rescaled by exp2(m_old - m_new)), so a p is
// rounded at the scale of the max over the keys seen so far, not the final
// one. The f32 denominator is the sum of the unrounded p, as in the TPU
// kernel. flash_attention.attention_onepass_plain is this function in plain
// PyTorch.
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
// Design (Hopper: wgmma, TMA, mbarriers). Every product is a warpgroup's
// wgmma on a 64-row tile with its A operand in registers (the m16n8k16 A
// fragment of each warp's 16 rows) and its B operand a 64-row tile in shared
// memory, as TMA writes it: 64 rows of dh bf16, swizzled by the row width
// (dh * 2 bytes). The same tile serves as a K-major B (against its rows: the
// scores) and as an MN-major B (along its rows: the outputs). Score tiles
// stay in registers, and P or dS is packed from the accumulators straight
// into the A fragment of the next product.
//   attention_fwd<DH>      one 64-row query tile a warpgroup: K1's one-pass
//                          tile (core_tile in attention_core.cuh, RAW: q
//                          arrives unscaled, so p = exp2(scale2 s -
//                          scale2 m) is one FFMA and one MUFU.EX2 from the
//                          raw running max, and l sums the unrounded p),
//                          then out and lse.
//   attention_bwd_dq<DH>   one 64-row query tile a warpgroup, q and dout in
//                          registers: delta for its rows (also written for
//                          the next pass), then per key tile, in two parts
//                          of 32 keys, S = Q K^T and dP = dO V^T (k, v
//                          K-major), P = exp2(scale2 S - lse), dS = P (dP -
//                          delta) packed into the A fragment of dQ += dS K
//                          (k MN-major), left in flight as in the dK/dV pass.
//   attention_bwd_dkdv<DH> one 64-row key tile a warpgroup, k and v in
//                          registers: per query tile, in two parts of 32
//                          queries, S^T = K Q^T and dP^T = V dO^T (q, dout
//                          K-major), P^T and dS^T (lse and delta by query
//                          column) packed into the A fragments of dV +=
//                          P^T dO and dK += dS^T Q (dout, q MN-major).
//                          These two products stay in flight while the next
//                          part's scores are issued (wgmma groups complete
//                          in order), so a part waits once, not twice. A
//                          tile's lse and delta are read from device memory
//                          while its first products run, one value a
//                          thread, into a per-warpgroup buffer (two tiles
//                          deep, behind a named barrier).
// The streamed operands (k and v tiles, or q and dout tiles) arrive through
// a ring of FA_STAGES stages by TMA, from a 3-D map per operand: dims (D, L,
// B) with the operand's row stride, box (dh, 64, 1), so a box past L
// arrives as zeros and a column slice of a [B, L, 3D] qkv is read as it
// is. Each stage has a `full` mbarrier (the producer's expect-tx and the
// bytes) and an `empty` one that each consumer warp arrives on after its
// last wgmma on the stage has completed (wgmma.wait_group waits only for
// the calling thread's wgmma, so every warp arrives). The block's thread 0
// is the producer: it loads the first FA_STAGES tiles, then, after each
// tile, refills the stage of the tile before, once its `empty` barrier has
// completed, so it waits only on a warpgroup that lags by a whole tile. No
// pass is bounded by L. (lse and delta went through the ring by a 1-D f32
// TMA map at first: the dK/dV pass then stopped on an illegal instruction
// on the card, at every shape; the device-memory reads replaced it.)
// Grid: one block per (frame-head, group of n_wg 64-row tiles), with n_wg = 2
// consumer warpgroups a block where that keeps as many warpgroups on an SM
// as n_wg = 1 (cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once per
// kernel): the two share every ring tile, which halves the tiles read from
// L2. A warpgroup whose tile lies wholly past L leaves at once (the `empty`
// barriers count the live ones). On an NVIDIA H100 80GB HBM3 (700 W), ptxas
// registers, blocks an SM at one / two warpgroups (`ring_info`, printed by
// chip_smoke.py's build phase) and the warpgroups a block takes:
//   attention_fwd       dh 16:  88 regs, 5 / 2, one; dh 32:  98, 4 / 2, two;
//                       dh 64: 122, 3 / 2, two
//   attention_bwd_dq    dh 16:  82, 5 / 2, one;      dh 32:  98, 4 / 2, two;
//                       dh 64: 130, 3 / 1, one
//   attention_bwd_dkdv  dh 16:  98, 4 / 2, two;      dh 32: 122, 4 / 2, two;
//                       dh 64: 170, 2 / 1, two
// The ring takes ring_smem_bytes (17.1 KB to 65.1 KB, whatever L), so
// registers, not shared memory, bound the blocks an SM holds.
// Ragged edges: a last tile of at most 16 keys (queries, in the dK/dV pass)
// runs 16 wide (m64n16k16); a wider one masks its columns past L to a -inf
// score (p = 0) and skips the exp2 of its dead 16-column groups. A warp whose
// 16 rows all lie past L does no softmax work (its P and dS are zero), but
// every wgmma is issued by the whole warpgroup on every path: one under a
// branch ptxas takes for divergent is serialized. Rows past L: queries read
// as zero; in the backward their lse is +inf and their delta 0, so P = dS =
// 0. No pass stores a row past L: out, dq, dk and dv are [B, L, D].
//
// What bounds it on the card: per score element the forward does 4 dh tensor
// FLOPs (Q K^T and P V) and one exp2, the backward 10 dh FLOPs (recompute, dP,
// dV, dQ, dK) and two exp2 (one per pass). At dh = 16 that is 64 FLOPs per
// exp2 in the forward; the H100's special-function units give 16 exp2 per
// clock per SM (~4.2e12/s at 1.98 GHz) against 989e12 dense bf16 FLOP/s, so
// the exponentials, not the tensor cores, set the floor at this width (0.51
// ms per pass at B = 256, L = 1025, H = 8, against 0.14 ms of forward FLOPs).
// Bytes are small: q, k, v and out once each. Like K1's core, each
// warpgroup runs its tile's chain in turn (Q K^T, wait, softmax, P V, wait),
// so its latency and the warpgroups an SM holds bound it (PERF.md §6 has
// each kernel's time at that shape beside these floors).

#include "attention_core.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int FA_WG = 2;      // the most consumer warpgroups of a block
constexpr int FA_STAGES = 4;  // ring depth
constexpr int FA_T = CORE_KT;  // rows of every tile: queries, keys
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of a ring: 1 KB of alignment (the swizzle's repeat), then
// per stage two bf16 tiles [64][dh] and two mbarriers.
// flash_attention.ring_smem_bytes repeats it for the host-side tests.
__host__ __device__ constexpr size_t ring_smem_bytes(int dh) {
  return 1024 + (size_t)FA_STAGES * (2 * FA_T * dh * 2 + 2 * 8);
}

// A block's frame-head and its 64-row tiles: tiles row0, row0 + 64, ...
// go to warpgroups 0, 1, ...; n_live of them hold a row < L.
struct Slot {
  int b, h, bh, row0, n_live;
};

__device__ __forceinline__ Slot slot_of(int L, int H) {
  const int n_wg = blockDim.x >> 7;
  const int n_rt = (L + FA_T - 1) / FA_T;
  const int groups = (n_rt + n_wg - 1) / n_wg;
  Slot sl;
  sl.bh = blockIdx.x / groups;
  sl.b = sl.bh / H;
  sl.h = sl.bh % H;
  sl.row0 = (int)(blockIdx.x % groups) * n_wg * FA_T;
  sl.n_live = min(n_wg, (L - sl.row0 + FA_T - 1) / FA_T);
  return sl;
}

// The ring's barriers: `full` takes the producer's one arrival (with its
// expect-tx), `empty` one arrival from each warp of the live warpgroups.
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int n_live) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < FA_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * n_live);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// A consumer warp is done with a stage: its wgmma on it have completed
// (each lane passed wgmma.wait_group), so lane 0 arrives for the warp.
__device__ __forceinline__ void ring_release(uint64_t* empty, int stage) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[stage]);
}

// Thread 0, after tile `kt`: refill the stage of tile kt - 1 with tile
// kt - 1 + FA_STAGES once every live warp has released it. load(j) issues
// tile j's TMA on its stage's `full` barrier.
template <class Load>
__device__ __forceinline__ void ring_refill(uint64_t* empty, int kt, int n_t, Load load) {
  const int j = kt - 1;
  if (threadIdx.x == 0 && j >= 0 && j + FA_STAGES < n_t) {
    mbar_wait(&empty[j % FA_STAGES], (j / FA_STAGES) & 1);
    load(j + FA_STAGES);
  }
  __syncwarp();
}

// A fragments (warp `warp`'s 16 rows r_lo = r0 + 16 warp + g and r_hi =
// r_lo + 8, DH columns) of one head in device memory, row stride ld; rows
// >= L are zero.
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

// Store a warpgroup accumulator [64 x DH] times `scale` as bf16 rows r_lo,
// r_hi (those < L) of one head: dst + r * D.
template <int DH>
__device__ __forceinline__ void store_rows(const float* acc, float scale, bf16* dst, int D,
                                           int r_lo, int r_hi, int L, int t) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    bf16* p = dst + j * 8 + 2 * t;
    if (r_lo < L)
      *reinterpret_cast<uint32_t*>(p + (long long)r_lo * D) =
          pack_bf16x2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (r_hi < L)
      *reinterpret_cast<uint32_t*>(p + (long long)r_hi * D) =
          pack_bf16x2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// Two score-like products of one tile, issued together and waited for:
// c0 = A0 B0^T and c1 = A1 B1^T over DH, A from registers, B0 and B1 the
// K-major tiles at b0 and b1. The wait also completes every wgmma the
// warpgroup issued before (groups complete in order).
template <int DH, int NT>
__device__ __forceinline__ void two_products(float* c0, float* c1, const uint32_t (*a0)[4],
                                             const uint32_t (*a1)[4], uint32_t b0,
                                             uint32_t b1) {
  constexpr int SPAN = DH * 2;
  constexpr uint32_t SBO = 8 * SPAN;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    Wgmma<NT>::template rs<0>(c0, a0[kk], smem_desc(b0 + kk * 32, SPAN, SBO, SBO), kk);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    Wgmma<NT>::template rs<0>(c1, a1[kk], smem_desc(b1 + kk * 32, SPAN, SBO, SBO), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<NT / 2>(c0);
  fence_regs<NT / 2>(c1);
}

// Mask the columns >= valid of a score tile to -inf (their p is then 0).
template <int NT>
__device__ __forceinline__ void mask_columns(float* s, int valid, int t) {
  if (valid < NT) {
#pragma unroll
    for (int e = 0; e < NT / 2; ++e)
      if ((e >> 2) * 8 + 2 * t + (e & 1) >= valid) s[e] = -INFINITY;
  }
}

// K5-fwd. grid B * H * ceil(ceil(L / 64) / n_wg) blocks of n_wg warpgroups.
// k_map, v_map: 3-D maps over k and v; q: head h of frame b at q + b * L *
// ldq + h * DH, row stride ldq; out [B, L, D]; lse [B, H, L] (log2).
template <int DH>
__global__ void __launch_bounds__(FA_WG * 128, DH == 64 ? 1 : 2) attention_fwd(
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const bf16* __restrict__ q, int ldq, bf16* __restrict__ out, float* __restrict__ lse, int L,
    int H, float scale2) {
  constexpr int TILE = FA_T * DH * 2;  // bytes of a k or v tile
  extern __shared__ unsigned char fa_raw[];
  unsigned char* smem = fa_raw + ((1024 - (smem_u32(fa_raw) & 1023)) & 1023);
  unsigned char* ks = smem;
  unsigned char* vs = smem + FA_STAGES * TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * FA_STAGES * TILE);
  uint64_t* empty = full + FA_STAGES;
  const Slot sl = slot_of(L, H);
  const int n_kt = (L + FA_T - 1) / FA_T;
  auto load = [&](int j) {
    const int st = j % FA_STAGES;
    mbar_expect_tx(&full[st], 2 * TILE);
    tma_load_3d(ks + st * TILE, &k_map, &full[st], sl.h * DH, j * FA_T, sl.b);
    tma_load_3d(vs + st * TILE, &v_map, &full[st], sl.h * DH, j * FA_T, sl.b);
  };
  ring_init(full, empty, sl.n_live);
  if (threadIdx.x == 0)
    for (int j = 0; j < min(FA_STAGES, n_kt); ++j) load(j);

  // warpgroup and warp indices broadcast from lane 0, so that ptxas sees
  // them warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg >= sl.n_live) return;
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = sl.row0 + wg * FA_T;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const bool live = q0 + warp * 16 < L;  // warp-uniform
  uint32_t qa[DH / 16][4];
  load_a_global<DH>(qa, q + (long long)sl.b * L * ldq + sl.h * DH, ldq, r_lo, r_hi, L, t);
  float s[32] = {};
  float o[DH / 2] = {};
  float lsum[2] = {0.f, 0.f};
  float m_lo = -INFINITY, m_hi = -INFINITY;
  const uint32_t ks_addr = smem_u32(ks), vs_addr = smem_u32(vs);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % FA_STAGES;
    mbar_wait(&full[st], (kt / FA_STAGES) & 1);
    const int valid = L - kt * FA_T;  // keys of this tile, uniform
    const uint32_t k_tile = ks_addr + st * TILE, v_tile = vs_addr + st * TILE;
    if (valid <= 16)
      core_tile<DH, false, 16, true>(s, o, lsum, m_lo, m_hi, qa, k_tile, v_tile, valid, live, t,
                                     scale2);
    else
      core_tile<DH, false, FA_T, true>(s, o, lsum, m_lo, m_hi, qa, k_tile, v_tile, valid, live,
                                       t, scale2);
    ring_release(empty, st);
    ring_refill(empty, kt, n_kt, load);
  }
  const float l_lo = quad_sum(lsum[0]), l_hi = quad_sum(lsum[1]);
  const int D = H * DH;
  bf16* ob = out + (long long)sl.b * L * D + sl.h * DH + 2 * t;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (r_lo < L)
      *reinterpret_cast<uint32_t*>(ob + (long long)r_lo * D + j * 8) =
          pack_bf16x2(o[4 * j] / l_lo, o[4 * j + 1] / l_lo);
    if (r_hi < L)
      *reinterpret_cast<uint32_t*>(ob + (long long)r_hi * D + j * 8) =
          pack_bf16x2(o[4 * j + 2] / l_hi, o[4 * j + 3] / l_hi);
  }
  if (t == 0) {
    float* lb = lse + (long long)sl.bh * L;
    if (r_lo < L) lb[r_lo] = m_lo * scale2 + log2f(l_lo);
    if (r_hi < L) lb[r_hi] = m_hi * scale2 + log2f(l_hi);
  }
}

// One key tile of the dQ pass for a warpgroup's 64 query rows: NT = 64
// keys, or 16 for a last tile of at most 16, in parts of NC <= 32 keys as
// the dK/dV pass takes its queries (dkdv_tile). s, dp: scratch for S and
// dP; sa: dS as A fragments; acc: dQ; ne_*: -lse of the thread's rows,
// d_*: their delta. Each part's dQ products are left in flight; the stage
// of the tile before (`prev`, -1 for none) is released after this tile's
// first wait.
template <int DH, int NT>
__device__ __forceinline__ void dq_tile(float* s, float* dp, uint32_t (*sa)[4], float* acc,
                                        const uint32_t (*qa)[4], const uint32_t (*da)[4],
                                        uint32_t k_tile, uint32_t v_tile, uint64_t* empty,
                                        int prev, int valid, bool live, int t, float ne_lo,
                                        float ne_hi, float d_lo, float d_hi, float scale2) {
  constexpr int SPAN = DH * 2;
  constexpr uint32_t SBO = 8 * SPAN;
  constexpr int NC = NT < 32 ? NT : 32;  // keys a part
  constexpr int NG = NC / 16;
#pragma unroll
  for (int part = 0; part < NT / NC; ++part) {
    const int c0 = part * NC;
    two_products<DH, NC>(s, dp, qa, da, k_tile + c0 * SPAN, v_tile + c0 * SPAN);
    if (part == 0 && prev >= 0) ring_release(empty, prev);
    if (live) {
      const int left = valid - c0;  // live keys from c0, uniform
      const int groups = left >= NC ? NG : left > 0 ? (left + 15) >> 4 : 0;
      mask_columns<NC>(s, left, t);
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        float ds[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool hi = i & 2;
          const float p = q < groups ? exp2_sfu(fmaf(s[8 * q + i], scale2, hi ? ne_hi : ne_lo))
                                     : 0.f;
          ds[i] = p * (dp[8 * q + i] - (hi ? d_hi : d_lo));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[q][i] = pack_bf16x2(ds[2 * i], ds[2 * i + 1]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[q][i] = 0u;
    }
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < NG; ++q)
      Wgmma<DH>::template rs<1>(acc, sa[q],
                                smem_desc(k_tile + (c0 + 16 * q) * SPAN, SPAN, SBO, SBO), 1);
    wgmma_commit();
  }
}

// K5-bwd, query-major pass. grid as K5-fwd's. Writes delta [B, H, L] and dq
// [B, L, D] for its rows; out and dout are [B, L, D].
template <int DH>
__global__ void __launch_bounds__(FA_WG * 128, DH == 16 ? 2 : 1) attention_bwd_dq(
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const bf16* __restrict__ q, int ldq, const bf16* __restrict__ out,
    const bf16* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
    bf16* __restrict__ dq, int L, int H, float scale2, float scale) {
  constexpr int TILE = FA_T * DH * 2;
  extern __shared__ unsigned char fa_raw[];
  unsigned char* smem = fa_raw + ((1024 - (smem_u32(fa_raw) & 1023)) & 1023);
  unsigned char* ks = smem;
  unsigned char* vs = smem + FA_STAGES * TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * FA_STAGES * TILE);
  uint64_t* empty = full + FA_STAGES;
  const Slot sl = slot_of(L, H);
  const int n_kt = (L + FA_T - 1) / FA_T;
  auto load = [&](int j) {
    const int st = j % FA_STAGES;
    mbar_expect_tx(&full[st], 2 * TILE);
    tma_load_3d(ks + st * TILE, &k_map, &full[st], sl.h * DH, j * FA_T, sl.b);
    tma_load_3d(vs + st * TILE, &v_map, &full[st], sl.h * DH, j * FA_T, sl.b);
  };
  ring_init(full, empty, sl.n_live);
  if (threadIdx.x == 0)
    for (int j = 0; j < min(FA_STAGES, n_kt); ++j) load(j);

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg >= sl.n_live) return;
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = sl.row0 + wg * FA_T;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const bool live = q0 + warp * 16 < L;
  const int D = H * DH;
  const long long frame = (long long)sl.b * L * D + sl.h * DH;

  uint32_t qa[DH / 16][4], da[DH / 16][4];
  load_a_global<DH>(qa, q + (long long)sl.b * L * ldq + sl.h * DH, ldq, r_lo, r_hi, L, t);
  load_a_global<DH>(da, dout + frame, D, r_lo, r_hi, L, t);
  // delta of rows r_lo, r_hi: this thread's 4 * DH/16 columns of each, then
  // the quad's sum
  float d_lo = 0.f, d_hi = 0.f;
  {
    uint32_t oa[DH / 16][4];
    load_a_global<DH>(oa, out + frame, D, r_lo, r_hi, L, t);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&da[kk][e]));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&oa[kk][e]));
        (e & 1 ? d_hi : d_lo) += x.x * y.x + x.y * y.y;
      }
  }
  d_lo = quad_sum(d_lo);
  d_hi = quad_sum(d_hi);
  const float* lb = lse + (long long)sl.bh * L;
  const float ne_lo = r_lo < L ? -lb[r_lo] : -INFINITY, ne_hi = r_hi < L ? -lb[r_hi] : -INFINITY;
  if (t == 0) {
    if (r_lo < L) delta[(long long)sl.bh * L + r_lo] = d_lo;
    if (r_hi < L) delta[(long long)sl.bh * L + r_hi] = d_hi;
  }

  float s[16] = {}, dp[16] = {};
  uint32_t sa[2][4];
  float acc[DH / 2] = {};
  const uint32_t ks_addr = smem_u32(ks), vs_addr = smem_u32(vs);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % FA_STAGES;
    mbar_wait(&full[st], (kt / FA_STAGES) & 1);
    const int valid = L - kt * FA_T;
    const uint32_t k_tile = ks_addr + st * TILE, v_tile = vs_addr + st * TILE;
    const int prev = kt > 0 ? (kt - 1) % FA_STAGES : -1;
    if (valid <= 16)
      dq_tile<DH, 16>(s, dp, sa, acc, qa, da, k_tile, v_tile, empty, prev, valid, live, t,
                      ne_lo, ne_hi, d_lo, d_hi, scale2);
    else
      dq_tile<DH, FA_T>(s, dp, sa, acc, qa, da, k_tile, v_tile, empty, prev, valid, live, t,
                        ne_lo, ne_hi, d_lo, d_hi, scale2);
    ring_refill(empty, kt, n_kt, load);  // the stage of tile kt - 1, released above
  }
  wgmma_wait<0>();
  fence_regs<DH / 2>(acc);
  store_rows<DH>(acc, scale, dq + frame, D, r_lo, r_hi, L, t);
}

// One query tile of the dK/dV pass for a warpgroup's 64 key rows: NT = 64
// queries, or 16 for a last tile of at most 16, in parts of NC <= 32
// columns (m64n32k16 or m64n16k16), so that S^T and dP^T take 16
// registers a thread each: the 64-wide tile spilled at d_head 16 and 64
// under the register budget of two blocks an SM. st, dpt: scratch for S^T
// and dP^T; pa, sa: P^T and dS^T as A fragments; dka, dva: dK, dV. Each
// part's dV and dK products are left in flight: the next part's wait
// (wgmma groups complete in order) or the caller's completes them, so the
// stage of the tile before (`prev`, -1 for none) is released after this
// tile's first wait. `stat` is this thread's share of the tile's -lse and
// delta (thread i of the warpgroup: -lse of query i, or delta of query
// i - 64; 0 past L), read from device memory before the call so that the
// load overlaps the first products; it is stored at `stat_dst` in the
// warpgroup's buffer, whose [64] -lse and [64] delta (ne_s, d_s) the
// warpgroup reads by column after its named barrier `bar`.
template <int DH, int NT>
__device__ __forceinline__ void dkdv_tile(float* st, float* dpt, uint32_t (*pa)[4],
                                          uint32_t (*sa)[4], float* dka, float* dva,
                                          const uint32_t (*ka)[4], const uint32_t (*va)[4],
                                          uint32_t q_tile, uint32_t do_tile, uint64_t* empty,
                                          int prev, float stat, float* stat_dst, int bar,
                                          const float* ne_s, const float* d_s, int valid,
                                          bool live, int t, float scale2) {
  constexpr int SPAN = DH * 2;
  constexpr uint32_t SBO = 8 * SPAN;
  constexpr int NC = NT < 32 ? NT : 32;  // columns a part
  constexpr int NG = NC / 16;
#pragma unroll
  for (int part = 0; part < NT / NC; ++part) {
    const int c0 = part * NC;
    two_products<DH, NC>(st, dpt, ka, va, q_tile + c0 * SPAN, do_tile + c0 * SPAN);
    if (part == 0) {
      if (prev >= 0) ring_release(empty, prev);
      *stat_dst = stat;
      named_bar_sync(bar, 128);
    }
    if (live) {
      const int left = valid - c0;  // live columns from c0, uniform
      const int groups = left >= NC ? NG : left > 0 ? (left + 15) >> 4 : 0;
      mask_columns<NC>(st, left, t);
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        float p[8], ds[8];
#pragma unroll
        for (int u = 0; u < 2; ++u) {  // the group's two 8-column blocks
          const int c = c0 + (2 * q + u) * 8 + 2 * t;
          const float2 e = *reinterpret_cast<const float2*>(ne_s + c);
          const float2 d = *reinterpret_cast<const float2*>(d_s + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int x = 4 * u + i;
            p[x] = q < groups ? exp2_sfu(fmaf(st[8 * q + x], scale2, i & 1 ? e.y : e.x)) : 0.f;
            ds[x] = p[x] * (dpt[8 * q + x] - (i & 1 ? d.y : d.x));
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[q][i] = pack_bf16x2(p[2 * i], p[2 * i + 1]);
          sa[q][i] = pack_bf16x2(ds[2 * i], ds[2 * i + 1]);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[q][i] = sa[q][i] = 0u;
    }
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const uint32_t r = (c0 + 16 * q) * SPAN;
      Wgmma<DH>::template rs<1>(dva, pa[q], smem_desc(do_tile + r, SPAN, SBO, SBO), 1);
      Wgmma<DH>::template rs<1>(dka, sa[q], smem_desc(q_tile + r, SPAN, SBO, SBO), 1);
    }
    wgmma_commit();
  }
}

// K5-bwd, key-major pass. grid as K5-fwd's, over key tiles. q_map, do_map:
// 3-D maps over q and dout; lse, delta [B, H, L] f32 (delta from the
// query-major pass). Writes dk and dv [B, L, D] for its key rows.
template <int DH>
__global__ void __launch_bounds__(FA_WG * 128, DH == 16 ? 2 : 1) attention_bwd_dkdv(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, const bf16* __restrict__ k,
    int ldk, const bf16* __restrict__ v, int ldv, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int L, int H, float scale2, float scale) {
  constexpr int TILE = FA_T * DH * 2;
  extern __shared__ unsigned char fa_raw[];
  // each warpgroup's -lse and delta of a query tile, two tiles deep
  __shared__ __align__(16) float stats[FA_WG][2][2 * FA_T];
  unsigned char* smem = fa_raw + ((1024 - (smem_u32(fa_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* dos = smem + FA_STAGES * TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * FA_STAGES * TILE);
  uint64_t* empty = full + FA_STAGES;
  const Slot sl = slot_of(L, H);
  const int n_qt = (L + FA_T - 1) / FA_T;
  auto load = [&](int j) {
    const int st = j % FA_STAGES;
    mbar_expect_tx(&full[st], 2 * TILE);
    tma_load_3d(qs + st * TILE, &q_map, &full[st], sl.h * DH, j * FA_T, sl.b);
    tma_load_3d(dos + st * TILE, &do_map, &full[st], sl.h * DH, j * FA_T, sl.b);
  };
  ring_init(full, empty, sl.n_live);
  if (threadIdx.x == 0)
    for (int j = 0; j < min(FA_STAGES, n_qt); ++j) load(j);

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg >= sl.n_live) return;
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = sl.row0 + wg * FA_T;
  const int c_lo = c0 + warp * 16 + g, c_hi = c_lo + 8;
  const bool live = c0 + warp * 16 < L;
  uint32_t ka[DH / 16][4], va[DH / 16][4];
  load_a_global<DH>(ka, k + (long long)sl.b * L * ldk + sl.h * DH, ldk, c_lo, c_hi, L, t);
  load_a_global<DH>(va, v + (long long)sl.b * L * ldv + sl.h * DH, ldv, c_lo, c_hi, L, t);
  // this thread's share of each tile's statistics: -lse (threads 0-63 of
  // the warpgroup) or delta (64-127) of one query
  const int wt = threadIdx.x & 127, qi = wt & (FA_T - 1);
  const float* stat_src = (wt < FA_T ? lse : delta) + (long long)sl.bh * L + qi;
  const float stat_sign = wt < FA_T ? -1.f : 1.f;

  float st[16] = {}, dpt[16] = {};
  uint32_t pa[2][4], sa[2][4];
  float dka[DH / 2] = {}, dva[DH / 2] = {};
  const uint32_t qs_addr = smem_u32(qs), dos_addr = smem_u32(dos);
  for (int it = 0; it < n_qt; ++it) {
    const int s_ = it % FA_STAGES;
    const int valid = L - it * FA_T;  // queries of this tile
    const float stat = qi < valid ? stat_sign * stat_src[it * FA_T] : 0.f;
    float* buf = stats[wg][it & 1];
    mbar_wait(&full[s_], (it / FA_STAGES) & 1);
    const uint32_t q_tile = qs_addr + s_ * TILE, do_tile = dos_addr + s_ * TILE;
    const int prev = it > 0 ? (it - 1) % FA_STAGES : -1;
    if (valid <= 16)
      dkdv_tile<DH, 16>(st, dpt, pa, sa, dka, dva, ka, va, q_tile, do_tile, empty, prev, stat,
                        buf + wt, 1 + wg, buf, buf + FA_T, valid, live, t, scale2);
    else
      dkdv_tile<DH, FA_T>(st, dpt, pa, sa, dka, dva, ka, va, q_tile, do_tile, empty, prev, stat,
                          buf + wt, 1 + wg, buf, buf + FA_T, valid, live, t, scale2);
    ring_refill(empty, it, n_qt, load);  // the stage of tile it - 1, released above
  }
  wgmma_wait<0>();
  fence_regs<DH / 2>(dva);
  fence_regs<DH / 2>(dka);
  const int D = H * DH;
  const long long fo = (long long)sl.b * L * D + sl.h * DH;
  store_rows<DH>(dka, scale, dk + fo, D, c_lo, c_hi, L, t);
  store_rows<DH>(dva, 1.f, dv + fo, D, c_lo, c_hi, L, t);
}

bool shapes_ok(int B, int L, int H, int D, int ldq, int ldk, int ldv) {
  if (B <= 0 || L <= 0 || H <= 0 || D % H) return false;
  const int dh = D / H;
  if (dh != 16 && dh != 32 && dh != 64) return false;
  // TMA strides are multiples of 16 bytes
  return ldq >= D && ldk >= D && ldv >= D && ldq % 8 == 0 && ldk % 8 == 0 && ldv % 8 == 0;
}

// A kernel's launch shape: its shared memory, the blocks an SM holds at one
// and at two warpgroups, and the warpgroups a block takes: two where that
// holds as many warpgroups on an SM (its ring tiles then serve two query or
// key tiles). Asked once per kernel.
struct Launch {
  size_t smem;
  int occ1, occ2, n_wg;
  cudaError_t err;
};

// PASS 0: attention_fwd<DH>, 1: attention_bwd_dq<DH>, 2: attention_bwd_dkdv<DH>
template <int PASS, int DH>
auto kernel_of() {
  if constexpr (PASS == 0)
    return attention_fwd<DH>;
  else if constexpr (PASS == 1)
    return attention_bwd_dq<DH>;
  else
    return attention_bwd_dkdv<DH>;
}

template <int PASS, int DH>
const Launch& launch_of() {
  static Launch la = {0, 0, 0, 0, cudaSuccess};
  if (!la.n_wg) {
    const auto kernel = kernel_of<PASS, DH>();
    la.smem = ring_smem_bytes(DH);
    la.err = allow_smem(kernel, la.smem);
    if (la.err == cudaSuccess)
      la.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&la.occ1, kernel, 128, la.smem);
    if (la.err == cudaSuccess)
      la.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&la.occ2, kernel, FA_WG * 128,
                                                             la.smem);
    la.n_wg = FA_WG * la.occ2 >= la.occ1 ? FA_WG : 1;
  }
  return la;
}

// Blocks of a pass over ceil(L / 64) tiles of each frame-head.
unsigned grid_of(int B, int H, int L, int n_wg) {
  const int n_rt = (L + FA_T - 1) / FA_T;
  return (unsigned)B * H * ((n_rt + n_wg - 1) / n_wg);
}

// The 3-D TMA map of one bf16 operand: head columns [0, D) of rows ld apart,
// frames L * ld apart; boxes of one head's 64 rows.
bool operand_map(CUtensorMap* map, const void* base, int ld, int B, int L, int D, int dh) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)ld, (uint64_t)ld * L};
  const uint32_t box[3] = {(uint32_t)dh, FA_T, 1};
  return make_map(map, base, 3, dims, strides, box, dh * 2);
}

template <int DH>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, int ldq, int ldk,
        int ldv, int B, int L, int H, cudaStream_t s) {
  CUtensorMap km, vm;
  const int D = H * DH;
  if (!operand_map(&km, k, ldk, B, L, D, DH) || !operand_map(&vm, v, ldv, B, L, D, DH))
    return (int)cudaErrorInvalidValue;
  const Launch& la = launch_of<0, DH>();
  if (la.err != cudaSuccess) return (int)la.err;
  const int n_wg = L > FA_T ? la.n_wg : 1;
  attention_fwd<DH><<<grid_of(B, H, L, n_wg), 128 * n_wg, la.smem, s>>>(
      km, vm, static_cast<const bf16*>(q), ldq, static_cast<bf16*>(out),
      static_cast<float*>(lse), L, H, LOG2E / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <int DH>
int bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
        const void* lse, void* delta, void* dq, void* dk, void* dv, int ldq, int ldk, int ldv,
        int B, int L, int H, cudaStream_t s) {
  const int D = H * DH;
  const float scale2 = LOG2E / sqrtf((float)DH), scale = 1.f / sqrtf((float)DH);
  CUtensorMap km, vm, qm, dom;
  if (!operand_map(&km, k, ldk, B, L, D, DH) || !operand_map(&vm, v, ldv, B, L, D, DH) ||
      !operand_map(&qm, q, ldq, B, L, D, DH) || !operand_map(&dom, dout, D, B, L, D, DH))
    return (int)cudaErrorInvalidValue;
  const Launch& la = launch_of<1, DH>();
  if (la.err != cudaSuccess) return (int)la.err;
  int n_wg = L > FA_T ? la.n_wg : 1;
  attention_bwd_dq<DH><<<grid_of(B, H, L, n_wg), 128 * n_wg, la.smem, s>>>(
      km, vm, static_cast<const bf16*>(q), ldq, static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<bf16*>(dq), L, H, scale2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Launch& lb = launch_of<2, DH>();
  if (lb.err != cudaSuccess) return (int)lb.err;
  n_wg = L > FA_T ? lb.n_wg : 1;
  attention_bwd_dkdv<DH><<<grid_of(B, H, L, n_wg), 128 * n_wg, lb.smem, s>>>(
      qm, dom, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const bf16*>(k), ldk, static_cast<const bf16*>(v), ldv,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, H, scale2, scale);
  return (int)cudaGetLastError();
}

template <int DH>
cudaError_t ring(int pass, int* info) {
  const Launch& la =
      pass == 0 ? launch_of<0, DH>() : pass == 1 ? launch_of<1, DH>() : launch_of<2, DH>();
  info[0] = (int)la.smem;
  info[1] = la.occ1;
  info[2] = la.occ2;
  info[3] = la.n_wg;
  return la.err;
}

}  // namespace

// K5-fwd. q, k, v: bf16, frame b's row i of head h at x + (b*L + i)*ld + h*dh
// (ld a multiple of 8, >= D; x 16-byte aligned); out [B, L, D] bf16; lse
// [B, H, L] f32 (log2). Returns cudaGetLastError(), or cudaErrorInvalidValue
// for shapes it does not take (d_head 16, 32 or 64).
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

// The launch shape of one of K5's kernels (pass 0: attention_fwd, 1:
// attention_bwd_dq, 2: attention_bwd_dkdv) at d_head dh: info[0] its shared
// memory in bytes, info[1] and info[2] the blocks an SM holds at one and two
// warpgroups (cudaOccupancyMaxActiveBlocksPerMultiprocessor), info[3] the
// warpgroups a block takes where L spans two or more 64-row tiles.
extern "C" int vitiq_attention_ring(int pass, int dh, int* info) {
  if (pass < 0 || pass > 2) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return (int)ring<16>(pass, info);
    case 32: return (int)ring<32>(pass, info);
    case 64: return (int)ring<64>(pass, info);
  }
  return (int)cudaErrorInvalidValue;
}
