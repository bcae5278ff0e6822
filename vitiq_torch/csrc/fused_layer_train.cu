// Fused post-norm encoder layer for TRAINING on Hopper (sm_90a): K3, the
// forward and the recompute backward.
//
// Replaces (TPU Pallas kernels of the JAX reference package):
//   K3-fwd  vitiq/ops/pallas/fused_layer_train.py: _fwd_kernel (pallas_call in
//           _run_fwd), the training layer with in-kernel dropout
//   K3-bwd  vitiq/ops/pallas/fused_layer_train.py: _bwd_kernel in its
//           recompute regime (pallas_call in _fused_train_layer_bwd): dx and
//           all 12 weight, bias and LN gradients
//
// Function, per layer, on a bf16 [B, L, D] activation (D = 128):
//   qkv = bf16(x Wqkv + bqkv)                   Wqkv unscaled
//   qs  = bf16(q * log2(e)/sqrt(dh))             scaled here, as the TPU kernel
//   p   = bf16(exp2(qs.k - max)), attn = bf16(sum p v / sum p)  over L keys
//   x1  = bf16(LN1((attn Wo + bo) * m1 + x))     LN: biased variance, eps 1e-12
//   h   = bf16(relu(x1 W1 + b1) * m2)
//   y   = bf16(LN2((h W2 + b2) * m3 + x1))
// m1..m3 are the dropout multipliers keep / (1 - rate) at the three sites.
//
// Dropout: the TPU kernel draws its masks from the TPU PRNG, which nothing
// off the TPU reproduces. These kernels take K8's counter-based hash instead
// (vitiq/ops/pallas/train_xpack.py: _hash_mask, _site_salt): one bit per
// absolute (frame, token, lane) position, salted by (layer, site), so the
// forward and the backward regenerate the same mask under any block shape.
// The plain PyTorch version computes the same bits.
//
// Backward (recompute regime: the forward saves only x, the seed and the
// weights). The recompute runs the forward's stages again, keeping what the
// gradients need: qkv, attn, the softmax row max and sum, x1, LN1's
// normalized input and 1/std, h, LN2's normalized input and 1/std. Then, as
// the TPU kernel's body does: LN2 backward, FFN2 (dW2, dh), the ReLU and
// dropout mask, FFN1 (dW1, dx1), LN1 backward, the out-projection (dWo,
// dattn), the attention backward, the QKV projection (dWqkv, dx). The row
// term of the softmax backward comes from the flash identity
// sum_j dP_ij P_ij = dO_i . O_i. The four matrix gradients are handed back
// rounded to the weights' bf16 by the wrapper, as the JAX backward does.
//
// Design: one __global__ launch per stage, on the caller's stream.
//   tgemm<AT, BT, EPI>     WMMA GEMM (bf16 16x16x16 fragments, f32 accumulate)
//                          over 64 x 128 output tiles with a two-stage cp.async
//                          pipeline: A or A^T times B or W^T, and a fused
//                          epilogue per stage (bias, ReLU, dropout, residual,
//                          LayerNorm forward or backward, column partial sums)
//   train_attention_fwd    one block per (frame, head), K1's register-fragment
//                          core (mma.sync), q scaled in the kernel, optionally
//                          writing each row's max and sum for the backward
//   train_attention_bwd    one block per (frame, head): q, k, v, dO and their
//                          transposes in shared memory; a query-major pass
//                          (dQ) and a key-major pass (dK, dV) that recompute P
//                          and dS in mma.sync fragments, never in memory
//   ln_bwd_rows            LN2 backward, one warp per row
//   reduce_rows            column sums of partials, in a fixed order
// Weight gradients are sums over the B*L rows. The TPU kernel carries them in
// f32 scratch across its sequential grid; blocks here run in no order, so each
// is a transposed-A GEMM split over the rows into f32 partials (split-K), and
// every bias and LN gradient is a set of per-block column partial sums; a
// second pass (reduce_rows) adds the partials in a fixed order. No atomics:
// the gradients are the same bits run to run.
//
// What bounds it on the card: at the ViT flagship shape (L = 129, F = 512)
// a layer is ~51 MFLOP of GEMMs per frame forward and ~3x that backward
// (recompute, two products per weight), against ~0.8 MB (forward) and ~4 MB
// (backward, f32 LN inputs and residual gradients included) of activation
// traffic per frame through device memory: about 40 FLOP per byte, far under
// the bf16 ridge (~295), so bytes bound it, and the f32 intermediates of the
// backward most of all. This first port keeps them in device memory and runs
// unpipelined WMMA tiles; wgmma, TMA and fusing the FFN hidden are later work.
//
// TPU schedule knobs of K3 and what computes each here (all are the same
// function):
//   VITIQ_TRAIN_PB (recompute / reuse the probability tiles)
//                          -> train_attention_bwd recomputes P from q and k in
//                             both of its passes; nothing is cached.
//   VITIQ_TRAIN_EPI (wide / head divide)    -> one f32 divide per output.
//   VITIQ_TRAIN_DW (merged / batched dW)    -> one split-K GEMM over all rows.
//   VITIQ_TRAIN_DWPACK (0 / p1 / full)      -> four separate dW GEMMs.
//   VITIQ_TRAIN_FPA, _FPG, _FPV, _ATTNBWD   -> train_attention_bwd: heads are
//       independent blocks, so neither the full-product packing of heads nor
//       the block-diagonal scratch nor the per-head chain has a counterpart;
//       the softmax backward is one fragment per 16 x 16 tile.
//   VITIQ_TRAIN_RFWD, _RBWD (xpack cores)   -> train_attention_fwd.
//   VITIQ_TRAIN_TAIL (VPU tail keys)        -> keys are masked per 8-key
//       fragment column; activations stay [B, L, D] unpadded.
//   VITIQ_TRAIN_LPC (layers per call), VITIQ_TRAIN_G (frames per block)
//                                           -> one host call per layer; the
//       GEMMs tile B*L rows, attention is one block per frame and head.
//   VITIQ_TRAIN_STASH (K4)                  -> not here: this is the recompute
//       regime only.
//   VITIQ_TRAIN_PROBE                       -> timing-only surgery; none.

#include <mma.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int TBM = 64;    // GEMM tile rows
constexpr int TBN = 128;   // GEMM tile columns (== D for the LayerNorm epilogues)
constexpr int TBK = 32;    // GEMM tile depth
constexpr int THREADS = 256;  // 8 warps: 2 x 4 warp tiles of 32 x 32
constexpr int AR_LD = TBK + 8;  // A tile [TBM][AR_LD]
constexpr int AT_LD = TBM + 8;  // A^T tile [TBK][AT_LD] (depth rows)
constexpr int BR_LD = TBN + 8;  // B tile [TBK][BR_LD]
constexpr int BT_LD = TBK + 8;  // W tile [TBN][BT_LD] for B = W^T
constexpr int C_LD = TBN + 4;
constexpr int C_BYTES = TBM * C_LD * (int)sizeof(float);
constexpr int MAX_PIPE_BYTES = 2 * (TBM * AR_LD + TBN * BT_LD) * (int)sizeof(bf16);
constexpr int GEMM_SMEM = MAX_PIPE_BYTES > C_BYTES ? MAX_PIPE_BYTES : C_BYTES;
constexpr int ATTN_WARPS = 4;
constexpr float LN_EPS = 1e-12f;

template <bool AT>
__host__ __device__ constexpr int a_tile() { return AT ? TBK * AT_LD : TBM * AR_LD; }
template <bool BT>
__host__ __device__ constexpr int b_tile() { return BT ? TBN * BT_LD : TBK * BR_LD; }

// ---------------------------------------------------------------------------
// dropout: keep/(1-rate) from a stateless hash of the absolute position
// ---------------------------------------------------------------------------

struct Drop {
  uint32_t seed_salt;  // step seed + the (layer, site) salt
  uint32_t thresh;     // dropped iff (hash & 0x7fffffff) < thresh
  float scale;         // 1 / (1 - rate)
  int L;               // tokens per frame: row r is frame r / L, token r % L
  int on;
};

// _hash_mask of train_xpack.py: murmur3's fmix32 over the mixed position.
__device__ __forceinline__ uint32_t position_hash(uint32_t b, uint32_t l, uint32_t w,
                                                  uint32_t seed_salt) {
  uint32_t h = (b * 0x9E3779B1u) ^ (l * 0x85EBCA77u) ^ (w * 0xC2B2AE3Du);
  h += seed_salt;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float keep_scale(const Drop& d, long long row, int col) {
  if (!d.on) return 1.f;
  const uint32_t h = position_hash((uint32_t)(row / d.L), (uint32_t)(row % d.L),
                                   (uint32_t)col, d.seed_salt);
  return (h & 0x7fffffffu) >= d.thresh ? d.scale : 0.f;
}

// ---------------------------------------------------------------------------
// GEMM with fused epilogues
// ---------------------------------------------------------------------------

enum Epi {
  kBias = 0,       // out = bf16(acc + bias)
  kReluDrop = 1,   // out = bf16(relu(acc + bias) * mask)
  kLnFwd = 2,      // z = (acc + bias) * mask + res; out = bf16(LN(z)); xh, 1/std
  kStore = 3,      // out = bf16(acc)
  kDpre = 4,       // d = h > 0 ? acc * mask : 0; out = bf16(d); column sums of d
  kLnBwd = 5,      // g = acc + res32; dz = LN backward of g; out32 = dz;
                   // out = bf16(dz * mask); column sums of g*xh, g, dz*mask
  kResOut = 6,     // out = bf16(acc + res32)
  kPartial = 7,    // out32[split] = acc (split-K partial of a weight gradient)
};

struct TGemm {
  const bf16* a;  // A row r at a + r*lda; with AT, depth row k of A^T at a + k*lda
  long long lda;
  const bf16* b;  // B depth row k at b + k*ldb; with BT, W row n at b + n*ldb
  long long ldb;
  long long m;        // output rows
  long long k;        // depth
  long long k_chunk;  // depth of one split (blockIdx.y), a multiple of TBK
  int n_tiles;        // TBN-wide column tiles
  long long ldo;      // row stride of every [row][column] operand of the epilogue
  const float* bias;
  bf16* out;
  float* out32;
  const bf16* res;     // kLnFwd: bf16 residual; kDpre: the FFN hidden h
  const float* res32;  // kLnBwd, kResOut: f32 residual
  const float* xh;     // kLnBwd: LN's normalized input
  const float* rstd;   // kLnBwd: LN's 1/std per row
  float* xh_out;       // kLnFwd (may be null)
  float* rstd_out;     // kLnFwd (may be null)
  const float* gamma;
  const float* beta;
  float* part;         // column partial sums [sum][row tile][ldo]
  Drop drop;
};

// C tile (64 x 128) = A B, one tile per block; blockIdx.x = row tile *
// n_tiles + column tile, blockIdx.y = split of the depth. The k loop is a
// two-stage cp.async pipeline; the f32 tile then reuses the shared memory for
// the epilogue.
template <bool AT, bool BT, int EPI>
__global__ void __launch_bounds__(THREADS) tgemm(TGemm p) {
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  constexpr int A_TILE = a_tile<AT>(), B_TILE = b_tile<BT>();
  using LayoutA = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long rt = blockIdx.x / p.n_tiles;
  const long long m0 = rt * TBM;
  const int n0 = (int)(blockIdx.x % p.n_tiles) * TBN;
  const int wm = warp >> 2, wn = warp & 3;
  const long long kb = (long long)blockIdx.y * p.k_chunk;
  const long long ke = min(p.k, kb + p.k_chunk);

  auto load_stage = [&](int stage, long long k0) {
    bf16* As = stages + stage * (A_TILE + B_TILE);
    bf16* Bs = As + A_TILE;
    if constexpr (AT) {  // depth rows k0..k0+31, output rows m0..m0+63
      const int r = tid >> 3, c = (tid & 7) * 8;
      const bool in = k0 + r < ke;
      cp_async16(As + r * AT_LD + c, p.a + (in ? k0 + r : 0) * p.lda + m0 + c, in ? 16 : 0);
    } else {
      const int r = tid >> 2, c = (tid & 3) * 8;
      const long long gm = m0 + r;
      const bool in = gm < p.m;
      cp_async16(As + r * AR_LD + c, p.a + (in ? gm : 0) * p.lda + k0 + c, in ? 16 : 0);
    }
    if constexpr (BT) {  // W rows n0..n0+127, depth k0..k0+31
#pragma unroll
      for (int i = tid; i < TBN * TBK / 8; i += THREADS) {
        const int r = i >> 2, c = (i & 3) * 8;
        cp_async16(Bs + r * BT_LD + c, p.b + (long long)(n0 + r) * p.ldb + k0 + c, 16);
      }
    } else {
#pragma unroll
      for (int i = tid; i < TBK * TBN / 8; i += THREADS) {
        const int r = i >> 4, c = (i & 15) * 8;
        const bool in = k0 + r < ke;
        cp_async16(Bs + r * BR_LD + c, p.b + (in ? k0 + r : 0) * p.ldb + n0 + c, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (int)((ke - kb + TBK - 1) / TBK);
  if (nk > 0) load_stage(0, kb);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, kb + (long long)(kt + 1) * TBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* As = stages + (kt & 1) * (A_TILE + B_TILE);
    const bf16* Bs = As + A_TILE;
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (AT)
          wmma::load_matrix_sync(fa[i], As + kk * AT_LD + wm * 32 + i * 16, AT_LD);
        else
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * AR_LD + kk, AR_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (BT)
          wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * BT_LD + kk, BT_LD);
        else
          wmma::load_matrix_sync(fb[j], Bs + kk * BR_LD + wn * 32 + j * 16, BR_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();

  const long long RT = (p.m + TBM - 1) / TBM;
  if constexpr (EPI == kPartial) {
    float* dst = p.out32 + (long long)blockIdx.y * p.m * p.ldo;
    for (int i = tid; i < TBM * TBN / 4; i += THREADS) {
      const int r = i / (TBN / 4), c = (i % (TBN / 4)) * 4;
      const long long gm = m0 + r;
      if (gm >= p.m) continue;
      *reinterpret_cast<float4*>(dst + gm * p.ldo + n0 + c) =
          make_float4(Cs[r * C_LD + c], Cs[r * C_LD + c + 1], Cs[r * C_LD + c + 2],
                      Cs[r * C_LD + c + 3]);
    }
  } else if constexpr (EPI == kLnFwd || EPI == kLnBwd) {
    // one warp per row, 4 columns per lane; the tile holds the whole row (D = TBN)
    float cs[3][TBN / 32] = {};  // kLnBwd column sums: g*xh, g, dz*mask
    for (int r = warp; r < TBM; r += THREADS / 32) {
      const long long gm = m0 + r;
      if (gm >= p.m) break;  // warp-uniform
      const long long row = gm * p.ldo;
      float v[TBN / 32];
      if constexpr (EPI == kLnFwd) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < TBN / 32; ++t) {
          const int c = lane + 32 * t;
          v[t] = (Cs[r * C_LD + c] + p.bias[c]) * keep_scale(p.drop, gm, c) +
                 __bfloat162float(p.res[row + c]);
          s += v[t];
        }
        const float mean = warp_sum(s) * (1.0f / TBN);
        float q = 0.f;
#pragma unroll
        for (int t = 0; t < TBN / 32; ++t) {
          const float d = v[t] - mean;
          q += d * d;
        }
        const float rstd = rsqrtf(warp_sum(q) * (1.0f / TBN) + LN_EPS);
#pragma unroll
        for (int t = 0; t < TBN / 32; ++t) {
          const int c = lane + 32 * t;
          const float xh = (v[t] - mean) * rstd;
          if (p.out) p.out[row + c] = __float2bfloat16(p.gamma[c] * xh + p.beta[c]);
          if (p.xh_out) p.xh_out[row + c] = xh;
        }
        if (p.rstd_out && lane == 0) p.rstd_out[gm] = rstd;
      } else {
        float xh[TBN / 32], s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int t = 0; t < TBN / 32; ++t) {
          const int c = lane + 32 * t;
          v[t] = Cs[r * C_LD + c] + p.res32[row + c];
          xh[t] = p.xh[row + c];
          const float dyg = v[t] * p.gamma[c];
          s1 += dyg;
          s2 += dyg * xh[t];
          cs[0][t] += v[t] * xh[t];
          cs[1][t] += v[t];
        }
        const float m1 = warp_sum(s1) * (1.0f / TBN), m2 = warp_sum(s2) * (1.0f / TBN);
        const float rstd = p.rstd[gm];
#pragma unroll
        for (int t = 0; t < TBN / 32; ++t) {
          const int c = lane + 32 * t;
          const float dz = rstd * (v[t] * p.gamma[c] - m1 - xh[t] * m2);
          const float da = dz * keep_scale(p.drop, gm, c);
          cs[2][t] += da;
          p.out32[row + c] = dz;
          p.out[row + c] = __float2bfloat16(da);
        }
      }
    }
    if constexpr (EPI == kLnBwd) {
      __syncthreads();  // every warp is done with Cs
      float* red = Cs;  // [warp][3][TBN]
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int t = 0; t < TBN / 32; ++t) red[(warp * 3 + s) * TBN + lane + 32 * t] = cs[s][t];
      __syncthreads();
      for (int i = tid; i < 3 * TBN; i += THREADS) {
        const int s = i / TBN, c = i % TBN;
        float sum = 0.f;
        for (int w = 0; w < THREADS / 32; ++w) sum += red[(w * 3 + s) * TBN + c];
        p.part[(s * RT + rt) * p.ldo + c] = sum;
      }
    }
  } else {
    // 8 consecutive columns per thread, stored as one 16-byte chunk; a
    // thread keeps the same 8 columns for all of its rows
    float colsum[8] = {};
    const int c = (tid % (TBN / 8)) * 8;
    for (int i = tid; i < TBM * TBN / 8; i += THREADS) {
      const int r = i / (TBN / 8);
      const long long gm = m0 + r;
      if (gm >= p.m) continue;
      const long long at = gm * p.ldo + n0 + c;
      uint4 hv = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (EPI == kDpre) hv = *reinterpret_cast<const uint4*>(p.res + at);
      const bf16* h8 = reinterpret_cast<const bf16*>(&hv);
      uint4 packed;
      uint32_t* words = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = n0 + c + e + u;
          float x = Cs[r * C_LD + c + e + u];
          if constexpr (EPI == kBias || EPI == kReluDrop) x += p.bias[col];
          if constexpr (EPI == kReluDrop) x = fmaxf(x, 0.f) * keep_scale(p.drop, gm, col);
          if constexpr (EPI == kDpre) {
            x = __bfloat162float(h8[e + u]) > 0.f ? x * keep_scale(p.drop, gm, col) : 0.f;
            colsum[e + u] += x;
          }
          if constexpr (EPI == kResOut) x += p.res32[at + e + u];
          v[u] = x;
        }
        words[e / 2] = pack_bf16x2(v[0], v[1]);
      }
      *reinterpret_cast<uint4*>(p.out + at) = packed;
    }
    if constexpr (EPI == kDpre) {
      __syncthreads();  // every thread is done with Cs
      float* red = Cs;  // [row group][TBN]
      const int grp = tid / (TBN / 8);
#pragma unroll
      for (int e = 0; e < 8; ++e) red[grp * TBN + c + e] = colsum[e];
      __syncthreads();
      if (tid < TBN) {
        float sum = 0.f;
        for (int g = 0; g < THREADS / (TBN / 8); ++g) sum += red[g * TBN + tid];
        p.part[rt * p.ldo + n0 + tid] = sum;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// attention
// ---------------------------------------------------------------------------

// Shared-memory row strides (bf16 elements): [row][DH + 8] for row-major
// copies, [dim][round16(L) + 8] for transposed ones, padded so that the eight
// rows a warp's fragment loads touch fall on distinct banks.
template <int DH>
__host__ __device__ constexpr int row_ld() { return DH + 8; }
__host__ __device__ __forceinline__ int col_ld(int L) { return round16(L) + 8; }

template <int DH>
__host__ __device__ __forceinline__ size_t attention_fwd_smem_bytes(int L) {
  return ((size_t)round16(L) * row_ld<DH>() + (size_t)DH * col_ld(L)) * sizeof(bf16);
}

// q, k, v, dO as rows, q, k, dO transposed (bf16); row max, row sum and row
// term per query, then the column-sum scratch (f32). The Python gate
// (fused_layer_train.attention_bwd_smem_bytes) uses the same formula.
template <int DH>
__host__ __device__ __forceinline__ size_t attention_bwd_smem_bytes(int L) {
  const size_t lp = round16(L);
  return (4 * lp * row_ld<DH>() + 3 * (size_t)DH * col_ld(L)) * sizeof(bf16) +
         (3 * lp + ATTN_WARPS * 3 * DH) * sizeof(float);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// bf16 pair -> each element times `scale`, rounded back to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return pack_bf16x2(f.x * scale, f.y * scale);
}

// Two 16 x 8 score blocks: the 16 rows of `a` (A fragments over DH) against
// rows [j0, j0 + 16) of the row-major copy `rows`; columns >= L are -inf.
template <int DH>
__device__ __forceinline__ void product_block(float sc[2][4], const uint32_t a[DH / 16][4],
                                              const bf16* rows, int j0, int L, int g, int t,
                                              bool mask) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
    const bf16* r = rows + (j0 + nb * 8 + g) * row_ld<DH>() + 2 * t;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      mma_bf16_16816(sc[nb], a[kk], ld_b32(r + kk * 16), ld_b32(r + kk * 16 + 8));
    if (mask && j0 + 16 > L) {
      const int col = j0 + nb * 8 + 2 * t;
      if (col >= L) sc[nb][0] = sc[nb][2] = -INFINITY;
      if (col + 1 >= L) sc[nb][1] = sc[nb][3] = -INFINITY;
    }
  }
}

// A fragments of rows r0..r0+15 of a row-major shared copy
template <int DH>
__device__ __forceinline__ void load_a(uint32_t a[DH / 16][4], const bf16* rows, int r0, int g,
                                       int t) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const bf16* lo = rows + (r0 + g) * row_ld<DH>() + kk * 16 + 2 * t;
    const bf16* hi = lo + 8 * row_ld<DH>();
    a[kk][0] = ld_b32(lo);
    a[kk][1] = ld_b32(hi);
    a[kk][2] = ld_b32(lo + 8);
    a[kk][3] = ld_b32(hi + 8);
  }
}

// K3's attention forward, one block per (frame b, head h): K1's
// register-fragment core with the q columns of qkv unscaled, scaled here as
// bf16(q * scale2). With `stats`, writes each query row's max (log2 units)
// and sum of bf16 probabilities to stats[((b*H + h)*L + i)*2 + {0, 1}].
template <int DH>
__global__ void __launch_bounds__(ATTN_WARPS * 32) train_attention_fwd(
    const bf16* __restrict__ qkv, bf16* __restrict__ out, float* __restrict__ stats, int L,
    int D, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = round16(L), vld = col_ld(L);
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [lp][row_ld]
  bf16* vt = ks + (size_t)lp * row_ld<DH>();  // [DH][vld]

  const int b = blockIdx.x, h = blockIdx.y, H = gridDim.y;
  const long long row3 = 3LL * D;
  const bf16* base = qkv + (long long)b * L * row3 + (long long)h * DH;
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < lp * CH; i += blockDim.x) {
    const int j = i / CH, c = (i % CH) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (j < L) {
      kv = *reinterpret_cast<const uint4*>(base + j * row3 + D + c);
      vv = *reinterpret_cast<const uint4*>(base + j * row3 + 2 * D + c);
    }
    *reinterpret_cast<uint4*>(ks + j * row_ld<DH>() + c) = kv;
    const bf16* v8 = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt[(c + e) * vld + j] = v8[e];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int r0 = warp * 16; r0 < L; r0 += ATTN_WARPS * 16) {
    const int r_lo = r0 + g, r_hi = r0 + g + 8;
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const bf16* q_lo = base + r_lo * row3 + kk * 16 + 2 * t;
      const bf16* q_hi = base + r_hi * row3 + kk * 16 + 2 * t;
      qa[kk][0] = r_lo < L ? scale_pair(ld_b32(q_lo), scale2) : 0u;
      qa[kk][1] = r_hi < L ? scale_pair(ld_b32(q_hi), scale2) : 0u;
      qa[kk][2] = r_lo < L ? scale_pair(ld_b32(q_lo + 8), scale2) : 0u;
      qa[kk][3] = r_hi < L ? scale_pair(ld_b32(q_hi + 8), scale2) : 0u;
    }
    float m_lo = -INFINITY, m_hi = -INFINITY;
    for (int j0 = 0; j0 < lp; j0 += 16) {
      float sc[2][4];
      product_block<DH>(sc, qa, ks, j0, L, g, t, true);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        m_lo = fmaxf(m_lo, fmaxf(sc[nb][0], sc[nb][1]));
        m_hi = fmaxf(m_hi, fmaxf(sc[nb][2], sc[nb][3]));
      }
    }
    m_lo = quad_max(m_lo);
    m_hi = quad_max(m_hi);

    float o[DH / 8][4] = {};
    float l_lo = 0.f, l_hi = 0.f;
    for (int j0 = 0; j0 < lp; j0 += 16) {
      float sc[2][4];
      product_block<DH>(sc, qa, ks, j0, L, g, t, true);
      uint32_t pa[4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const __nv_bfloat162 p_lo =
            __floats2bfloat162_rn(exp2f(sc[nb][0] - m_lo), exp2f(sc[nb][1] - m_lo));
        const __nv_bfloat162 p_hi =
            __floats2bfloat162_rn(exp2f(sc[nb][2] - m_hi), exp2f(sc[nb][3] - m_hi));
        const float2 f_lo = __bfloat1622float2(p_lo), f_hi = __bfloat1622float2(p_hi);
        l_lo += f_lo.x + f_lo.y;
        l_hi += f_hi.x + f_hi.y;
        pa[2 * nb] = *reinterpret_cast<const uint32_t*>(&p_lo);
        pa[2 * nb + 1] = *reinterpret_cast<const uint32_t*>(&p_hi);
      }
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const bf16* vrow = vt + (nd * 8 + g) * vld + j0 + 2 * t;
        mma_bf16_16816(o[nd], pa, ld_b32(vrow), ld_b32(vrow + 8));
      }
    }
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);

    bf16* o_base = out + (long long)b * L * D + h * DH + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      if (r_lo < L)
        *reinterpret_cast<uint32_t*>(o_base + (long long)r_lo * D + nd * 8) =
            pack_bf16x2(o[nd][0] / l_lo, o[nd][1] / l_lo);
      if (r_hi < L)
        *reinterpret_cast<uint32_t*>(o_base + (long long)r_hi * D + nd * 8) =
            pack_bf16x2(o[nd][2] / l_hi, o[nd][3] / l_hi);
    }
    if (stats && t == 0) {
      float* st = stats + ((long long)(b * H + h) * L) * 2;
      if (r_lo < L) {
        st[2 * r_lo] = m_lo;
        st[2 * r_lo + 1] = l_lo;
      }
      if (r_hi < L) {
        st[2 * r_hi] = m_hi;
        st[2 * r_hi + 1] = l_hi;
      }
    }
  }
}

// pbar = bf16(bf16(exp2(s - m)) / l), the normalized probability as the
// JAX backward rounds it
__device__ __forceinline__ float pbar(float s, float m, float l) {
  return bf16_round(bf16_round(exp2f(s - m)) / l);
}

// K3's attention backward, one block per (frame b, head h). Inputs: qkv
// [B, L, 3D] (q unscaled), the attention output O and its gradient dO
// [B, L, D], the forward's row stats. Writes the head's dq, dk, dv columns
// of dqkv [B, L, 3D] (bf16) and, per frame, the column sums of the unrounded
// f32 gradients to part[b][3D] (for the bias gradient).
//   pbar = P / l (two bf16 roundings), row_i = dO_i . O_i,
//   dP = dO V^T, dS = bf16(pbar * (dP - row)),
//   dQ = ln2 * scale2 * dS K, dK = ln2 * dS^T Qs, dV = pbar^T dO.
// Pass 1 (query-major, a warp per 16 query rows) forms dQ; pass 2 (key-major,
// a warp per 16 key rows) recomputes S^T and dP^T and forms dK and dV. P and
// dS live in mma.sync fragments only. Keys and queries >= L contribute
// nothing.
template <int DH>
__global__ void __launch_bounds__(ATTN_WARPS * 32) train_attention_bwd(
    const bf16* __restrict__ qkv, const bf16* __restrict__ attn, const bf16* __restrict__ dattn,
    const float* __restrict__ stats, bf16* __restrict__ dqkv, float* __restrict__ part, int L,
    int D, float scale2, float dq_scale, float dk_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RLD = row_ld<DH>();
  const int lp = round16(L), tld = col_ld(L);
  bf16* qs_r = reinterpret_cast<bf16*>(smem);  // [lp][RLD] each
  bf16* k_r = qs_r + (size_t)lp * RLD;
  bf16* v_r = k_r + (size_t)lp * RLD;
  bf16* do_r = v_r + (size_t)lp * RLD;
  bf16* qs_t = do_r + (size_t)lp * RLD;  // [DH][tld] each
  bf16* k_t = qs_t + (size_t)DH * tld;
  bf16* do_t = k_t + (size_t)DH * tld;
  float* m_s = reinterpret_cast<float*>(do_t + (size_t)DH * tld);
  float* l_s = m_s + lp;
  float* row_s = l_s + lp;
  float* red = row_s + lp;  // [warp][3][DH]

  const int b = blockIdx.x, h = blockIdx.y, H = gridDim.y;
  const long long row3 = 3LL * D;
  const bf16* base = qkv + (long long)b * L * row3 + (long long)h * DH;
  const bf16* dob = dattn + (long long)b * L * D + (long long)h * DH;
  const bf16* ob = attn + (long long)b * L * D + (long long)h * DH;
  const float* st = stats + (long long)(b * H + h) * L * 2;
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < lp * CH; i += blockDim.x) {
    const int j = i / CH, c = (i % CH) * 8;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u), kv = qv, vv = qv, dv = qv;
    if (j < L) {
      qv = *reinterpret_cast<const uint4*>(base + j * row3 + c);
      kv = *reinterpret_cast<const uint4*>(base + j * row3 + D + c);
      vv = *reinterpret_cast<const uint4*>(base + j * row3 + 2 * D + c);
      dv = *reinterpret_cast<const uint4*>(dob + (long long)j * D + c);
      uint32_t* qw = reinterpret_cast<uint32_t*>(&qv);
#pragma unroll
      for (int e = 0; e < 4; ++e) qw[e] = scale_pair(qw[e], scale2);
    }
    *reinterpret_cast<uint4*>(qs_r + j * RLD + c) = qv;
    *reinterpret_cast<uint4*>(k_r + j * RLD + c) = kv;
    *reinterpret_cast<uint4*>(v_r + j * RLD + c) = vv;
    *reinterpret_cast<uint4*>(do_r + j * RLD + c) = dv;
    const bf16* q8 = reinterpret_cast<const bf16*>(&qv);
    const bf16* k8 = reinterpret_cast<const bf16*>(&kv);
    const bf16* d8 = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qs_t[(c + e) * tld + j] = q8[e];
      k_t[(c + e) * tld + j] = k8[e];
      do_t[(c + e) * tld + j] = d8[e];
    }
  }
  for (int j = threadIdx.x; j < lp; j += blockDim.x) {
    float row = 0.f;
    if (j < L) {
      for (int d = 0; d < DH; ++d)
        row += __bfloat162float(dob[(long long)j * D + d]) *
               __bfloat162float(ob[(long long)j * D + d]);
    }
    m_s[j] = j < L ? st[2 * j] : 0.f;
    l_s[j] = j < L ? st[2 * j + 1] : 1.f;
    row_s[j] = row;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float cs[3][DH / 8][2] = {};  // column sums of dq, dk, dv over this thread's rows
  bf16* out_base = dqkv + (long long)b * L * row3 + (long long)h * DH + 2 * t;

  // pass 1: dQ for 16 query rows per warp
  for (int r0 = warp * 16; r0 < L; r0 += ATTN_WARPS * 16) {
    const int r_lo = r0 + g, r_hi = r0 + g + 8;
    uint32_t qa[DH / 16][4], da[DH / 16][4];
    load_a<DH>(qa, qs_r, r0, g, t);
    load_a<DH>(da, do_r, r0, g, t);
    const float m_lo = m_s[r_lo], m_hi = m_s[r_hi], l_lo = l_s[r_lo], l_hi = l_s[r_hi];
    const float row_lo = row_s[r_lo], row_hi = row_s[r_hi];
    float dq[DH / 8][4] = {};
    for (int j0 = 0; j0 < lp; j0 += 16) {
      float sc[2][4], dp[2][4];
      product_block<DH>(sc, qa, k_r, j0, L, g, t, true);
      product_block<DH>(dp, da, v_r, j0, L, g, t, false);
      uint32_t dsa[4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const float d0 = pbar(sc[nb][0], m_lo, l_lo) * (dp[nb][0] - row_lo);
        const float d1 = pbar(sc[nb][1], m_lo, l_lo) * (dp[nb][1] - row_lo);
        const float d2 = pbar(sc[nb][2], m_hi, l_hi) * (dp[nb][2] - row_hi);
        const float d3 = pbar(sc[nb][3], m_hi, l_hi) * (dp[nb][3] - row_hi);
        dsa[2 * nb] = pack_bf16x2(d0, d1);
        dsa[2 * nb + 1] = pack_bf16x2(d2, d3);
      }
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const bf16* kt = k_t + (nd * 8 + g) * tld + j0 + 2 * t;
        mma_bf16_16816(dq[nd], dsa, ld_b32(kt), ld_b32(kt + 8));
      }
    }
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[nd][e] *= dq_scale;
      if (r_lo < L) {
        *reinterpret_cast<uint32_t*>(out_base + (long long)r_lo * row3 + nd * 8) =
            pack_bf16x2(dq[nd][0], dq[nd][1]);
        cs[0][nd][0] += dq[nd][0];
        cs[0][nd][1] += dq[nd][1];
      }
      if (r_hi < L) {
        *reinterpret_cast<uint32_t*>(out_base + (long long)r_hi * row3 + nd * 8) =
            pack_bf16x2(dq[nd][2], dq[nd][3]);
        cs[0][nd][0] += dq[nd][2];
        cs[0][nd][1] += dq[nd][3];
      }
    }
  }

  // pass 2: dK and dV for 16 key rows per warp
  for (int c0 = warp * 16; c0 < L; c0 += ATTN_WARPS * 16) {
    const int k_lo = c0 + g, k_hi = c0 + g + 8;
    uint32_t ka[DH / 16][4], va[DH / 16][4];
    load_a<DH>(ka, k_r, c0, g, t);
    load_a<DH>(va, v_r, c0, g, t);
    float dk[DH / 8][4] = {}, dv[DH / 8][4] = {};
    for (int i0 = 0; i0 < lp; i0 += 16) {
      float sT[2][4], dpT[2][4];  // [key][query]
      product_block<DH>(sT, ka, qs_r, i0, L, g, t, false);
      product_block<DH>(dpT, va, do_r, i0, L, g, t, false);
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = i0 + nb * 8 + 2 * t + (e & 1);
          const float pb = q < L ? pbar(sT[nb][e], m_s[q], l_s[q]) : 0.f;
          pv[e] = pb;
          dsv[e] = pb * (dpT[nb][e] - row_s[q]);
        }
        pa[2 * nb] = pack_bf16x2(pv[0], pv[1]);
        pa[2 * nb + 1] = pack_bf16x2(pv[2], pv[3]);
        dsa[2 * nb] = pack_bf16x2(dsv[0], dsv[1]);
        dsa[2 * nb + 1] = pack_bf16x2(dsv[2], dsv[3]);
      }
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const bf16* dt = do_t + (nd * 8 + g) * tld + i0 + 2 * t;
        mma_bf16_16816(dv[nd], pa, ld_b32(dt), ld_b32(dt + 8));
        const bf16* qt = qs_t + (nd * 8 + g) * tld + i0 + 2 * t;
        mma_bf16_16816(dk[nd], dsa, ld_b32(qt), ld_b32(qt + 8));
      }
    }
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[nd][e] *= dk_scale;
      if (k_lo < L) {
        bf16* o = out_base + (long long)k_lo * row3 + nd * 8;
        *reinterpret_cast<uint32_t*>(o + D) = pack_bf16x2(dk[nd][0], dk[nd][1]);
        *reinterpret_cast<uint32_t*>(o + 2 * D) = pack_bf16x2(dv[nd][0], dv[nd][1]);
        cs[1][nd][0] += dk[nd][0];
        cs[1][nd][1] += dk[nd][1];
        cs[2][nd][0] += dv[nd][0];
        cs[2][nd][1] += dv[nd][1];
      }
      if (k_hi < L) {
        bf16* o = out_base + (long long)k_hi * row3 + nd * 8;
        *reinterpret_cast<uint32_t*>(o + D) = pack_bf16x2(dk[nd][2], dk[nd][3]);
        *reinterpret_cast<uint32_t*>(o + 2 * D) = pack_bf16x2(dv[nd][2], dv[nd][3]);
        cs[1][nd][0] += dk[nd][2];
        cs[1][nd][1] += dk[nd][3];
        cs[2][nd][0] += dv[nd][2];
        cs[2][nd][1] += dv[nd][3];
      }
    }
  }

  // column sums: over the 8 row groups of the warp, then over the warps
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = cs[s][nd][u];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[(warp * 3 + s) * DH + nd * 8 + 2 * t + u] = v;
      }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * DH; i += blockDim.x) {
    const int s = i / DH, c = i % DH;
    float sum = 0.f;
    for (int w = 0; w < ATTN_WARPS; ++w) sum += red[(w * 3 + s) * DH + c];
    part[(long long)b * row3 + s * D + h * DH + c] = sum;
  }
}

// ---------------------------------------------------------------------------
// LN2 backward and the fixed-order column reductions
// ---------------------------------------------------------------------------

// One warp per row (D = 128, 4 columns per lane), 64 rows per block:
// dz = rstd * (dy*g - mean(dy*g) - xh * mean(dy*g*xh)), df = dz * mask.
// Writes df (bf16) and dz (f32, the gradient reaching x1 through the
// residual) and the block's column sums of dy*xh, dy and df to
// part[sum][block][D].
__global__ void __launch_bounds__(THREADS) ln_bwd_rows(
    const bf16* __restrict__ dy, const float* __restrict__ xh, const float* __restrict__ rstd,
    const float* __restrict__ gamma, Drop drop, long long M, bf16* __restrict__ df_out,
    float* __restrict__ dz_out, float* __restrict__ part) {
  __shared__ float red[THREADS / 32][3][TBN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long m0 = (long long)blockIdx.x * TBM, RT = gridDim.x;
  float cs[3][TBN / 32] = {};
  for (int r = warp; r < TBM; r += THREADS / 32) {
    const long long gm = m0 + r;
    if (gm >= M) break;
    const long long row = gm * TBN;
    float d[TBN / 32], x[TBN / 32], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < TBN / 32; ++t) {
      const int c = lane + 32 * t;
      d[t] = __bfloat162float(dy[row + c]);
      x[t] = xh[row + c];
      const float dyg = d[t] * gamma[c];
      s1 += dyg;
      s2 += dyg * x[t];
      cs[0][t] += d[t] * x[t];
      cs[1][t] += d[t];
    }
    const float m1 = warp_sum(s1) * (1.0f / TBN), m2 = warp_sum(s2) * (1.0f / TBN);
    const float rr = rstd[gm];
#pragma unroll
    for (int t = 0; t < TBN / 32; ++t) {
      const int c = lane + 32 * t;
      const float dz = rr * (d[t] * gamma[c] - m1 - x[t] * m2);
      const float df = dz * keep_scale(drop, gm, c);
      cs[2][t] += df;
      dz_out[row + c] = dz;
      df_out[row + c] = __float2bfloat16(df);
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int t = 0; t < TBN / 32; ++t) red[warp][s][lane + 32 * t] = cs[s][t];
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * TBN; i += THREADS) {
    const int s = i / TBN, c = i % TBN;
    float sum = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) sum += red[w][s][c];
    part[(s * RT + blockIdx.x) * TBN + c] = sum;
  }
}

// out[y][n] = sum over p in chunk y of part[p][n], p ascending.
__global__ void __launch_bounds__(THREADS) reduce_rows(const float* __restrict__ part,
                                                      long long P, long long N, long long chunk,
                                                      float* __restrict__ out) {
  const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const long long p0 = (long long)blockIdx.y * chunk, p1 = min(P, p0 + chunk);
  float s = 0.f;
  for (long long p = p0; p < p1; ++p) s += part[p * N + n];
  out[(long long)blockIdx.y * N + n] = s;
}

constexpr int REDUCE_CHUNKS = 128;  // first-pass chunks when P is large

// out[n] = sum_p part[p][n]: one pass for P <= 256, else two (P rows into
// REDUCE_CHUNKS partial rows in `scratch`, then those).
void reduce(const float* part, long long P, long long N, float* out, float* scratch,
            cudaStream_t s) {
  const unsigned cols = (unsigned)((N + THREADS - 1) / THREADS);
  if (P > 256) {
    const long long chunk = (P + REDUCE_CHUNKS - 1) / REDUCE_CHUNKS;
    const long long n_chunks = (P + chunk - 1) / chunk;
    reduce_rows<<<dim3(cols, (unsigned)n_chunks), THREADS, 0, s>>>(part, P, N, chunk, scratch);
    part = scratch;
    P = n_chunks;
  }
  reduce_rows<<<dim3(cols, 1), THREADS, 0, s>>>(part, P, N, P, out);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

TGemm tg(const bf16* a, long long lda, const bf16* b, long long ldb, long long m, long long k,
         long long ldo) {
  TGemm g{};
  g.a = a;
  g.lda = lda;
  g.b = b;
  g.ldb = ldb;
  g.m = m;
  g.k = k;
  g.k_chunk = k;
  g.ldo = ldo;
  return g;
}

template <bool AT, bool BT, int EPI>
void gemm(TGemm p, long long n_cols, int splits, cudaStream_t s) {
  p.n_tiles = (int)(n_cols / TBN);
  const long long blocks = (p.m + TBM - 1) / TBM * p.n_tiles;
  tgemm<AT, BT, EPI><<<dim3((unsigned)blocks, (unsigned)splits), THREADS, 0, s>>>(p);
}

// Bump allocator over the caller's workspace; with a null base it only
// measures (the *_workspace entry points).
struct Carve {
  char* base;
  size_t off = 0;
  template <class T>
  T* take(size_t n) {
    off = (off + 255) & ~size_t(255);
    T* ptr = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += n * sizeof(T);
    return ptr;
  }
};

struct Shape {
  int B, L, D, H, F;
  long long M() const { return (long long)B * L; }
  long long RT() const { return (M() + TBM - 1) / TBM; }
  int dh() const { return D / H; }
  // depth splits of the weight-gradient GEMMs: ~2K rows each, at most 64
  int splits() const { return (int)std::min<long long>(64, std::max<long long>(1, M() / 2048)); }
  long long k_chunk() const {
    const long long c = (M() + splits() - 1) / splits();
    return (c + TBK - 1) / TBK * TBK;
  }
};

bool shapes_ok(const Shape& s) {
  if (s.B <= 0 || s.L <= 0 || s.H <= 0 || s.D != TBN || s.D % s.H) return false;
  const int dh = s.dh();
  if (!(dh == 16 || dh == 32) || s.F <= 0 || s.F % TBN) return false;
  const size_t smem = dh == 16 ? attention_bwd_smem_bytes<16>(s.L) : attention_bwd_smem_bytes<32>(s.L);
  return smem <= 232448;
}

Drop make_drop(const Shape& s, uint32_t thresh, float scale, int seed, int layer, int site) {
  Drop d;
  const uint32_t salt = (uint32_t)(layer * 3 + site) * 0x9E3779B9u + 0x61C88647u;
  d.seed_salt = (uint32_t)seed + salt;
  d.thresh = thresh;
  d.scale = scale;
  d.L = s.L;
  d.on = thresh != 0u || scale != 1.f;
  return d;
}

template <int DH, class K, class... Args>
cudaError_t launch_attention(K kernel, size_t smem, const Shape& s, cudaStream_t stream,
                             Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((unsigned)s.B, (unsigned)s.H), ATTN_WARPS * 32, smem, stream>>>(args...);
  return cudaSuccess;
}

float scale2_of(const Shape& s) { return (float)(1.4426950408889634 / sqrt((double)s.dh())); }

cudaError_t attention_fwd(const Shape& s, const bf16* qkv, bf16* out, float* stats,
                          cudaStream_t st) {
  const float sc = scale2_of(s);
  if (s.dh() == 16)
    return launch_attention<16>(train_attention_fwd<16>, attention_fwd_smem_bytes<16>(s.L), s,
                                st, qkv, out, stats, s.L, s.D, sc);
  return launch_attention<32>(train_attention_fwd<32>, attention_fwd_smem_bytes<32>(s.L), s, st,
                              qkv, out, stats, s.L, s.D, sc);
}

cudaError_t attention_bwd(const Shape& s, const bf16* qkv, const bf16* attn, const bf16* dattn,
                          const float* stats, bf16* dqkv, float* part, cudaStream_t st) {
  const double scale2 = 1.4426950408889634 / sqrt((double)s.dh());
  const double ln2 = 0.6931471805599453;
  const float sc = (float)scale2, dq = (float)(ln2 * scale2), dk = (float)ln2;
  if (s.dh() == 16)
    return launch_attention<16>(train_attention_bwd<16>, attention_bwd_smem_bytes<16>(s.L), s,
                                st, qkv, attn, dattn, stats, dqkv, part, s.L, s.D, sc, dq, dk);
  return launch_attention<32>(train_attention_bwd<32>, attention_bwd_smem_bytes<32>(s.L), s, st,
                              qkv, attn, dattn, stats, dqkv, part, s.L, s.D, sc, dq, dk);
}

struct Weights {
  const bf16 *wqkv, *wo, *w1, *w2;
  const float *bqkv, *bo, *g1, *be1, *b1, *b2, *g2, *be2;
};

Weights weights(const void* const* w) {
  Weights o;
  o.wqkv = static_cast<const bf16*>(w[0]);
  o.bqkv = static_cast<const float*>(w[1]);
  o.wo = static_cast<const bf16*>(w[2]);
  o.bo = static_cast<const float*>(w[3]);
  o.g1 = static_cast<const float*>(w[4]);
  o.be1 = static_cast<const float*>(w[5]);
  o.w1 = static_cast<const bf16*>(w[6]);
  o.b1 = static_cast<const float*>(w[7]);
  o.w2 = static_cast<const bf16*>(w[8]);
  o.b2 = static_cast<const float*>(w[9]);
  o.g2 = static_cast<const float*>(w[10]);
  o.be2 = static_cast<const float*>(w[11]);
  return o;
}

// Activations the forward stages produce; the backward's recompute also
// keeps the row stats, LN inputs and 1/std.
struct Fwd {
  bf16 *qkv, *attn, *x1, *hid;
  float *stats = nullptr, *xh1 = nullptr, *r1 = nullptr, *xh2 = nullptr, *r2 = nullptr;
};

Fwd carve_fwd(Carve& c, const Shape& s, bool for_bwd) {
  const long long M = s.M();
  Fwd f;
  f.qkv = c.take<bf16>(M * 3 * s.D);
  f.attn = c.take<bf16>(M * s.D);
  f.x1 = c.take<bf16>(M * s.D);
  f.hid = c.take<bf16>(M * s.F);
  if (for_bwd) {
    f.stats = c.take<float>((size_t)s.B * s.H * s.L * 2);
    f.xh1 = c.take<float>(M * s.D);
    f.r1 = c.take<float>(M);
    f.xh2 = c.take<float>(M * s.D);
    f.r2 = c.take<float>(M);
  }
  return f;
}

// The forward's five stages; y may be null (the backward's recompute).
cudaError_t forward(const Shape& s, const bf16* x, bf16* y, const Weights& w, const Fwd& f,
                    const Drop* drop, cudaStream_t st) {
  const long long M = s.M(), D = s.D, F = s.F;
  TGemm g = tg(x, D, w.wqkv, 3 * D, M, D, 3 * D);
  g.bias = w.bqkv;
  g.out = f.qkv;
  gemm<false, false, kBias>(g, 3 * D, 1, st);
  const cudaError_t err = attention_fwd(s, f.qkv, f.attn, f.stats, st);
  if (err != cudaSuccess) return err;
  g = tg(f.attn, D, w.wo, D, M, D, D);
  g.bias = w.bo;
  g.res = x;
  g.gamma = w.g1;
  g.beta = w.be1;
  g.out = f.x1;
  g.xh_out = f.xh1;
  g.rstd_out = f.r1;
  g.drop = drop[0];
  gemm<false, false, kLnFwd>(g, D, 1, st);
  g = tg(f.x1, D, w.w1, F, M, D, F);
  g.bias = w.b1;
  g.out = f.hid;
  g.drop = drop[1];
  gemm<false, false, kReluDrop>(g, F, 1, st);
  g = tg(f.hid, F, w.w2, D, M, F, D);
  g.bias = w.b2;
  g.res = f.x1;
  g.gamma = w.g2;
  g.beta = w.be2;
  g.out = y;
  g.xh_out = f.xh2;
  g.rstd_out = f.r2;
  g.drop = drop[2];
  gemm<false, false, kLnFwd>(g, D, 1, st);
  return cudaSuccess;
}

struct Bwd {
  Fwd f;
  bf16 *dfb, *dpreb, *dab, *dattn, *dqkv;
  float *dz2, *dz1, *part_rows, *part_frames, *part_dw, *scratch;
};

Bwd carve_bwd(Carve& c, const Shape& s) {
  const long long M = s.M(), D = s.D, F = s.F;
  Bwd b;
  b.f = carve_fwd(c, s, true);
  b.dfb = c.take<bf16>(M * D);
  b.dz2 = c.take<float>(M * D);
  b.dpreb = c.take<bf16>(M * F);
  b.dab = c.take<bf16>(M * D);
  b.dz1 = c.take<float>(M * D);
  b.dattn = c.take<bf16>(M * D);
  b.dqkv = c.take<bf16>(M * 3 * D);
  b.part_rows = c.take<float>(3 * s.RT() * std::max(D, F));
  b.part_frames = c.take<float>((size_t)s.B * 3 * D);
  b.part_dw = c.take<float>((size_t)s.splits() * D * std::max(3 * D, F));
  b.scratch = c.take<float>((size_t)REDUCE_CHUNKS * std::max(3 * D, F));
  return b;
}

// act^T grad over all rows into out [K1, N] (f32): split-K partials, then
// their fixed-order sum.
void weight_grad(const Shape& s, const Bwd& b, const bf16* act, long long k1, const bf16* grad,
                 long long n, float* out, cudaStream_t st) {
  TGemm g = tg(act, k1, grad, n, k1, s.M(), n);
  g.k_chunk = s.k_chunk();
  g.out32 = b.part_dw;
  const int splits = (int)((s.M() + g.k_chunk - 1) / g.k_chunk);
  gemm<true, false, kPartial>(g, n, splits, st);
  reduce(b.part_dw, splits, k1 * n, out, b.scratch, st);
}

cudaError_t backward(const Shape& s, const bf16* x, const bf16* dy, bf16* dx, float* grads,
                     const Weights& w, const Bwd& b, const Drop* drop, cudaStream_t st) {
  const long long M = s.M(), D = s.D, F = s.F, RT = s.RT();
  const Fwd& f = b.f;
  cudaError_t err = forward(s, x, nullptr, w, f, drop, st);
  if (err != cudaSuccess) return err;
  // gradient slots, in the order of the 12 weights
  float* dwqkv = grads;
  float* dbqkv = dwqkv + D * 3 * D;
  float* dwo = dbqkv + 3 * D;
  float* dbo = dwo + D * D;
  float* dg1 = dbo + D;
  float* dbe1 = dg1 + D;
  float* dw1 = dbe1 + D;
  float* db1 = dw1 + D * F;
  float* dw2 = db1 + F;
  float* db2 = dw2 + F * D;
  float* dg2 = db2 + D;
  float* dbe2 = dg2 + D;

  // LN2, dropout m3: df, dz2 (-> x1); dg2, dbe2, db2
  ln_bwd_rows<<<(unsigned)RT, THREADS, 0, st>>>(dy, f.xh2, f.r2, w.g2, drop[2], M, b.dfb, b.dz2,
                                                 b.part_rows);
  reduce(b.part_rows, RT, D, dg2, b.scratch, st);
  reduce(b.part_rows + RT * D, RT, D, dbe2, b.scratch, st);
  reduce(b.part_rows + 2 * RT * D, RT, D, db2, b.scratch, st);
  // FFN2: dW2 = h^T df; dpre = (h > 0) * (df W2^T) * m2; db1
  weight_grad(s, b, f.hid, F, b.dfb, D, dw2, st);
  TGemm g = tg(b.dfb, D, w.w2, D, M, D, F);
  g.res = f.hid;
  g.drop = drop[1];
  g.out = b.dpreb;
  g.part = b.part_rows;
  gemm<false, true, kDpre>(g, F, 1, st);
  reduce(b.part_rows, RT, F, db1, b.scratch, st);
  // FFN1: dW1 = x1^T dpre; dx1 = dz2 + dpre W1^T; LN1 backward, dropout m1
  weight_grad(s, b, f.x1, D, b.dpreb, F, dw1, st);
  g = tg(b.dpreb, F, w.w1, F, M, F, D);
  g.res32 = b.dz2;
  g.xh = f.xh1;
  g.rstd = f.r1;
  g.gamma = w.g1;
  g.drop = drop[0];
  g.out = b.dab;
  g.out32 = b.dz1;
  g.part = b.part_rows;
  gemm<false, true, kLnBwd>(g, D, 1, st);
  reduce(b.part_rows, RT, D, dg1, b.scratch, st);
  reduce(b.part_rows + RT * D, RT, D, dbe1, b.scratch, st);
  reduce(b.part_rows + 2 * RT * D, RT, D, dbo, b.scratch, st);
  // out-projection: dWo = attn^T da; dattn = bf16(da Wo^T)
  weight_grad(s, b, f.attn, D, b.dab, D, dwo, st);
  g = tg(b.dab, D, w.wo, D, M, D, D);
  g.out = b.dattn;
  gemm<false, true, kStore>(g, D, 1, st);
  // attention backward: dqkv; dbqkv
  err = attention_bwd(s, f.qkv, f.attn, b.dattn, f.stats, b.dqkv, b.part_frames, st);
  if (err != cudaSuccess) return err;
  reduce(b.part_frames, s.B, 3 * D, dbqkv, b.scratch, st);
  // QKV projection: dWqkv = x^T dqkv; dx = bf16(dz1 + dqkv Wqkv^T)
  weight_grad(s, b, x, D, b.dqkv, 3 * D, dwqkv, st);
  g = tg(b.dqkv, 3 * D, w.wqkv, 3 * D, M, 3 * D, D);
  g.res32 = b.dz1;
  g.out = dx;
  gemm<false, true, kResOut>(g, D, 1, st);
  return cudaSuccess;
}

}  // namespace

// Bytes of workspace K3-fwd / K3-bwd need at this shape (0 if unsupported).
extern "C" size_t vitiq_train_layer_fwd_workspace(int B, int L, int D, int H, int F) {
  const Shape s{B, L, D, H, F};
  if (!shapes_ok(s)) return 0;
  Carve c{nullptr};
  carve_fwd(c, s, false);
  return c.off;
}

extern "C" size_t vitiq_train_layer_bwd_workspace(int B, int L, int D, int H, int F) {
  const Shape s{B, L, D, H, F};
  if (!shapes_ok(s)) return 0;
  Carve c{nullptr};
  carve_bwd(c, s);
  return c.off;
}

// K3-fwd: y = the training layer of x (see the header). x, y: [B, L, D] bf16;
// w0..w11: Wqkv [D, 3D] (unscaled), bqkv, Wo [D, D], bo, g1, be1, W1 [D, F],
// b1, W2 [F, D], b2, g2, be2 (matrices bf16, vectors f32); workspace of
// vitiq_train_layer_fwd_workspace bytes. Dropout: drop iff the position
// hash's low 31 bits < thresh, keep scaled by `scale` (thresh 0 and scale 1:
// no dropout). Returns cudaGetLastError().
extern "C" int vitiq_train_layer_fwd(
    const void* x, void* y, const void* w0, const void* w1, const void* w2, const void* w3,
    const void* w4, const void* w5, const void* w6, const void* w7, const void* w8,
    const void* w9, const void* w10, const void* w11, void* workspace, int B, int L, int D,
    int H, int F, uint32_t thresh, float scale, int seed, int layer, void* stream_ptr) {
  const Shape s{B, L, D, H, F};
  if (!shapes_ok(s)) return (int)cudaErrorInvalidValue;
  const void* wp[12] = {w0, w1, w2, w3, w4, w5, w6, w7, w8, w9, w10, w11};
  Carve c{static_cast<char*>(workspace)};
  const Fwd f = carve_fwd(c, s, false);
  const Drop drop[3] = {make_drop(s, thresh, scale, seed, layer, 0),
                        make_drop(s, thresh, scale, seed, layer, 1),
                        make_drop(s, thresh, scale, seed, layer, 2)};
  const cudaError_t err = forward(s, static_cast<const bf16*>(x), static_cast<bf16*>(y),
                                  weights(wp), f, drop, static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K3-bwd: recompute the layer from x, then dx [B, L, D] (bf16) and the 12
// gradients, written f32 and back to back into `grads` in the order of the
// weights (Wqkv [D, 3D], bqkv [3D], Wo, bo, g1, be1, W1 [D, F], b1, W2 [F, D],
// b2, g2, be2). dy: [B, L, D] bf16. Workspace of
// vitiq_train_layer_bwd_workspace bytes. Returns cudaGetLastError().
extern "C" int vitiq_train_layer_bwd(
    const void* x, const void* dy, void* dx, void* grads, const void* w0, const void* w1,
    const void* w2, const void* w3, const void* w4, const void* w5, const void* w6,
    const void* w7, const void* w8, const void* w9, const void* w10, const void* w11,
    void* workspace, int B, int L, int D, int H, int F, uint32_t thresh, float scale, int seed,
    int layer, void* stream_ptr) {
  const Shape s{B, L, D, H, F};
  if (!shapes_ok(s)) return (int)cudaErrorInvalidValue;
  const void* wp[12] = {w0, w1, w2, w3, w4, w5, w6, w7, w8, w9, w10, w11};
  Carve c{static_cast<char*>(workspace)};
  const Bwd b = carve_bwd(c, s);
  const Drop drop[3] = {make_drop(s, thresh, scale, seed, layer, 0),
                        make_drop(s, thresh, scale, seed, layer, 1),
                        make_drop(s, thresh, scale, seed, layer, 2)};
  const cudaError_t err =
      backward(s, static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
               static_cast<bf16*>(dx), static_cast<float*>(grads), weights(wp), b, drop,
               static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
