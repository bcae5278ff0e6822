// Fused post-norm encoder layer for inference on Hopper (sm_90a).
//
// Replaces (TPU Pallas kernels of the JAX reference package):
//   K1  vitiq/ops/pallas/fused_encoder_layer.py: fused_encoder_layer_v3_stack
//       -> _fused_layer_kernel_v3 with the cross-head packed core
//          _v3_attention_core_xpack (every full layer of the stack)
//   K2  vitiq/ops/pallas/fused_encoder_layer.py: _fused_layer_kernel_v3_cls
//       with the chained core _v3_attention_core (last layer, CLS row only)
//
// Function, per layer, on a bf16 [B, L, D] activation (D = 128):
//   qkv    = bf16(x @ Wqkv + bqkv)          q pre-scaled by log2(e)/sqrt(dh)
//   attn_h = bf16( sum_j p_j v_j / sum_j p_j ),  p_j = bf16(exp2(s_j - max s))
//            s_j = q_h . k_{h,j} over the L valid keys
//   x1     = bf16(LN(attn @ Wo + bo + x))    LN: biased variance, eps 1e-12,
//   y      = bf16(LN(relu(x1 @ W1 + b1) @ W2 + b2 + x1))   f32 stats, rsqrt
// All four GEMMs accumulate bf16 products in f32. K2 computes the same layer
// for query row 0 only: K and V cover every token, the output is [B, 1, D].
//
// Softmax: the row max IS subtracted (two passes over the keys, the scores
// recomputed in the second). The TPU kernel's exp2 subtracts none and relies on
// |score| < 88; subtracting the max is the same function, safe for any score,
// and rounds the bf16 probabilities at a different scale.
//
// Design: four __global__ stages per layer, launched on the caller's stream.
//   1. gemm_kernel<kBias>            QKV GEMM (K2: q for row 0, k/v for all rows)
//   2. attention_kernel<DH>          one block per (frame, head): the head's
//                                    k/v rows in shared memory, one warp per
//                                    16 query rows, Q K^T and P V on the tensor
//                                    cores (mma.sync); scores and
//                                    probabilities live in registers only and
//                                    never reach device memory
//   3. gemm_kernel<kBiasResidualLN>  out-projection + bias + residual + LN1
//   4. gemm_kernel<kBiasRelu>        FFN1 + bias + ReLU
//   5. gemm_kernel<kBiasResidualLN>  FFN2 + bias + residual + LN2
// The GEMMs run on the tensor cores through WMMA (bf16 16x16x16 fragments,
// f32 accumulators) over 64x128 output tiles; N = D = 128 is one tile row,
// so the LayerNorm epilogue sees whole rows. A two-stage cp.async pipeline
// feeds them; no TMA, no wgmma: a simple, right first port.
//
// What bounds it on the card: per frame and layer at the flagship shape
// (L = 129, D = 128, F = 512) the GEMMs are ~51 MFLOP and the attention core
// ~8.5 MFLOP, against ~0.7 MB of activation traffic through device memory
// (qkv, attn, x1 and the FFN hidden each written once and read once or
// twice). At ~85 FLOP/byte that is under the bf16 ridge (~295 FLOP/byte), so
// on the roofline the intermediate round trips (the FFN hidden most of all)
// bound it; the TPU kernel kept them in VMEM. In this first port the WMMA
// GEMM stages, which hold most of the time, sit well below either roof.
//
// TPU schedule variants (selected by env knobs in the reference) and what
// computes each here — all are the same function as K1/K2:
//   VITIQ_V3_ATTN=xpack (default), =chain, =kt   -> attention_kernel: heads
//       are independent blocks, so neither the block-diagonal packing (xpack,
//       K13) nor the per-head chain (chain) nor key tiling (kt, K9) has a
//       counterpart; a frame-head's K/V fit shared memory up to ~2.9K
//       tokens at d_head 16 (~1.6K at d_head 32).
//   VITIQ_V3_PACK (batch packing), VITIQ_V3_G / _LPC (frames per block,
//       layers per call)                          -> one block per frame-head;
//       one host call per layer.
//   VITIQ_V3_TAIL (VPU tail keys), Lp padding to 16 rows and batch padding to
//       a multiple of G                           -> activations stay
//       [B, L, D] unpadded; GEMM loops are bounded by B*L rows, the softmax
//       by L keys. Only the attention core's shared-memory copies of k/v
//       are zero-filled up to the 16-row MMA tile.
//   VITIQ_V3_HG (head grouping)                   -> heads run in parallel blocks.
//   VITIQ_V3_EPI (div / mul / div2 / div3 / mul2) -> one f32 divide per output
//       element of the head.
//   VITIQ_V3_FUSECLS=1 (mono / combo kernels)     -> the full layers, then K2,
//       as separate launches; the activation between them is in device memory.
//   VITIQ_FUSED_VERSION=v2 (K11), v1 fused_encoder_layer (K12),
//   VITIQ_LONGSEQ=1 v4long (K10, query tiling)    -> K1 (the warp loop over
//       16-row query tiles is the query tiling).
//   VITIQ_V3_PROBE                                -> timing-only surgery; none.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64;    // GEMM tile rows
constexpr int BN = 128;   // GEMM tile columns (== D for the LN epilogue)
constexpr int BK = 32;    // GEMM tile depth
constexpr int A_LD = BK + 8;   // shared-memory leading dims (bank-conflict pad,
constexpr int B_LD = BN + 8;   // multiples of 8 bf16 / 4 f32 as WMMA requires)
constexpr int C_LD = BN + 4;
constexpr int GEMM_THREADS = 256;  // 8 warps: 2 x 4 warp tiles of 32 x 32
constexpr int ATTN_WARPS = 4;
constexpr float LN_EPS = 1e-12f;

enum Epilogue { kBias = 0, kBiasRelu = 1, kBiasResidualLN = 2 };

struct GemmArgs {
  const bf16* a;      // A rows: row r starts at a + r * lda, K contiguous values
  long long lda;
  const bf16* w;      // W [K, ldw] row-major
  int ldw;
  const float* bias;  // [ldw]
  bf16* c;            // C row r, column n at c + r * ldc + n
  long long ldc;
  long long m;        // rows
  int k;              // depth (multiple of BK)
  int col0;           // first column of W / C this launch computes
  int n_tiles;        // BN-wide column tiles this launch computes
  const bf16* res;    // residual rows (LN epilogue), row r at res + r * ldr
  long long ldr;
  const float* gamma;
  const float* beta;
};

constexpr int A_TILE = BM * A_LD;  // bf16 elements of one stage's A tile
constexpr int B_TILE = BK * B_LD;  // and of its W tile
constexpr int PIPE_BYTES = 2 * (A_TILE + B_TILE) * (int)sizeof(bf16);
constexpr int C_BYTES = BM * C_LD * (int)sizeof(float);
constexpr int GEMM_SMEM = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;

// C[:, n0 .. n0 + BN) = epilogue(A @ W + bias) for one 64 x 128 tile per
// block. Block i takes row tile i / n_tiles and column tile i % n_tiles, so
// the column tiles of one row tile run together and share its A rows in L2.
// The k loop is a two-stage cp.async pipeline: the next k-step's tiles load
// while the tensor cores work on this one. The f32 output tile reuses the
// pipeline's shared memory once the loop is done.
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs p) {
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM];
  bf16* stages = reinterpret_cast<bf16*>(smem);  // [2][A tile | W tile]
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long m0 = (long long)(blockIdx.x / p.n_tiles) * BM;
  const int n0 = p.col0 + (int)(blockIdx.x % p.n_tiles) * BN;
  const int wm = warp >> 2, wn = warp & 3;

  auto load_stage = [&](int stage, int k0) {
    bf16* As = stages + stage * (A_TILE + B_TILE);
    bf16* Bs = As + A_TILE;
    {  // A tile: 64 x 32 = 256 chunks of 8 bf16, one per thread
      const int r = tid >> 2, c = (tid & 3) * 8;
      const long long gm = m0 + r;
      const bool in = gm < p.m;
      cp_async16(As + r * A_LD + c, p.a + (in ? gm : 0) * p.lda + k0 + c, in ? 16 : 0);
    }
#pragma unroll
    for (int i = tid; i < BK * BN / 8; i += GEMM_THREADS) {  // W tile: 32 x 128
      const int r = i >> 4, c = (i & 15) * 8;
      cp_async16(Bs + r * B_LD + c, p.w + (long long)(k0 + r) * p.ldw + n0 + c, 16);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = p.k / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();  // this k-step's group has landed, the next may not
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* As = stages + (kt & 1) * (A_TILE + B_TILE);
    const bf16* Bs = As + A_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  if constexpr (EPI == kBiasResidualLN) {
    // one warp per row, 4 columns per lane; the tile holds the whole row
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      const long long gm = m0 + r;
      if (gm >= p.m) break;  // warp-uniform
      float v[BN / 32];
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < BN / 32; ++t) {
        const int c = lane + 32 * t;
        v[t] = Cs[r * C_LD + c] + p.bias[c] + __bfloat162float(p.res[gm * p.ldr + c]);
        s += v[t];
      }
      const float mean = warp_sum(s) * (1.0f / BN);
      float q = 0.f;
#pragma unroll
      for (int t = 0; t < BN / 32; ++t) {
        const float d = v[t] - mean;
        q += d * d;
      }
      const float rstd = rsqrtf(warp_sum(q) * (1.0f / BN) + LN_EPS);
#pragma unroll
      for (int t = 0; t < BN / 32; ++t) {
        const int c = lane + 32 * t;
        p.c[gm * p.ldc + c] = __float2bfloat16(p.gamma[c] * ((v[t] - mean) * rstd) + p.beta[c]);
      }
    }
  } else {
    // 8 consecutive columns per thread, stored as one 16-byte chunk
    for (int i = tid; i < BM * BN / 8; i += GEMM_THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const long long gm = m0 + r;
      if (gm >= p.m) continue;
      uint4 packed;
      uint32_t* words = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float v0 = Cs[r * C_LD + c + e] + p.bias[n0 + c + e];
        float v1 = Cs[r * C_LD + c + e + 1] + p.bias[n0 + c + e + 1];
        if (EPI == kBiasRelu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        words[e / 2] = pack_bf16x2(v0, v1);
      }
      *reinterpret_cast<uint4*>(p.c + gm * p.ldc + n0 + c) = packed;
    }
  }
}

// Shared-memory row strides (bf16 elements) of the attention core's k
// [key][K_LD] and v^T [dim][vt_ld(L)] copies: padded so that the eight
// rows a warp's fragment loads touch fall on distinct banks.
template <int DH>
__host__ __device__ constexpr int k_ld() { return DH + 8; }
__host__ __device__ __forceinline__ int vt_ld(int L) { return round16(L) + 8; }

template <int DH>
__host__ __device__ __forceinline__ size_t attention_smem_bytes(int L) {
  return ((size_t)round16(L) * k_ld<DH>() + (size_t)DH * vt_ld(L)) * sizeof(bf16);
}

// Scores of the warp's 16 query rows against keys [j0, j0 + 16): two 16 x 8
// blocks, in log2 units (q carries log2(e)/sqrt(dh)); keys >= L are -inf.
template <int DH>
__device__ __forceinline__ void score_block(float sc[2][4], const uint32_t qa[DH / 16][4],
                                            const bf16* ks, int j0, int L, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
    const bf16* krow = ks + (j0 + nb * 8 + g) * k_ld<DH>() + 2 * t;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      mma_bf16_16816(sc[nb], qa[kk], ld_b32(krow + kk * 16), ld_b32(krow + kk * 16 + 8));
    if (j0 + 16 > L) {
      const int key = j0 + nb * 8 + 2 * t;
      if (key >= L) sc[nb][0] = sc[nb][2] = -INFINITY;
      if (key + 1 >= L) sc[nb][1] = sc[nb][3] = -INFINITY;
    }
  }
}

// One block per (frame b, head h). qkv: [B, L, 3D] bf16 with q in columns
// [0, D) (only rows < n_q are read), k in [D, 2D), v in [2D, 3D). Writes
// query rows 0..n_q-1 of head h to out + b*out_frame_stride + i*D + h*DH.
//
// The block copies the head's k and v^T into shared memory (zero past L).
// Each warp then takes 16 query rows at a time, its q fragments read from
// device memory, and makes two passes over the keys in blocks of 16, the
// scores recomputed by the tensor cores (mma.sync) in each: pass 1 takes the
// row max; pass 2 forms p = bf16(exp2(s - max)), sums the rounded p in f32,
// and accumulates P V in f32, the score fragment reused as the A operand.
// Scores and probabilities live in registers only.
template <int DH>
__global__ void __launch_bounds__(ATTN_WARPS * 32) attention_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out, int L, int n_q, int D,
    long long out_frame_stride) {
  static_assert(DH % 16 == 0, "head width must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = round16(L), vld = vt_ld(L);
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [lp][k_ld]
  bf16* vt = ks + (size_t)lp * k_ld<DH>();   // [DH][vld]

  const int b = blockIdx.x, h = blockIdx.y;
  const long long row3 = 3LL * D;
  const bf16* base = qkv + (long long)b * L * row3 + (long long)h * DH;
  constexpr int CH = DH / 8;  // 16-byte chunks per head row
  for (int i = threadIdx.x; i < lp * CH; i += blockDim.x) {
    const int j = i / CH, c = (i % CH) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (j < L) {
      kv = *reinterpret_cast<const uint4*>(base + j * row3 + D + c);
      vv = *reinterpret_cast<const uint4*>(base + j * row3 + 2 * D + c);
    }
    *reinterpret_cast<uint4*>(ks + j * k_ld<DH>() + c) = kv;
    const bf16* v8 = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt[(c + e) * vld + j] = v8[e];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int r0 = warp * 16; r0 < n_q; r0 += ATTN_WARPS * 16) {
    const int r_lo = r0 + g, r_hi = r0 + g + 8;
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const bf16* q_lo = base + r_lo * row3 + kk * 16 + 2 * t;
      const bf16* q_hi = base + r_hi * row3 + kk * 16 + 2 * t;
      qa[kk][0] = r_lo < n_q ? ld_b32(q_lo) : 0u;
      qa[kk][1] = r_hi < n_q ? ld_b32(q_hi) : 0u;
      qa[kk][2] = r_lo < n_q ? ld_b32(q_lo + 8) : 0u;
      qa[kk][3] = r_hi < n_q ? ld_b32(q_hi + 8) : 0u;
    }

    float m_lo = -INFINITY, m_hi = -INFINITY;
    for (int j0 = 0; j0 < lp; j0 += 16) {
      float sc[2][4];
      score_block<DH>(sc, qa, ks, j0, L, g, t);
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
      score_block<DH>(sc, qa, ks, j0, L, g, t);
      uint32_t pa[4];  // P as the A operand: [g | g+8][j0 + 2t.. | j0 + 8 + 2t..]
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

    bf16* o_base = out + (long long)b * out_frame_stride + h * DH + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      if (r_lo < n_q)
        *reinterpret_cast<uint32_t*>(o_base + (long long)r_lo * D + nd * 8) =
            pack_bf16x2(o[nd][0] / l_lo, o[nd][1] / l_lo);
      if (r_hi < n_q)
        *reinterpret_cast<uint32_t*>(o_base + (long long)r_hi * D + nd * 8) =
            pack_bf16x2(o[nd][2] / l_hi, o[nd][3] / l_hi);
    }
  }
}

template <int EPI>
void launch_gemm(GemmArgs p, int n_cols, cudaStream_t stream) {
  p.n_tiles = n_cols / BN;
  const long long blocks = (p.m + BM - 1) / BM * p.n_tiles;
  gemm_kernel<EPI><<<(unsigned)blocks, GEMM_THREADS, 0, stream>>>(p);
}

GemmArgs gemm_args(const bf16* a, long long lda, const bf16* w, int ldw,
                   const float* bias, bf16* c, long long ldc, long long m, int k,
                   int col0) {
  GemmArgs g{};
  g.a = a;
  g.lda = lda;
  g.w = w;
  g.ldw = ldw;
  g.bias = bias;
  g.c = c;
  g.ldc = ldc;
  g.m = m;
  g.k = k;
  g.col0 = col0;
  return g;
}

GemmArgs with_ln(GemmArgs g, const bf16* res, long long ldr, const float* gamma,
                 const float* beta) {
  g.res = res;
  g.ldr = ldr;
  g.gamma = gamma;
  g.beta = beta;
  return g;
}

template <int DH>
cudaError_t launch_attention(const bf16* qkv, bf16* out, int B, int L, int n_q,
                             int D, int H, long long out_frame_stride,
                             cudaStream_t stream) {
  const size_t smem = attention_smem_bytes<DH>(L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)B, (unsigned)H);
  attention_kernel<DH><<<grid, ATTN_WARPS * 32, smem, stream>>>(qkv, out, L, n_q, D,
                                                                out_frame_stride);
  return cudaSuccess;
}

cudaError_t attention(const bf16* qkv, bf16* out, int B, int L, int n_q, int D, int H,
                      long long out_frame_stride, cudaStream_t stream) {
  const int dh = D / H;
  if (dh == 16) return launch_attention<16>(qkv, out, B, L, n_q, D, H, out_frame_stride, stream);
  return launch_attention<32>(qkv, out, B, L, n_q, D, H, out_frame_stride, stream);
}

bool shapes_ok(int B, int L, int D, int H, int F) {
  if (B <= 0 || L <= 0 || H <= 0 || D != BN || D % H) return false;
  const int dh = D / H;
  return (dh == 16 || dh == 32) && F > 0 && F % BN == 0 && F % BK == 0;
}

// One layer, for every query row (K1) or for row 0 of each frame only (K2).
// x: [B, L, D]; out: [B, L, D] (K1) or [B, 1, D] (K2). Scratch: qkv
// [B, L, 3D]; attn and x1 [R, D] and hid [R, F] for the R output rows (B*L
// or B). Weights: wqkv [D, 3D] with its q columns pre-scaled by
// log2(e)/sqrt(dh), wo [D, D], w1 [D, F], w2 [F, D] in bf16; biases and LN
// parameters f32. Returns cudaGetLastError().
int encoder_layer(bool cls_only, const void* x, void* out, void* qkv, void* attn, void* x1,
                  void* hid, const void* wqkv, const void* bqkv, const void* wo,
                  const void* bo, const void* g1, const void* be1, const void* w1,
                  const void* b1, const void* w2, const void* b2, const void* g2,
                  const void* be2, int B, int L, int D, int H, int F, void* stream_ptr) {
  if (!shapes_ok(B, L, D, H, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* attnb = static_cast<bf16*>(attn);
  bf16* x1b = static_cast<bf16*>(x1);
  bf16* hidb = static_cast<bf16*>(hid);
  const bf16* w_qkv = static_cast<const bf16*>(wqkv);
  const float* b_qkv = static_cast<const float*>(bqkv);
  const long long M = (long long)B * L, frame = (long long)L * D;
  const long long rows = cls_only ? B : M;      // output rows
  const long long x_ld = cls_only ? frame : D;  // stride of their residual rows in x

  if (cls_only) {
    // q for row 0 of each frame (A rows stride a whole frame), into qkv row 0
    launch_gemm<kBias>(gemm_args(xb, frame, w_qkv, 3 * D, b_qkv, qkvb, 3 * frame, B, D, 0), D,
                       s);
    // k and v for every row: columns [D, 3D)
    launch_gemm<kBias>(gemm_args(xb, D, w_qkv, 3 * D, b_qkv, qkvb, 3 * D, M, D, D), 2 * D, s);
  } else {
    launch_gemm<kBias>(gemm_args(xb, D, w_qkv, 3 * D, b_qkv, qkvb, 3 * D, M, D, 0), 3 * D, s);
  }
  const cudaError_t err =
      attention(qkvb, attnb, B, L, cls_only ? 1 : L, D, H, cls_only ? D : frame, s);
  if (err != cudaSuccess) return (int)err;
  launch_gemm<kBiasResidualLN>(
      with_ln(gemm_args(attnb, D, static_cast<const bf16*>(wo), D,
                        static_cast<const float*>(bo), x1b, D, rows, D, 0),
              xb, x_ld, static_cast<const float*>(g1), static_cast<const float*>(be1)),
      D, s);
  launch_gemm<kBiasRelu>(gemm_args(x1b, D, static_cast<const bf16*>(w1), F,
                                   static_cast<const float*>(b1), hidb, F, rows, D, 0),
                         F, s);
  launch_gemm<kBiasResidualLN>(
      with_ln(gemm_args(hidb, F, static_cast<const bf16*>(w2), D,
                        static_cast<const float*>(b2), static_cast<bf16*>(out), D, rows, F, 0),
              x1b, D, static_cast<const float*>(g2), static_cast<const float*>(be2)),
      D, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* vitiq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1: one full layer (see encoder_layer).
extern "C" int vitiq_encoder_layer_full(
    const void* x, void* out, void* qkv, void* attn, void* x1, void* hid,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* g1, const void* be1, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* g2, const void* be2,
    int B, int L, int D, int H, int F, void* stream_ptr) {
  return encoder_layer(false, x, out, qkv, attn, x1, hid, wqkv, bqkv, wo, bo, g1, be1, w1, b1,
                       w2, b2, g2, be2, B, L, D, H, F, stream_ptr);
}

// K2: the layer for query row 0 only (see encoder_layer).
extern "C" int vitiq_encoder_layer_cls(
    const void* x, void* out, void* qkv, void* attn, void* x1, void* hid,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* g1, const void* be1, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* g2, const void* be2,
    int B, int L, int D, int H, int F, void* stream_ptr) {
  return encoder_layer(true, x, out, qkv, attn, x1, hid, wqkv, bqkv, wo, bo, g1, be1, w1, b1,
                       w2, b2, g2, be2, B, L, D, H, F, stream_ptr);
}
