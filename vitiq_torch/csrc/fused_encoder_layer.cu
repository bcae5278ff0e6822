// Fused post-norm encoder layer for inference on Hopper (sm_90a).
//
// Replaces (TPU Pallas kernels of the JAX reference package):
//   K1  vitiq/ops/pallas/fused_encoder_layer.py: fused_encoder_layer_v3_stack
//       -> _fused_layer_kernel_v3 with the cross-head packed core
//          _v3_attention_core_xpack (every full layer of the stack)
//   K2  vitiq/ops/pallas/fused_encoder_layer.py: _fused_layer_kernel_v3_cls
//       with the chained core _v3_attention_core (last layer, CLS row only)
//   K6  vitiq/ops/pallas/fused_encoder_layer.py: fused_encoder_layer_v3_int8_stack
//       -> _fused_layer_kernel_v3_w8 (every full layer of the int8 W8A8
//          stack; its CLS tail is K2 on dequantized weights), and the v1
//          twin fused_encoder_layer_int8 -> _fused_layer_kernel_int8
//          (VITIQ_FUSED_VERSION=v1, mapped below)
//   K7  vitiq/ops/pallas/fused_encoder_layer.py: fused_encoder_layer_v3_stack
//       with attn_int8=True (VITIQ_ATTN_INT8=1) -> _fused_layer_kernel_v3_attn_int8
//       (every full layer; its CLS tail is K2, bf16)
//   P3  scripts/tpu_probe_exp.py: kernel_noexp, the fused layer with its
//       softmax exp removed (a timing probe outside the package)
//       -> vitiq_encoder_layer_full_noexp: K1 with the NOEXP instance of its
//          one-pass core, attention_core_kernel<DH, true>
//          (vitiq_attention_noexp: that core alone)
//
// Function, per layer, on a bf16 [B, L, D] activation (D = 64, 128 or 256,
// d_head = D / H = 16, 32 or 64; shapes_ok says which shapes the kernels take,
// and fused_encoder_layer.fused_infer_supported is the same predicate):
//   qkv    = bf16(x @ Wqkv + bqkv)          q pre-scaled by log2(e)/sqrt(dh)
//   attn_h = bf16( sum_j p_j v_j / sum_j p_j ),  p_j = bf16(exp2(s_j - m_j))
//            s_j = q_h . k_{h,j} over the L valid keys, m_j the running max:
//            the max over the 64-key tiles up to key j's (full layers, the
//            one-pass core), or over all L keys (K2's two-pass core); the
//            sums in f32 over the rounded p, rescaled by exp2(m_old - m_new)
//            with the numerators when a tile raises the max
//   x1     = bf16(LN(attn @ Wo + bo + x))    LN: biased variance, eps 1e-12,
//   y      = bf16(LN(relu(x1 @ W1 + b1) @ W2 + b2 + x1))   f32 stats, rsqrt
// All four GEMMs accumulate bf16 products in f32 (onto the bias, and the
// residual in the LN stages). K2 computes the same layer for query row 0
// only: K and V cover every token, the output is [B, 1, D].
// Tolerance against the plain version (fused_layer_reference, whose core
// rounds p at the final max): 3e-2 + 1.6e-2 |plain| a layer; rounding p at
// the running max moves a p by a bf16 rounding where its tile's max is not
// the row's, well inside it (`attention_onepass_reference` is the one-pass
// core's own plain version, held to the kernel on the same qkv).
//
// Softmax: the row max IS subtracted. The TPU kernel's exp2 subtracts none
// and relies on |score| < 88; subtracting the max is the same function,
// safe for any score, and rounds the bf16 probabilities at another scale.
//
// Design (for Hopper: wgmma, TMA, mbarriers): five launches per layer on the
// caller's stream.
//   1. gemm_wgmma_kernel<kBias>            QKV (K2: q for row 0, k/v for all rows)
//   2. attention_core_kernel<DH>           the one-pass core, every query row
//      (K2: attention_kernel<DH>, the two-pass mma.sync core for row 0)
//   3. gemm_wgmma_kernel<kBiasResidualLN>  out-projection + bias + residual + LN1
//   4. gemm_wgmma_kernel<kBias>, ReLU      FFN1 + bias + ReLU
//   5. gemm_wgmma_kernel<kBiasResidualLN>  FFN2 + bias + residual + LN2
// The GEMM stages are persistent blocks, one an SM, two warpgroups each, on
// m64nBNk16 wgmma with BN the slab width (the whole N up to 256, else 256 or
// 128; BN = D for the LN stages). W's slab stays resident where K = D (fed
// once by TMA; the warpgroups take row tiles in ping-pong, each refilling
// its own ring of A tiles), else streams beside A through a ring of 64-deep
// steps shared by both warpgroups over 128-row tiles (FFN2, and the
// out-projection at D = 256). Operands arrive by TMA, 128-byte swizzled; the
// accumulators start from the bias (+ residual) and the epilogue works in
// registers: each row of an m64 tile lies in one quad, so the LN statistics
// take two quad shuffles each, and a quad transpose lets each thread store
// 16 bytes of one row. Ragged M: TMA zero-fills rows past M, stores are
// masked. (See the kernel for why there is no producer warp.)
// The attention core: one block per (frame, head), one or two warpgroups on
// 64-row query tiles; k and v arrive by TMA from a 3-D map over qkv (one
// mbarrier per 64-key tile, a box past L zero-filled), Q K^T is m64n64k16
// from q in registers, P V takes P from the accumulators as its register A
// operand and v as an MN-major B operand from its [key][dh] rows, one pass
// with an online softmax, exp2 on MUFU.EX2 (a split of the exp2 with an
// FMA-pipe polynomial was measured slower at every share: PERF.md).
//
// What bounds it on the card: per frame and layer at the flagship shape
// (L = 129, D = 128, F = 512) the GEMMs are ~51 MFLOP and the attention core
// ~8.5 MFLOP, against ~0.7 MB of activation traffic through device memory
// (qkv, attn, x1 and the FFN hidden each written once and read once or
// twice). At ~85 FLOP/byte that is under the bf16 ridge (~295 FLOP/byte), so
// the intermediate round trips (the FFN hidden most of all) bound the GEMM
// stages, which now run near the HBM rate at D = 128 and at ~40% of the
// bf16 peak at D = 256; the attention core is bound by the latency of its
// per-tile chain (Q K^T, softmax, P V in turn) and its softmax issue, not
// by the tensor cores or MUFU (PERF.md).
//
// TPU schedule variants (selected by env knobs in the reference) and what
// computes each here — all are the same function as K1/K2:
//   VITIQ_V3_ATTN=xpack (default), =chain, =kt   -> attention_core_kernel
//       (K2: attention_kernel): heads are independent blocks, so neither the
//       block-diagonal packing (xpack, K13) nor the per-head chain (chain)
//       nor key tiling (kt, K9) has a
//       counterpart; a frame-head's K/V fit shared memory up to ~2.9K
//       tokens at d_head 16 (~1.6K at d_head 32, ~850 at d_head 64, so the
//       conv1d arm's 1025 tokens with n_head 2 are turned away by shapes_ok
//       and run the plain layers); checked against the plain version on the
//       card at the conv1d arm's 1025 tokens.
//   d_model and d_head (no knob: the TPU kernel takes the whole D as one
//   VMEM block and packs any d_head into its xpack core)
//                                                 -> D 64 / 128 / 256: the
//       LN stages' slab is BN = D wide, the other stages' the whole N up to
//       256, else 256 or 128; d_head 16 / 32 / 64: attention_core_kernel
//       instances, one block per frame-head as at every width.
//   VITIQ_V3_PACK (batch packing), VITIQ_V3_G / _LPC (frames per block,
//       layers per call)                          -> one block per frame-head;
//       one host call per layer.
//   VITIQ_V3_TAIL (VPU tail keys), Lp padding to 16 rows and batch padding to
//       a multiple of G                           -> activations stay
//       [B, L, D] unpadded; GEMM loops are bounded by B*L rows, the softmax
//       by L keys. Only the attention cores' shared-memory copies of k/v
//       are zero-filled up to the 64-key tile (TMA) or 16-row MMA tile (K2).
//   VITIQ_V3_HG (head grouping)                   -> heads run in parallel blocks.
//   VITIQ_V3_EPI (div / mul / div2 / div3 / mul2) -> one f32 divide per output
//       element of the head.
//   VITIQ_V3_FUSECLS=1 (mono / combo kernels)     -> the full layers, then K2,
//       as separate launches; the activation between them is in device memory.
//   VITIQ_FUSED_VERSION=v2 (K11), v1 fused_encoder_layer (K12),
//   VITIQ_LONGSEQ=1 v4long (K10, query tiling)    -> K1 (the warpgroups' loop
//       over 64-row query tiles is the query tiling).
//   VITIQ_V3_PROBE                                -> timing-only surgery; none.
//
// K6 (vitiq_encoder_layer_int8_full) is K1 with its four GEMM stages made
// W8A8 (gemm_int8_kernel), the attention stage K1's one-pass core
// (attention_core_kernel):
//   int8_gemm(t) = (f32(rowquant(t) @ Wq^T) * s_row) * s_col + b, with
//   s_row = max(max |t_row|, 1e-8) / 127 over the whole bf16 row and
//   rowquant(t) = clip(rint(t / s_row), -127, 127), int32 accumulation;
//   qkv = bf16(int8_gemm(x)); attn as K1; x1 = bf16(LN(int8_gemm(attn) + x));
//   h = bf16(relu(int8_gemm(x1))); y = bf16(LN(int8_gemm(h) + x1)).
// Each row is quantized once per stage, by whoever sees it whole: x by a
// row-quantization pass (rowquant_kernel) before the QKV stage; x1 by the
// out-projection's LN epilogue, which holds whole rows (its tile is BN = D
// wide) and writes the bf16 row and its int8 levels and scale; attn and the
// FFN hidden by the prologue of the stage that reads them, a stage with one
// column tile, D wide (the FFN2 stage reads each bf16 hidden row once for
// its scale, then quantizes it tile by tile), so no stage needs a whole
// hidden row in one block. The D = 256 stages hold a 32 x 64 warp tile of
// int32 sums (64 registers) and run two blocks per SM; the narrower ones run
// four, capped at 64 registers.
// Products are s8 x s8 -> s32 mma.sync.m16n8k32 tiles; ldmatrix transposes
// only 16-bit elements, so the int8 W operand is kept K-contiguous, [N, K].
// Bound at the ViT shape
// (L = 129, F = 512): ~51 M int8 ops per frame and layer (~26 us per 1000
// frames at 1979 TOP/s) against the same ~0.7 MB of bf16 activation traffic
// as K1 (~0.2 ms per 1000 frames at 3.35 TB/s): with the intermediates'
// round trips counted, device memory bounds it, more so than K1, since the
// int8 rate is twice the bf16 one. No wgmma or TMA yet.
// VITIQ_FUSED_VERSION=v1 (fused_encoder_layer_int8 -> _fused_layer_kernel_int8)
//   -> K6: the same W8A8 layer with the softmax scale applied to f32 scores
//   of the bf16-rounded q instead of folded into q's dequant scales and
//   bias, exp2 with no row max, and denominators over the f32 (unrounded)
//   probabilities; one layer per call.
//
// K7 (vitiq_encoder_layer_attn_int8_full) is K1 with its attention stage
// replaced by attention_int8_kernel, an int8 core (its formulas are at
// the kernel): q levels per row, k and [v | 1] levels per frame-head, scores
// and P [v | 1] as s8 x s8 -> s32 mma.sync.m16n8k32 products, probabilities
// rint(exp2(s - tile max) * 127) in 128-key tiles merged on a running max in
// f32, one f32 divide per output. The ones column of [v | 1] shares v's scale
// (so av >= 1); its s32 product is rint(127 / av) times the row's sum of
// int8 probabilities, the same integer the TPU kernel's ones-column product
// gives. k and [v | 1] are quantized into shared memory once per block, v
// transposed (ldmatrix transposes only 16-bit elements), its keys permuted
// in 32s so that the s32 score fragments repack into P's s8 A fragment in
// registers.
// The TPU kernel's block of G frames (VITIQ_V3_G, _pick_batch_block_v3) ->
// one frame per block: ak and av are per frame-head, which is the TPU
// kernel at G = 1 (its parity test pins g_override=1). Its Lp padding to 16
// rows -> none: the TPU kernel's padded rows carry nonzero k (at least the
// k bias), which enters its ak and each tile's row max; here keys stop at L,
// so at L != Lp the two differ by quantization noise and match closely where
// L = Lp. What bounds K7: its four bf16 GEMM stages are K1's (the bound
// counts their FLOPs at 989 TFLOP/s plus the s8 score and P [v | 1] products,
// 2 L^2 dh + 2 L^2 (dh + 1) operations a frame-head, at 1979 TOP/s); the int8
// core holds half K1's bytes of k and v per key in shared memory, so it
// takes every shape K1 takes. A simple first port: two passes over each
// tile (the row max, then the probabilities), the scores recomputed.

#include "common.cuh"
#include "hopper.cuh"
#include "attention_core.cuh"
#include "gemm_wgmma.cuh"

namespace {

constexpr int BM = 64;    // GEMM tile rows
constexpr int GEMM_THREADS = 256;  // K6's s8 GEMM: 8 warps, 2 x 4 warp tiles of 32 x BN/4
constexpr int ATTN_WARPS = 4;
constexpr int MAX_SMEM = 232448;  // shared memory a block may use on Hopper
constexpr int STATIC_SMEM = 48 * 1024;  // static shared memory a block may use
constexpr float LN_EPS = 1e-12f;
constexpr float ROW_SCALE_FLOOR = 1e-8f;  // K6's row scale: max(absmax, 1e-8) / 127

// The f32 staging tile of K6's GEMM stages, [BM][c_ld]: BN columns padded
// against bank conflicts.
template <int BN>
__host__ __device__ constexpr int c_ld() { return BN + 4; }

// kBiasResidualLNQuant: kBiasResidualLN that also writes the bf16 output row
// quantized for the next int8 GEMM (int8 row and its scale), K6 only.
enum Epilogue { kBias = 0, kBiasRelu = 1, kBiasResidualLN = 2, kBiasResidualLNQuant = 3 };

struct GemmArgs {
  const bf16* a;      // A rows: row r starts at a + r * lda, K contiguous values
  long long lda;
  const bf16* w;      // W [K, ldw] row-major
  int ldw;
  const float* bias;  // [ldw]
  bf16* c;            // C row r, column n at c + r * ldc + n
  long long ldc;
  long long m;        // rows
  int k;              // depth (multiple of 64)
  int col0;           // first column of W / C this launch computes
  int n_tiles;        // BN-wide column tiles this launch computes
  const bf16* res;    // residual rows (LN epilogue), row r at res + r * ldr
  long long ldr;
  const float* gamma;
  const float* beta;
  int8_t* cq;         // kBiasResidualLNQuant: the output rows quantized, [m, BN]
  float* cscale;      // and their scales [m]
  // the bf16 wgmma stages' kBias epilogue: then ReLU. A runtime flag there
  // (K6's s8 stages take kBiasRelu as a template argument): FFN1 then shares
  // the QKV stage's instances instead of adding one wgmma instance per slab
  // width and W layout to every build, for one warp-uniform branch a tile.
  int relu;
};

// K6's activation quantization: the row scale from the row's absmax, and a
// value's level, clip(rint(v / s), -127, 127) with an IEEE divide and round
// half to even, as the TPU kernel's _row_quant.
__device__ __forceinline__ float row_scale_of(float amax) {
  return fmaxf(amax, ROW_SCALE_FLOOR) / 127.0f;
}

__device__ __forceinline__ int8_t quantize1(float v, float s) {
  return static_cast<int8_t>(max(-127, min(127, __float2int_rn(__fdiv_rn(v, s)))));
}

__device__ __forceinline__ uint32_t quantize4(float v0, float v1, float v2, float v3, float s) {
  const float v[4] = {v0, v1, v2, v3};
  uint32_t packed = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    packed |= (static_cast<uint32_t>(quantize1(v[b], s)) & 0xffu) << (8 * b);
  return packed;
}

// 8 bf16 (one 16-byte chunk) -> 8 int8 levels (one 8-byte chunk)
__device__ __forceinline__ uint2 quantize8(const uint4& chunk, float s) {
  const bf16* e = reinterpret_cast<const bf16*>(&chunk);
  auto f = [&](int i) { return __bfloat162float(e[i]); };
  return make_uint2(quantize4(f(0), f(1), f(2), f(3), s), quantize4(f(4), f(5), f(6), f(7), s));
}

__device__ __forceinline__ float absmax8(const uint4& chunk, float amax) {
  const bf16* e = reinterpret_cast<const bf16*>(&chunk);
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
  return amax;
}

template <int BN>
__host__ __device__ constexpr int c_bytes() { return BM * c_ld<BN>() * (int)sizeof(float); }

// K6's GEMM epilogue over the block's f32 product tile Cs [BM][c_ld] (rows
// m0.., columns n0..): + bias, + bias then ReLU, or + bias + residual then
// LayerNorm over the whole row (the tile holds all D = BN columns), the same
// arithmetic as the bf16 stages' (gemm_wgmma_epilogue), whose accumulators start
// from the bias and the residual: the same sums in another order.
template <int EPI, int BN>
__device__ __forceinline__ void gemm_epilogue(const float* Cs, const GemmArgs& p, long long m0,
                                              int n0, int tid) {
  constexpr int C_LD = c_ld<BN>();
  const int warp = tid >> 5, lane = tid & 31;
  if constexpr (EPI == kBiasResidualLN || EPI == kBiasResidualLNQuant) {
    // one warp per row, BN / 32 columns per lane; the tile holds the whole row
    constexpr int PER_LANE = BN / 32;
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      const long long gm = m0 + r;
      if (gm >= p.m) break;  // warp-uniform
      float v[PER_LANE];
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) {
        const int c = lane + 32 * t;
        v[t] = Cs[r * C_LD + c] + p.bias[c] + __bfloat162float(p.res[gm * p.ldr + c]);
        s += v[t];
      }
      const float mean = warp_sum(s) * (1.0f / BN);
      float q = 0.f;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) {
        const float d = v[t] - mean;
        q += d * d;
      }
      const float rstd = rsqrtf(warp_sum(q) * (1.0f / BN) + LN_EPS);
      float amax = 0.f;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) {
        const int c = lane + 32 * t;
        const bf16 y = __float2bfloat16(p.gamma[c] * ((v[t] - mean) * rstd) + p.beta[c]);
        p.c[gm * p.ldc + c] = y;
        v[t] = __bfloat162float(y);
        amax = fmaxf(amax, fabsf(v[t]));
      }
      if constexpr (EPI == kBiasResidualLNQuant) {
        // the bf16-rounded row, quantized as the next GEMM's input
        const float sc = row_scale_of(warp_max(amax));
#pragma unroll
        for (int t = 0; t < PER_LANE; ++t) p.cq[gm * BN + lane + 32 * t] = quantize1(v[t], sc);
        if (lane == 0) p.cscale[gm] = sc;
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

// ---- K6: the W8A8 GEMM stage ----------------------------------------------
constexpr int QBK = 64;                // k-step depth: 64 int8 = 64 bytes of a row
constexpr int Q_LD = QBK + 16;         // int8 shared-memory row stride (bank-conflict
                                       // pad; 80 bytes keeps rows 16-byte aligned)
constexpr int QA_TILE = BM * Q_LD;     // bytes of one stage's quantized A tile
template <int BN>  // bytes of its int8 W tile ([n][k])
__host__ __device__ constexpr int qb_tile() { return BN * Q_LD; }
template <int BN>
__host__ __device__ constexpr int qgemm_smem() {
  return 2 * (QA_TILE + qb_tile<BN>()) > c_bytes<BN>() ? 2 * (QA_TILE + qb_tile<BN>())
                                                       : c_bytes<BN>();
}
constexpr int MAX_QUANT_K = 1024;      // rowquant_kernel: 4 chunks of 8 per lane

// One warp per row: q[r, :] = rowquant(a[r, :]) and s[r] for a bf16 [m, k]
// (k % 8 == 0, k <= MAX_QUANT_K): the row is read once into registers, its
// absmax reduced across the warp, then each value quantized.
__global__ void __launch_bounds__(256) rowquant_kernel(const bf16* __restrict__ a,
                                                      int8_t* __restrict__ q,
                                                      float* __restrict__ s, long long m, int k) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= m) return;  // warp-uniform
  const bf16* row = a + r * k;
  uint4 chunks[MAX_QUANT_K / 256];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_QUANT_K / 256; ++j) {
    const int c = (lane + 32 * j) * 8;
    chunks[j] = c < k ? *reinterpret_cast<const uint4*>(row + c) : make_uint4(0u, 0u, 0u, 0u);
    amax = absmax8(chunks[j], amax);
  }
  const float sc = row_scale_of(warp_max(amax));
#pragma unroll
  for (int j = 0; j < MAX_QUANT_K / 256; ++j) {
    const int c = (lane + 32 * j) * 8;
    if (c < k) *reinterpret_cast<uint2*>(q + r * k + c) = quantize8(chunks[j], sc);
  }
  if (lane == 0) s[r] = sc;
}

// C[:, n0 .. n0 + BN) = epilogue(dequant(rowquant(A) @ Wq^T)) for one 64 x
// BN tile per block, A rows of p.k values, Wq int8 [N, p.k] (K contiguous:
// nn.Linear's [out, in]) with per-column scales wscale [N]. A comes
//   PREQ = false  as bf16 (p.a): a prologue takes each row's scale over the
//                 whole row (one warp per row) before any product, and the k
//                 loop quantizes the A tiles on their way to shared memory
//                 (stages whose A is read by one column tile: out-projection,
//                 FFN2);
//   PREQ = true   already quantized (aq [m, p.k] int8, ascale [m]): from
//                 rowquant_kernel or a kBiasResidualLNQuant epilogue, so a
//                 stage with several column tiles (QKV, FFN1) quantizes each
//                 row once, not once per tile; A tiles arrive by cp.async.
// W tiles arrive by cp.async; two stages, the next tile's loads in flight
// during this one's s8 x s8 -> s32 products on the tensor cores
// (mma.sync.m16n8k32, each warp a 32 x BN/4 sub-tile). Epilogue:
// Cs = (f32(acc) * s_r) * wscale[n], then gemm_epilogue.
// |q_a q_w| summed over K <= 1040 stays below 2^24, so f32(acc) is the exact
// sum, the same number an f32 product of the integer operands gives.
// Four blocks per SM up to BN = 128 (64 registers, a few bytes spilled in the
// PREQ = false variants): the blocks are short and latency-bound, and the
// fourth block made a ViT layer 4.5% faster than three at 78 registers. At
// BN = 256 a warp holds 64 int32 sums, so two blocks per SM.
template <int EPI, bool PREQ, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, BN >= 256 ? 2 : 4) gemm_int8_kernel(
    GemmArgs p, const int8_t* __restrict__ aq, const float* __restrict__ ascale,
    const int8_t* __restrict__ wq, const float* __restrict__ wscale) {
  constexpr int C_LD = c_ld<BN>(), QB_TILE = qb_tile<BN>();
  constexpr int WN = BN / 4, NJ = WN / 8;  // warp tile columns, n8 blocks across
  constexpr int SMEM = qgemm_smem<BN>();
  // static shared memory up to 48 KB, dynamic above (launch_gemm_int8_bn)
  __shared__ __align__(128) unsigned char static_buf[SMEM <= STATIC_SMEM ? SMEM : 16];
  extern __shared__ __align__(128) unsigned char qgemm_buf[];
  __shared__ float row_scale[BM];
  unsigned char* smem = SMEM <= STATIC_SMEM ? static_buf : qgemm_buf;
  int8_t* stages = reinterpret_cast<int8_t*>(smem);  // [2][A tile | W tile]
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = (long long)(blockIdx.x / p.n_tiles) * BM;
  const int n0 = p.col0 + (int)(blockIdx.x % p.n_tiles) * BN;
  const int wm = warp >> 2, wn = warp & 3;

  if constexpr (PREQ) {
    if (tid < BM) row_scale[tid] = m0 + tid < p.m ? ascale[m0 + tid] : 1.f;
  } else {
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      const long long gm = m0 + r;
      float amax = 0.f;
      if (gm < p.m) {
        const bf16* row = p.a + gm * p.lda;
        for (int c = lane * 8; c < p.k; c += 32 * 8)
          amax = absmax8(*reinterpret_cast<const uint4*>(row + c), amax);
      }
      amax = warp_max(amax);
      if (lane == 0) row_scale[r] = row_scale_of(amax);
    }
  }
  __syncthreads();

  // each thread moves two 16-byte chunks of bf16 A (8 values) or one of
  // int8 A (16 values), and BN / 64 of W (16 int8 each)
  uint4 a_regs[2];
  auto load_a = [&](int k0) {  // bf16 A tile -> registers
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * GEMM_THREADS;
      const int r = i >> 3, c = (i & 7) * 8;
      const long long gm = m0 + r;
      a_regs[j] = gm < p.m ? *reinterpret_cast<const uint4*>(p.a + gm * p.lda + k0 + c)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_a = [&](int stage) {  // registers -> quantized A tile
    int8_t* As = stages + stage * (QA_TILE + QB_TILE);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * GEMM_THREADS;
      const int r = i >> 3, c = (i & 7) * 8;
      *reinterpret_cast<uint2*>(As + r * Q_LD + c) = quantize8(a_regs[j], row_scale[r]);
    }
  };
  auto load_stage = [&](int stage, int k0) {  // cp.async: W tile (and int8 A tile)
    int8_t* As = stages + stage * (QA_TILE + QB_TILE);
    int8_t* Bs = As + QA_TILE;
    if constexpr (PREQ) {
      const int r = tid >> 2, c = (tid & 3) * 16;
      const long long gm = m0 + r;
      const bool in = gm < p.m;
      cp_async16(As + r * Q_LD + c, aq + (in ? gm : 0) * p.k + k0 + c, in ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) {
      const int i = tid + j * GEMM_THREADS;
      const int n = i >> 2, c = (i & 3) * 16;
      cp_async16(Bs + n * Q_LD + c, wq + (long long)(n0 + n) * p.k + k0 + c, 16);
    }
    cp_async_commit();
  };

  int acc[2][NJ][4] = {};
  const int nk = p.k / QBK;
  load_stage(0, 0);
  if constexpr (!PREQ) {
    load_a(0);
    store_a(0);
  }
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) {
      load_stage((kt + 1) & 1, (kt + 1) * QBK);
      if constexpr (!PREQ) load_a((kt + 1) * QBK);
      cp_async_wait<1>();  // this k-step's tiles have landed, the next may not
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* As = stages + (kt & 1) * (QA_TILE + QB_TILE);
    const int8_t* Bs = As + QA_TILE;
#pragma unroll
    for (int kk = 0; kk < QBK; kk += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* lo = As + (wm * 32 + i * 16 + g) * Q_LD + kk + 4 * t;
        const int8_t* hi = lo + 8 * Q_LD;
        af[i][0] = *reinterpret_cast<const uint32_t*>(lo);
        af[i][1] = *reinterpret_cast<const uint32_t*>(hi);
        af[i][2] = *reinterpret_cast<const uint32_t*>(lo + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(hi + 16);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int8_t* col = Bs + (wn * WN + j * 8 + g) * Q_LD + kk + 4 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(col);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(col + 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8_16832(acc[i][j], af[i], b0, b1);
      }
    }
    // the other stage was last read in the previous k-step, which every warp
    // has left (the barrier below it), so its A tile may be written now
    if constexpr (!PREQ) {
      if (more) store_a((kt + 1) & 1);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + g + 8 * h, c = wn * WN + j * 8 + 2 * t;
        const float s = row_scale[r];
        Cs[r * C_LD + c] = __fmul_rn(__fmul_rn(static_cast<float>(acc[i][j][2 * h]), s),
                                     wscale[n0 + c]);
        Cs[r * C_LD + c + 1] = __fmul_rn(
            __fmul_rn(static_cast<float>(acc[i][j][2 * h + 1]), s), wscale[n0 + c + 1]);
      }
  __syncthreads();
  gemm_epilogue<EPI, BN>(Cs, p, m0, n0, tid);
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

// K2's attention core: one block per (frame b, head h), query rows 0..n_q-1
// (K2 takes n_q = 1, where a 64-row wgmma tile would waste 63 rows). qkv:
// [B, L, 3D] bf16 with q in columns [0, D) (only rows < n_q are read), k in
// [D, 2D), v in [2D, 3D). Writes query rows 0..n_q-1 of head h to out +
// b*out_frame_stride + i*D + h*DH.
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

// ---- K1's attention core on Hopper: one pass, wgmma, TMA -------------------
// (its key tile, core_tile, is in attention_core.cuh, shared with K5-fwd)
constexpr int CORE_WG = 2;   // the most warpgroups of the core's block

// Shared memory of the core at L tokens: the frame-head's k and v rows in
// 64-key tiles (zero past L), one mbarrier per tile, and 1 KB to align the
// tiles to the swizzle's 1024-byte repeat. fused_encoder_layer.core_smem_bytes
// repeats it for the host-side tests, which run without this library.
__host__ __device__ __forceinline__ size_t core_smem_bytes(int L, int dh) {
  const size_t n_kt = (L + CORE_KT - 1) / CORE_KT;
  return n_kt * CORE_KT * dh * 2 * 2 + n_kt * 8 + 1024;
}

// One block per (frame b, head h), all L query rows, out [B, L, D] (row i of
// frame b at out + b * out_frame_stride + i * D):
//   per 64-key tile: s = q k^T (log2 units), m' = max(m, max s),
//     a = exp2(m - m'), l = l a + sum_j bf16(exp2(s_j - m')),
//     o = o a + bf16(p) v;   out = bf16(o / l)
// i.e. each p is rounded at the running max, the denominator is the f32 sum
// of the rounded p, rescaled with o.
// Thread 0 loads the head's k and v tiles by TMA from the 3-D map over qkv
// [B, L, 3D] (a box past L arrives as zeros), each tile completing on its
// own mbarrier, so the first query tile starts while later keys load. The
// block's one or two warpgroups (launch_core picks the count that keeps more
// on an SM) then take 64-row query tiles in turn: q in registers as the A
// operand of Q K^T (m64n64k16, B = the k tile, K-major, swizzled by the row
// width), the online softmax on the accumulators, and P V with P packed from
// the accumulators straight into the A fragment and v read as an MN-major B
// operand from its [key][dh] rows. Ragged edges
// (L = 65, 129, 1025 leave one key and one query row): a last key tile of
// at most 16 keys runs 16 wide (m64n16k16), a wider one skips the exp2 of
// its dead 16-key groups (their p are zeros, their v rows arrived as zeros),
// and a warp whose 16 query rows all lie past L does no softmax work (its P
// is zero). Every wgmma is issued by the whole warpgroup on every path: one
// under a branch makes ptxas serialize them.
// NOEXP (P3, scripts/tpu_probe_exp.py: kernel_noexp, a timing probe): every
// exp2 removed, the running max kept: p = (s - m') + m' by IEEE-rounded ops
// (0 past L), the rescale's factor 1 computed from m - m' by IEEE ops (so the
// rescale stays live), the denominator the f32 sum of the unrounded p.
template <int DH, bool NOEXP>
__global__ void __launch_bounds__(CORE_WG * 128, DH == 64 ? 1 : 2) attention_core_kernel(
    const __grid_constant__ CUtensorMap kv_map, const bf16* __restrict__ qkv,
    bf16* __restrict__ out, int L, int D, long long out_frame_stride) {
  constexpr int TILE = CORE_KT * DH * 2;  // bytes of a k or v tile
  extern __shared__ unsigned char core_raw[];
  unsigned char* smem = core_raw + ((1024 - (smem_u32(core_raw) & 1023)) & 1023);
  const int n_kt = (L + CORE_KT - 1) / CORE_KT;
  unsigned char* ks = smem;
  unsigned char* vs = smem + (size_t)n_kt * TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)2 * n_kt * TILE);
  const int b = blockIdx.x, h = blockIdx.y;

  if (threadIdx.x == 0) {
    for (int i = 0; i < n_kt; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_kt; ++i) {
      mbar_expect_tx(&bars[i], 2 * TILE);
      tma_load_3d(ks + (size_t)i * TILE, &kv_map, &bars[i], D + h * DH, i * CORE_KT, b);
      tma_load_3d(vs + (size_t)i * TILE, &kv_map, &bars[i], 2 * D + h * DH, i * CORE_KT, b);
    }
  }

  // warpgroup and warp indices broadcast from lane 0, so that ptxas sees
  // them warp-uniform: wgmma under control flow it takes for divergent is
  // serialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row3 = 3LL * D;
  const bf16* base = qkv + (long long)b * L * row3 + (long long)h * DH;
  const uint32_t ks_addr = smem_u32(ks), vs_addr = smem_u32(vs);
  float s[32] = {};
  const int n_wg = blockDim.x >> 7;
  for (int q0 = wg * 64; q0 < L; q0 += n_wg * 64) {
    const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
    const bool live = q0 + warp * 16 < L;  // warp-uniform
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const bf16* q_lo = base + r_lo * row3 + kk * 16 + 2 * t;
      const bf16* q_hi = base + r_hi * row3 + kk * 16 + 2 * t;
      qa[kk][0] = r_lo < L ? ld_b32(q_lo) : 0u;
      qa[kk][1] = r_hi < L ? ld_b32(q_hi) : 0u;
      qa[kk][2] = r_lo < L ? ld_b32(q_lo + 8) : 0u;
      qa[kk][3] = r_hi < L ? ld_b32(q_hi + 8) : 0u;
    }
    float o[DH / 2] = {};
    float lsum[2] = {0.f, 0.f};
    float m_lo = -INFINITY, m_hi = -INFINITY;
    for (int kt = 0; kt < n_kt; ++kt) {
      mbar_wait(&bars[kt], 0);
      const int valid = L - kt * CORE_KT;  // keys of this tile, uniform
      const uint32_t k_tile = ks_addr + kt * TILE, v_tile = vs_addr + kt * TILE;
      if (valid <= 16)
        core_tile<DH, NOEXP, 16>(s, o, lsum, m_lo, m_hi, qa, k_tile, v_tile, valid, live, t);
      else
        core_tile<DH, NOEXP, CORE_KT>(s, o, lsum, m_lo, m_hi, qa, k_tile, v_tile, valid, live,
                                      t);
    }
    const float l_lo = quad_sum(lsum[0]), l_hi = quad_sum(lsum[1]);
    bf16* o_base = out + (long long)b * out_frame_stride + h * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (r_lo < L)
        *reinterpret_cast<uint32_t*>(o_base + (long long)r_lo * D + j * 8) =
            pack_bf16x2(o[4 * j] / l_lo, o[4 * j + 1] / l_lo);
      if (r_hi < L)
        *reinterpret_cast<uint32_t*>(o_base + (long long)r_hi * D + j * 8) =
            pack_bf16x2(o[4 * j + 2] / l_hi, o[4 * j + 3] / l_hi);
    }
  }
}

// ---- K1's GEMM stages on Hopper: persistent wgmma blocks fed by TMA ------
// C[:, n0 .. n0 + BN) = epilogue(A @ W + bias) over 64-row tiles: the shared
// main loop of gemm_wgmma.cuh with A K-major and W [K, N] an MN-major B,
// resident where K = D <= 256 (QKV, FFN1, the out-projection below D = 256),
// streamed otherwise (FFN2; the out-projection at D = 256).
// The accumulators start from the bias (and the residual row, for the
// LayerNorm stages), so the wgmma adds the products onto them; the epilogue
// then works in registers (each row of the m64 tile lies in one quad of four
// threads): ReLU, or LayerNorm over the whole row (BN = N = D: the mean and
// the variance by two quad shuffles each), then bf16 stored 16 bytes a
// thread. Rows past M arrive as zeros and are not stored. Registers: there
// is no producer warp and no setmaxnreg (see gemm_wgmma.cuh).

// The accumulators of a warpgroup's 64 x BN tile before its first wgmma:
// the bias, plus (LayerNorm stages) the residual row (zeros past M), so that
// the products accumulate onto them: C = (bias + res) + A W. Accumulator e
// is row row0 + 16 warp + g (+ 8 where (e >> 1) & 1), column 8 (e / 4) + 2t
// + (e & 1). vec: bias, gamma, beta of the slab's columns (shared memory).
template <int EPI, int BN>
__device__ __forceinline__ void init_accumulators(float* acc, const GemmArgs& p, long long row0,
                                                  const float* vec, int warp, int g, int t) {
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const int c = (e >> 2) * 8 + 2 * t;
    const float2 b = *reinterpret_cast<const float2*>(vec + c);
    float2 r = make_float2(0.f, 0.f);
    if constexpr (EPI == kBiasResidualLN) {
      const long long row = row0 + warp * 16 + g + 8 * ((e >> 1) & 1);
      if (row < p.m) {
        const uint32_t word = ld_b32(p.res + row * p.ldr + c);
        r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&word));
      }
    }
    acc[e] = b.x + r.x;
    acc[e + 1] = b.y + r.y;
  }
}

// The epilogue of a warpgroup's 64 x BN tile from its accumulators (bias
// and residual already in them): ReLU where p.relu, or LayerNorm over the
// whole row (BN = N = D); then bf16, stored 16 bytes a thread.
template <int EPI, int BN>
__device__ __forceinline__ void gemm_wgmma_epilogue(float* acc, const GemmArgs& p, long long row0,
                                                    int n0, const float* vec, int warp, int g,
                                                    int t) {
  const long long rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  if constexpr (EPI == kBiasResidualLN) {
    // centred in place (acc - mean computed once: kept for both the variance
    // and the normalization, the centred values doubled the registers)
    float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f}, rstd[2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) sum[(e >> 1) & 1] += acc[e];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) sum[hh] = quad_sum(sum[hh]) * (1.0f / BN);  // the mean
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      acc[e] -= sum[(e >> 1) & 1];
      sq[(e >> 1) & 1] += acc[e] * acc[e];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) rstd[hh] = rsqrtf(quad_sum(sq[hh]) * (1.0f / BN) + LN_EPS);
#pragma unroll
    for (int e = 0; e < BN / 2; e += 2) {
      const int c = (e >> 2) * 8 + 2 * t;
      const float2 gm = *reinterpret_cast<const float2*>(vec + BN + c);
      const float2 bt = *reinterpret_cast<const float2*>(vec + 2 * BN + c);
      const float r = rstd[(e >> 1) & 1];
      acc[e] = gm.x * (acc[e] * r) + bt.x;
      acc[e + 1] = gm.y * (acc[e + 1] * r) + bt.y;
    }
  } else if (p.relu) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = fmaxf(acc[e], 0.f);
  }
  store_tile_bf16<BN>(acc, p.c, p.ldc, rows, p.m, n0, t);
}

template <int EPI, int BN, bool RESIDENT>
__global__ void __launch_bounds__(GW_THREADS, 1) gemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap w_map,
    GemmArgs p, int ring) {
  extern __shared__ unsigned char gw_raw[];
  const GwLayout s = gw_layout<BN, RESIDENT>(gw_raw, p.k, ring, 3 * BN * 4);
  float* vec = reinterpret_cast<float*>(s.extra);
  const int slab = blockIdx.x % p.n_tiles, stride = gridDim.x / p.n_tiles;
  const int first = blockIdx.x / p.n_tiles;
  const int n0 = p.col0 + slab * BN;
  const long long tm = RESIDENT ? 64 : 128;
  const int n_rt = (int)((p.m + tm - 1) / tm);
  const GwThread th = gw_thread();

  for (int i = threadIdx.x; i < BN; i += GW_THREADS) {
    vec[i] = p.bias[n0 + i];
    if (EPI == kBiasResidualLN) {
      vec[BN + i] = p.gamma[i];
      vec[2 * BN + i] = p.beta[i];
    }
  }
  gemm_wgmma_loop<BN, RESIDENT, 0, 1, false>(
      a_map, w_map, s, p.k, n0, first, stride, n_rt, n_rt, ring, th,
      [&](float* acc, long long row0) {
        init_accumulators<EPI, BN>(acc, p, row0, vec, th.warp, th.g, th.t);
      },
      [&](float* acc, long long row0, int) {
        gemm_wgmma_epilogue<EPI, BN>(acc, p, row0, n0, vec, th.warp, th.g, th.t);
      });
}

// ---- K7: the int8 attention core ------------------------------------------
// Shared memory of attention_int8_kernel at L tokens: the head's int8 k rows
// [key][DH + 16] and [v | 1]'s v part transposed [dim][round32(L) + 16],
// keys rounded up to the 32 of an s8 k-step (the pads keep the eight rows a
// fragment load touches on distinct banks).
template <int DH>
__host__ __device__ constexpr int k8_ld() { return DH + 16; }
__host__ __device__ __forceinline__ int round32(int n) { return (n + 31) & ~31; }
__host__ __device__ __forceinline__ int v8_ld(int L) { return round32(L) + 16; }

template <int DH>
__host__ __device__ __forceinline__ size_t attention_int8_smem_bytes(int L) {
  return (size_t)round32(L) * k8_ld<DH>() + (size_t)DH * v8_ld(L);
}

constexpr int K7_TILE = 128;               // keys per tile, as the TPU kernel's
constexpr float K7_SCALE_FLOOR = 1e-8f;    // aq, ak floor
constexpr float K7_DEQ = 127.0f * 127.0f;  // scores = s32 * aq * (ak / 127^2)

// round(v * m) as an int8 level (|v * m| <= 127 by construction: m = 127 /
// absmax of the values v comes from)
__device__ __forceinline__ int level(float v, float m) { return __float2int_rn(__fmul_rn(v, m)); }

// The column of key j in the transposed v: within each 32 keys, key
// 16h + 8a + 2t + e sits at 16h + 4t + 2a + e, so that the probabilities a
// thread holds in the s32 score fragments (keys 2t, 2t+1 of each 8) form the
// s8 A fragment of the P V product as they are (k = 4t.. | 16 + 4t..).
__device__ __forceinline__ int v8_col(int j) {
  const int r = j & 31;
  return (j & ~31) + (r & 16) + ((r >> 1) & 3) * 4 + ((r >> 3) & 1) * 2 + (r & 1);
}

// s32 scores of the warp's 16 query rows (qa: their int8 levels, DH / 32
// k-steps; DH = 16 pads the k-step with zeros) against keys [j0, j0 + 32):
// four 16 x 8 blocks, dequantized to f32 (float(s) * deq of the row) and -inf
// past L; `raw` keeps the integer sums.
template <int DH>
__device__ __forceinline__ void score_block_int8(float sc[4][4], int raw[4][4],
                                                 const uint32_t qa[][4], const int8_t* ks,
                                                 int j0, int L, float deq_lo, float deq_hi,
                                                 int g, int t) {
  constexpr int KC = DH < 32 ? 1 : DH / 32;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    int c[4] = {0, 0, 0, 0};
    const int8_t* krow = ks + (j0 + nb * 8 + g) * k8_ld<DH>() + 4 * t;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kc * 32);
      const uint32_t b1 = DH < 32 ? 0u : *reinterpret_cast<const uint32_t*>(krow + kc * 32 + 16);
      mma_s8_16832(c, qa[kc], b0, b1);
    }
    const int key = j0 + nb * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      raw[nb][i] = c[i];
      sc[nb][i] = (key + (i & 1) < L) ? __fmul_rn(static_cast<float>(c[i]), i < 2 ? deq_lo : deq_hi)
                                      : -INFINITY;
    }
  }
}

__device__ __forceinline__ int quad_sum_int(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One block per (frame b, head h), K7's attention core on qkv [B, L, 3D]
// (q pre-scaled by log2(e)/sqrt(dh)), all L query rows, out [B, L, D]:
//   aq_i = max(max_d |q_id|, 1e-8)            per query row
//   ak   = max(max_jd |k_jd|, 1e-8)           per frame-head
//   av   = max(max_jd |v_jd|, 1)              per frame-head: [v | 1]'s scale,
//                                             the ones column in v's scale
//   qq = rint(q * (127 / aq)), kq = rint(k * (127 / ak)), vq = rint(v * (127 / av)),
//   one = rint(127 / av)
//   per 128-key tile: s = float(qq . kq) * (aq * (ak / 127^2)), m = tile row max,
//     p = rint(exp2(s - m) * 127) (int8), part = [p . vq | one * sum p] (s32)
//   tiles merged in f32: acc = acc * exp2(acc_m - new_m) + part * exp2(m - new_m)
//   out = bf16(acc[:dh] / acc[dh])
// Every rounding is the one the plain version (and the TPU kernel) takes:
// IEEE quotients, products and sums (__fdiv_rn, __fmul_rn, __fadd_rn: no
// contraction into FMAs), round half to even, so on the same qkv the s32
// products are the plain version's bit for bit.
// The block quantizes k into shared memory [key][dim] (the B operand of
// Q K^T) and v transposed [dim][key'] (keys permuted in 32s, v8_col) for
// P V; each warp takes 16 query rows at a time, quantizes them in registers
// (a quad holds a row), and makes two passes over each tile's keys in 32s
// on the s8 tensor cores (mma.sync.m16n8k32): the row max, then the
// probabilities, whose s32 score fragments are repacked as P's A fragment
// in registers. With DUMP, the s32 scores, the int8 probabilities and each
// tile's s32 [P V | den] go to device memory for the check against the
// plain version: s_dump [B, H, L, L], p_dump [B, H, L, L], pv_dump
// [B, H, ceil(L / 128), L, DH + 1].
template <int DH, bool DUMP>
__global__ void __launch_bounds__(ATTN_WARPS * 32) attention_int8_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out, int L, int D,
    int* __restrict__ s_dump, int8_t* __restrict__ p_dump, int* __restrict__ pv_dump) {
  static_assert(DH % 16 == 0, "head width must be a multiple of 16");
  constexpr int KC = DH < 32 ? 1 : DH / 32, KLD = k8_ld<DH>(), CH = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][ATTN_WARPS];
  const int lp = round32(L), vld = v8_ld(L);
  int8_t* ks = reinterpret_cast<int8_t*>(smem);  // [lp][KLD]
  int8_t* vt = ks + (size_t)lp * KLD;            // [DH][vld]

  const int b = blockIdx.x, h = blockIdx.y, H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row3 = 3LL * D;
  const bf16* base = qkv + (long long)b * L * row3 + (long long)h * DH;

  // the frame-head's k and v absmax
  float ka = 0.f, va = 0.f;
  for (int i = threadIdx.x; i < L * CH; i += blockDim.x) {
    const int j = i / CH, c = (i % CH) * 8;
    ka = absmax8(*reinterpret_cast<const uint4*>(base + j * row3 + D + c), ka);
    va = absmax8(*reinterpret_cast<const uint4*>(base + j * row3 + 2 * D + c), va);
  }
  ka = warp_max(ka);
  va = warp_max(va);
  if (lane == 0) {
    red[0][warp] = ka;
    red[1][warp] = va;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < ATTN_WARPS; ++w) {
    ka = fmaxf(ka, red[0][w]);
    va = fmaxf(va, red[1][w]);
  }
  const float ak = fmaxf(ka, K7_SCALE_FLOOR), av = fmaxf(va, 1.0f);
  const float kmul = __fdiv_rn(127.f, ak), vmul = __fdiv_rn(127.f, av);
  const int one = __float2int_rn(vmul);
  const float ak_deq = __fdiv_rn(ak, K7_DEQ);

  // quantized k [key][dim] and v^T [dim][key'] in shared memory, zero past L
  for (int i = threadIdx.x; i < lp * CH; i += blockDim.x) {
    const int j = i / CH, c = (i % CH) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (j < L) {
      kv = *reinterpret_cast<const uint4*>(base + j * row3 + D + c);
      vv = *reinterpret_cast<const uint4*>(base + j * row3 + 2 * D + c);
    }
    const bf16* k8 = reinterpret_cast<const bf16*>(&kv);
    const bf16* v8 = reinterpret_cast<const bf16*>(&vv);
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo |= (static_cast<uint32_t>(level(__bfloat162float(k8[e]), kmul)) & 0xffu) << (8 * e);
      hi |= (static_cast<uint32_t>(level(__bfloat162float(k8[e + 4]), kmul)) & 0xffu) << (8 * e);
    }
    *reinterpret_cast<uint2*>(ks + j * KLD + c) = make_uint2(lo, hi);
    const int col = v8_col(j);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      vt[(c + e) * vld + col] = static_cast<int8_t>(level(__bfloat162float(v8[e]), vmul));
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (L + K7_TILE - 1) / K7_TILE;
  for (int r0 = warp * 16; r0 < L; r0 += ATTN_WARPS * 16) {
    const int r_lo = r0 + g, r_hi = r0 + g + 8;
    // this thread's q values: rows r_lo / r_hi, dims 32kc + 4t.. and 32kc + 16 + 4t..
    float qf[KC][4][4];
    float amax_lo = 0.f, amax_hi = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = (a & 1) ? r_hi : r_lo, d0 = kc * 32 + (a >> 1) * 16 + 4 * t;
        uint2 raw = make_uint2(0u, 0u);
        if (r < L && d0 < DH) raw = *reinterpret_cast<const uint2*>(base + r * row3 + d0);
        const bf16* q4 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qf[kc][a][e] = __bfloat162float(q4[e]);
          if (a & 1)
            amax_hi = fmaxf(amax_hi, fabsf(qf[kc][a][e]));
          else
            amax_lo = fmaxf(amax_lo, fabsf(qf[kc][a][e]));
        }
      }
    const float aq_lo = fmaxf(quad_max(amax_lo), K7_SCALE_FLOOR);
    const float aq_hi = fmaxf(quad_max(amax_hi), K7_SCALE_FLOOR);
    const float qmul_lo = __fdiv_rn(127.f, aq_lo), qmul_hi = __fdiv_rn(127.f, aq_hi);
    const float deq_lo = __fmul_rn(aq_lo, ak_deq), deq_hi = __fmul_rn(aq_hi, ak_deq);
    uint32_t qa[KC][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        uint32_t packed = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          packed |= (static_cast<uint32_t>(level(qf[kc][a][e], (a & 1) ? qmul_hi : qmul_lo)) &
                     0xffu) << (8 * e);
        qa[kc][a] = packed;
      }

    float acc[DH / 8][4], den_lo = 0.f, den_hi = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int c0 = tile * K7_TILE, c1 = min(c0 + K7_TILE, L);
      float sc[4][4];
      int raw[4][4];
      // pass 1: the tile's row max
      float tm_lo = -INFINITY, tm_hi = -INFINITY;
      for (int j0 = c0; j0 < c1; j0 += 32) {
        score_block_int8<DH>(sc, raw, qa, ks, j0, L, deq_lo, deq_hi, g, t);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          tm_lo = fmaxf(tm_lo, fmaxf(sc[nb][0], sc[nb][1]));
          tm_hi = fmaxf(tm_hi, fmaxf(sc[nb][2], sc[nb][3]));
        }
      }
      tm_lo = quad_max(tm_lo);
      tm_hi = quad_max(tm_hi);
      // pass 2: int8 probabilities and the s32 P [v | 1]
      int part[DH / 8][4] = {};
      int psum_lo = 0, psum_hi = 0;
      for (int j0 = c0; j0 < c1; j0 += 32) {
        score_block_int8<DH>(sc, raw, qa, ks, j0, L, deq_lo, deq_hi, g, t);
        int p[4][4];
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            p[nb][i] = __float2int_rn(
                __fmul_rn(exp2f(__fsub_rn(sc[nb][i], i < 2 ? tm_lo : tm_hi)), 127.f));
            if (i < 2)
              psum_lo += p[nb][i];
            else
              psum_hi += p[nb][i];
          }
        // A fragment: [row g | g+8][k' = 4t.. | 16 + 4t..] = keys 2t, 2t+1, 8+2t, 9+2t
        // of the first / second 16
        uint32_t pa[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int nb = (a >> 1) * 2, i = (a & 1) * 2;
          pa[a] = (uint32_t)p[nb][i] | ((uint32_t)p[nb][i + 1] << 8) |
                  ((uint32_t)p[nb + 1][i] << 16) | ((uint32_t)p[nb + 1][i + 1] << 24);
        }
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
          const int8_t* vrow = vt + (nd * 8 + g) * vld + j0 + 4 * t;
          mma_s8_16832(part[nd], pa, *reinterpret_cast<const uint32_t*>(vrow),
                       *reinterpret_cast<const uint32_t*>(vrow + 16));
        }
        if constexpr (DUMP) {
          const long long head = (long long)b * H + h;
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i < 2 ? r_lo : r_hi, key = j0 + nb * 8 + 2 * t + (i & 1);
              if (r < L && key < L) {
                s_dump[(head * L + r) * L + key] = raw[nb][i];
                p_dump[(head * L + r) * L + key] = static_cast<int8_t>(p[nb][i]);
              }
            }
        }
      }
      const int den_int_lo = one * quad_sum_int(psum_lo), den_int_hi = one * quad_sum_int(psum_hi);
      if constexpr (DUMP) {
        int* pv = pv_dump + (((long long)b * H + h) * n_tiles + tile) * L * (DH + 1);
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i < 2 ? r_lo : r_hi;
            if (r < L) pv[r * (DH + 1) + nd * 8 + 2 * t + (i & 1)] = part[nd][i];
          }
        if (t == 0) {
          if (r_lo < L) pv[r_lo * (DH + 1) + DH] = den_int_lo;
          if (r_hi < L) pv[r_hi * (DH + 1) + DH] = den_int_hi;
        }
      }
      // merge the tile onto the running max
      if (tile == 0) {
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nd][i] = static_cast<float>(part[nd][i]);
        den_lo = static_cast<float>(den_int_lo);
        den_hi = static_cast<float>(den_int_hi);
        m_lo = tm_lo;
        m_hi = tm_hi;
      } else {
        const float new_lo = fmaxf(m_lo, tm_lo), new_hi = fmaxf(m_hi, tm_hi);
        const float old_lo = exp2f(__fsub_rn(m_lo, new_lo)), cur_lo = exp2f(__fsub_rn(tm_lo, new_lo));
        const float old_hi = exp2f(__fsub_rn(m_hi, new_hi)), cur_hi = exp2f(__fsub_rn(tm_hi, new_hi));
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[nd][i] = __fadd_rn(__fmul_rn(acc[nd][i], i < 2 ? old_lo : old_hi),
                                   __fmul_rn(static_cast<float>(part[nd][i]), i < 2 ? cur_lo : cur_hi));
        den_lo = __fadd_rn(__fmul_rn(den_lo, old_lo), __fmul_rn(static_cast<float>(den_int_lo), cur_lo));
        den_hi = __fadd_rn(__fmul_rn(den_hi, old_hi), __fmul_rn(static_cast<float>(den_int_hi), cur_hi));
        m_lo = new_lo;
        m_hi = new_hi;
      }
    }

    bf16* o_base = out + (long long)b * L * D + h * DH + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      if (r_lo < L)
        *reinterpret_cast<uint32_t*>(o_base + (long long)r_lo * D + nd * 8) =
            pack_bf16x2(__fdiv_rn(acc[nd][0], den_lo), __fdiv_rn(acc[nd][1], den_lo));
      if (r_hi < L)
        *reinterpret_cast<uint32_t*>(o_base + (long long)r_hi * D + nd * 8) =
            pack_bf16x2(__fdiv_rn(acc[nd][2], den_hi), __fdiv_rn(acc[nd][3], den_hi));
    }
  }
}

// The dynamic shared memory a GEMM stage launches with: its tiles live in
// static shared memory up to 48 KB (the D <= 128 stages), else dynamically.
constexpr int dynamic_smem(int bytes) { return bytes <= STATIC_SMEM ? 0 : bytes; }

// One bf16 GEMM stage (gemm_wgmma_kernel) over the n_cols columns from
// p.col0, in BN-wide slabs: TMA maps of A [m, k] (rows lda apart) and W
// [k, ldw], and up to one block per SM, the SMs split evenly between the
// slabs.
template <int EPI, int BN, bool RESIDENT>
cudaError_t launch_gemm_wgmma(GemmArgs p, int n_cols, cudaStream_t stream) {
  p.n_tiles = n_cols / BN;
  const int ring = gemm_ring(RESIDENT, BN, p.k, 3 * BN * 4);
  if (n_cols % BN || p.k % 64 || !ring) return cudaErrorInvalidValue;
  const long long tm = RESIDENT ? 64 : 128;
  const uint64_t a_dims[2] = {(uint64_t)p.k, (uint64_t)p.m}, a_str[1] = {(uint64_t)p.lda};
  const uint64_t w_dims[2] = {(uint64_t)p.ldw, (uint64_t)p.k}, w_str[1] = {(uint64_t)p.ldw};
  const uint32_t a_box[2] = {64, (uint32_t)tm}, w_box[2] = {64, RESIDENT ? (uint32_t)p.k : 64u};
  CUtensorMap a_map, w_map;
  if (!make_map(&a_map, p.a, 2, a_dims, a_str, a_box, 128) ||
      !make_map(&w_map, p.w, 2, w_dims, w_str, w_box, 128))
    return cudaErrorInvalidValue;
  const int smem = gemm_smem_bytes(RESIDENT, BN, p.k, ring, 3 * BN * 4);
  const cudaError_t err = allow_smem(gemm_wgmma_kernel<EPI, BN, RESIDENT>, smem);
  if (err != cudaSuccess) return err;
  gemm_wgmma_kernel<EPI, BN, RESIDENT>
      <<<gw_blocks((p.m + tm - 1) / tm, p.n_tiles), GW_THREADS, smem, stream>>>(a_map, w_map, p,
                                                                                ring);
  return cudaSuccess;
}

// W resident where K <= 256, except for the 256-wide LayerNorm stage (the
// out-projection at D = 256), whose resident instance spilled beside its 128
// accumulators: it streams W as FFN2 does.
template <int EPI, int BN>
cudaError_t launch_gemm_bn(GemmArgs p, int n_cols, cudaStream_t stream) {
  if constexpr (EPI == kBiasResidualLN && BN == 256)
    return launch_gemm_wgmma<EPI, BN, false>(p, n_cols, stream);
  else
    return p.k <= 256 ? launch_gemm_wgmma<EPI, BN, true>(p, n_cols, stream)
                      : launch_gemm_wgmma<EPI, BN, false>(p, n_cols, stream);
}

// The slab width of a stage: the whole width up to 256 columns, else 256, or
// 128 where 256 does not divide it (F a multiple of 128).
int slab_width(int n_cols) { return n_cols <= 256 ? n_cols : n_cols % 256 == 0 ? 256 : 128; }

// A bf16 GEMM stage: + bias (+ ReLU where p.relu) over n_cols columns, or
// (kBiasResidualLN) + bias + residual and LayerNorm over rows of n_cols = D.
template <int EPI>
cudaError_t launch_gemm(GemmArgs p, int n_cols, cudaStream_t stream) {
  const int bn = slab_width(n_cols);
  if (EPI == kBiasResidualLN && bn != n_cols) return cudaErrorInvalidValue;
  switch (bn) {
    case 64: return launch_gemm_bn<EPI, 64>(p, n_cols, stream);
    case 128: return launch_gemm_bn<EPI, 128>(p, n_cols, stream);
    case 256: return launch_gemm_bn<EPI, 256>(p, n_cols, stream);
    case 192:
      if constexpr (EPI == kBias) return launch_gemm_bn<EPI, 192>(p, n_cols, stream);
  }
  return cudaErrorInvalidValue;
}

// K6's s8 stages: the tile width 128, or 64 where 128 does not divide the
// stage's columns (BN = D for the LayerNorm stages).
int tile_width(int n_cols) { return n_cols % 128 == 0 ? 128 : 64; }

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
cudaError_t launch_attention(const bf16* qkv, bf16* out, int B, int L, int n_q, int D, int H,
                             long long out_frame_stride, cudaStream_t stream) {
  const size_t smem = attention_smem_bytes<DH>(L);
  const cudaError_t err = allow_smem(attention_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B, (unsigned)H);
  attention_kernel<DH><<<grid, ATTN_WARPS * 32, smem, stream>>>(qkv, out, L, n_q, D,
                                                               out_frame_stride);
  return cudaSuccess;
}

// K2's attention stage: the two-pass core for query rows [0, n_q).
cudaError_t attention_cls(const bf16* qkv, bf16* out, int B, int L, int n_q, int D, int H,
                          long long out_frame_stride, cudaStream_t stream) {
  switch (D / H) {
    case 16: return launch_attention<16>(qkv, out, B, L, n_q, D, H, out_frame_stride, stream);
    case 32: return launch_attention<32>(qkv, out, B, L, n_q, D, H, out_frame_stride, stream);
    case 64: return launch_attention<64>(qkv, out, B, L, n_q, D, H, out_frame_stride, stream);
  }
  return cudaErrorInvalidValue;
}

template <int DH, bool NOEXP>
cudaError_t launch_core(const bf16* qkv, bf16* out, int B, int L, int D, int H,
                        long long out_frame_stride, cudaStream_t stream) {
  const size_t smem = core_smem_bytes(L, DH);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  const uint64_t dims[3] = {(uint64_t)3 * D, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)3 * D, (uint64_t)3 * D * L};
  const uint32_t box[3] = {DH, CORE_KT, 1};
  CUtensorMap map;
  if (!make_map(&map, qkv, 3, dims, strides, box, DH * 2)) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(attention_core_kernel<DH, NOEXP>, smem);
  if (err != cudaSuccess) return err;
  // One warpgroup a block, or two where that keeps more warpgroups on an SM
  // (long L, where the frame-head's k and v bound the blocks by shared
  // memory): a block of two whose query tiles do not split evenly holds an
  // idle warpgroup's registers while the other finishes. The choice depends
  // on the tile count alone (it sets the shared memory), so the occupancy
  // queries run once per count; 0 = not yet asked.
  const int n_qt = (L + CORE_KT - 1) / CORE_KT;
  static int n_wg_of_tiles[MAX_SMEM / (CORE_KT * 16 * 4) + 1] = {};
  int& n_wg = n_wg_of_tiles[n_qt];
  if (!n_wg) {
    int one = 0, two = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&one, attention_core_kernel<DH, NOEXP>, 128,
                                                  smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&two, attention_core_kernel<DH, NOEXP>, 2 * 128,
                                                  smem);
    n_wg = n_qt >= CORE_WG && CORE_WG * two > one ? CORE_WG : 1;
  }
  attention_core_kernel<DH, NOEXP><<<dim3((unsigned)B, (unsigned)H), 128 * n_wg, smem, stream>>>(
      map, qkv, out, L, D, out_frame_stride);
  return cudaSuccess;
}

// The full layers' attention stage (K1, K6, and P3 with NOEXP): the one-pass
// wgmma core over every query row, out rows D apart, frames
// out_frame_stride apart.
template <bool NOEXP>
cudaError_t attention_core(const bf16* qkv, bf16* out, int B, int L, int D, int H,
                           long long out_frame_stride, cudaStream_t stream) {
  switch (D / H) {
    case 16: return launch_core<16, NOEXP>(qkv, out, B, L, D, H, out_frame_stride, stream);
    case 32: return launch_core<32, NOEXP>(qkv, out, B, L, D, H, out_frame_stride, stream);
    case 64: return launch_core<64, NOEXP>(qkv, out, B, L, D, H, out_frame_stride, stream);
  }
  return cudaErrorInvalidValue;
}

size_t attention_smem(int dh, int L) {
  switch (dh) {
    case 16: return attention_smem_bytes<16>(L);
    case 32: return attention_smem_bytes<32>(L);
    case 64: return attention_smem_bytes<64>(L);
  }
  return ~size_t(0);
}

template <int DH, bool DUMP>
cudaError_t launch_attention_int8(const bf16* qkv, bf16* out, int B, int L, int D, int H,
                                  int* s_dump, int8_t* p_dump, int* pv_dump,
                                  cudaStream_t stream) {
  const size_t smem = attention_int8_smem_bytes<DH>(L);
  const cudaError_t err = allow_smem(attention_int8_kernel<DH, DUMP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B, (unsigned)H);
  attention_int8_kernel<DH, DUMP><<<grid, ATTN_WARPS * 32, smem, stream>>>(
      qkv, out, L, D, s_dump, p_dump, pv_dump);
  return cudaSuccess;
}

// K7's attention core (attention_int8_kernel); with the dump pointers set,
// the variant that also writes its s32 scores, int8 probabilities and s32
// tile products.
cudaError_t attention_int8(const bf16* qkv, bf16* out, int B, int L, int D, int H,
                           int* s_dump, int8_t* p_dump, int* pv_dump, cudaStream_t stream) {
  const bool dump = s_dump != nullptr;
  switch (D / H) {
    case 16:
      return dump ? launch_attention_int8<16, true>(qkv, out, B, L, D, H, s_dump, p_dump, pv_dump, stream)
                  : launch_attention_int8<16, false>(qkv, out, B, L, D, H, nullptr, nullptr, nullptr, stream);
    case 32:
      return dump ? launch_attention_int8<32, true>(qkv, out, B, L, D, H, s_dump, p_dump, pv_dump, stream)
                  : launch_attention_int8<32, false>(qkv, out, B, L, D, H, nullptr, nullptr, nullptr, stream);
    case 64:
      return dump ? launch_attention_int8<64, true>(qkv, out, B, L, D, H, s_dump, p_dump, pv_dump, stream)
                  : launch_attention_int8<64, false>(qkv, out, B, L, D, H, nullptr, nullptr, nullptr, stream);
  }
  return cudaErrorInvalidValue;
}

// The shapes K1, K2 and K6 take (fused_encoder_layer.fused_infer_supported
// is the same predicate): D 64, 128 or 256; d_head 16, 32 or 64; an FFN width
// that is a multiple of 128; and an L whose frame-head K/V fit the
// attention block's shared memory.
bool shapes_ok(int B, int L, int D, int H, int F) {
  if (B <= 0 || L <= 0 || H <= 0 || D % H) return false;
  if (D != 64 && D != 128 && D != 256) return false;
  const int dh = D / H;
  if (dh != 16 && dh != 32 && dh != 64) return false;
  return F > 0 && F % 128 == 0 && attention_smem(dh, L) <= (size_t)MAX_SMEM;
}

// Returns from the enclosing entry with a launch's error (`err` in scope).
#define VITIQ_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err

// The attention core of a layer: K1's (exp2 softmax), P3's (K1's without the
// exp) or K7's (int8).
enum class Core { kExp2, kNoExp, kInt8 };

// One layer, for every query row (K1, P3 with Core::kNoExp, K7 with
// Core::kInt8) or for row 0 of each frame only (K2, Core::kExp2). x:
// [B, L, D]; out: [B, L, D] (K1, P3, K7) or
// [B, 1, D] (K2). Scratch: qkv [B, L, 3D]; attn and x1 [R, D] and hid [R, F]
// for the R output rows (B*L or B). Weights: wqkv [D, 3D] with its q columns
// pre-scaled by log2(e)/sqrt(dh), wo [D, D], w1 [D, F], w2 [F, D] in bf16;
// biases and LN parameters f32. Returns the first launch error or
// cudaGetLastError().
int encoder_layer(bool cls_only, Core core, const void* x, void* out, void* qkv,
                  void* attn, void* x1, void* hid, const void* wqkv, const void* bqkv,
                  const void* wo, const void* bo, const void* g1, const void* be1,
                  const void* w1, const void* b1, const void* w2, const void* b2,
                  const void* g2, const void* be2, int B, int L, int D, int H, int F,
                  void* stream_ptr) {
  if ((core != Core::kExp2 && cls_only) || !shapes_ok(B, L, D, H, F))
    return (int)cudaErrorInvalidValue;
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
  cudaError_t err;
  if (cls_only) {
    // q for row 0 of each frame (A rows stride a whole frame), into qkv row 0
    VITIQ_TRY(launch_gemm<kBias>(
        gemm_args(xb, frame, w_qkv, 3 * D, b_qkv, qkvb, 3 * frame, B, D, 0), D, s));
    // k and v for every row: columns [D, 3D)
    VITIQ_TRY(launch_gemm<kBias>(gemm_args(xb, D, w_qkv, 3 * D, b_qkv, qkvb, 3 * D, M, D, D),
                                 2 * D, s));
  } else {
    VITIQ_TRY(launch_gemm<kBias>(gemm_args(xb, D, w_qkv, 3 * D, b_qkv, qkvb, 3 * D, M, D, 0),
                                 3 * D, s));
  }
  if (core == Core::kInt8) {
    VITIQ_TRY(attention_int8(qkvb, attnb, B, L, D, H, nullptr, nullptr, nullptr, s));
  } else if (core == Core::kNoExp) {
    VITIQ_TRY(attention_core<true>(qkvb, attnb, B, L, D, H, frame, s));
  } else if (cls_only) {
    VITIQ_TRY(attention_cls(qkvb, attnb, B, L, 1, D, H, D, s));
  } else {
    VITIQ_TRY(attention_core<false>(qkvb, attnb, B, L, D, H, frame, s));
  }
  VITIQ_TRY(launch_gemm<kBiasResidualLN>(
      with_ln(gemm_args(attnb, D, static_cast<const bf16*>(wo), D,
                        static_cast<const float*>(bo), x1b, D, rows, D, 0),
              xb, x_ld, static_cast<const float*>(g1), static_cast<const float*>(be1)),
      D, s));
  GemmArgs ffn1 = gemm_args(x1b, D, static_cast<const bf16*>(w1), F,
                            static_cast<const float*>(b1), hidb, F, rows, D, 0);
  ffn1.relu = 1;
  VITIQ_TRY(launch_gemm<kBias>(ffn1, F, s));
  VITIQ_TRY(launch_gemm<kBiasResidualLN>(
      with_ln(gemm_args(hidb, F, static_cast<const bf16*>(w2), D,
                        static_cast<const float*>(b2), static_cast<bf16*>(out), D, rows, F, 0),
              x1b, D, static_cast<const float*>(g2), static_cast<const float*>(be2)),
      D, s));
  return (int)cudaGetLastError();
}

template <int EPI, bool PREQ, int BN>
cudaError_t launch_gemm_int8_bn(GemmArgs p, const void* aq, const void* ascale, const void* wq,
                                const void* wscale, int n_cols, cudaStream_t stream) {
  p.n_tiles = n_cols / BN;
  const long long blocks = (p.m + BM - 1) / BM * p.n_tiles;
  constexpr int smem = dynamic_smem(qgemm_smem<BN>());
  const cudaError_t err = allow_smem(gemm_int8_kernel<EPI, PREQ, BN>, smem);
  if (err != cudaSuccess) return err;
  gemm_int8_kernel<EPI, PREQ, BN><<<(unsigned)blocks, GEMM_THREADS, smem, stream>>>(
      p, static_cast<const int8_t*>(aq), static_cast<const float*>(ascale),
      static_cast<const int8_t*>(wq), static_cast<const float*>(wscale));
  return cudaSuccess;
}

template <int EPI, bool PREQ>
cudaError_t launch_gemm_int8(GemmArgs p, const void* aq, const void* ascale, const void* wq,
                             const void* wscale, int n_cols, int bn, cudaStream_t stream) {
  switch (bn) {
    case 64:
      return launch_gemm_int8_bn<EPI, PREQ, 64>(p, aq, ascale, wq, wscale, n_cols, stream);
    case 128:
      return launch_gemm_int8_bn<EPI, PREQ, 128>(p, aq, ascale, wq, wscale, n_cols, stream);
    case 256:
      return launch_gemm_int8_bn<EPI, PREQ, 256>(p, aq, ascale, wq, wscale, n_cols, stream);
  }
  return cudaErrorInvalidValue;
}

void launch_rowquant(const void* a, void* aq, void* ascale, long long m, int k,
                     cudaStream_t stream) {
  rowquant_kernel<<<(unsigned)((m + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(a), static_cast<int8_t*>(aq), static_cast<float*>(ascale), m, k);
}

// K6: one full W8A8 layer. x, out: [B, L, D] bf16. Scratch: qkv [B, L, 3D],
// attn and x1 [B, L, D], hid [B, L, F], bf16; aq [B, L, D] int8 and ascale
// [B, L] f32 (the quantized QKV input, then the quantized FFN1 input).
// Weights int8 in nn.Linear's [out, in] layout: wqkv [3D, D] (q, k, v rows),
// wo [D, D], w1 [F, D], w2 [D, F]; per-output-channel scales sqkv [3D],
// so [D], s1 [F], s2 [D] and biases f32, the q section of sqkv and bqkv
// multiplied by log2(e)/sqrt(dh); LN parameters f32. Returns the first
// launch error or cudaGetLastError().
//   rowquant(x) -> aq; QKV (PREQ) -> qkv; attention -> attn;
//   out-projection (A quantized in-kernel) + LN1 -> x1, and x1 quantized -> aq;
//   FFN1 (PREQ) + ReLU -> hid; FFN2 (A quantized in-kernel) + LN2 -> out.
int encoder_layer_int8(const void* x, void* out, void* qkv, void* attn, void* x1, void* hid,
                       void* aq, void* ascale, const void* wqkv, const void* sqkv,
                       const void* bqkv, const void* wo, const void* so, const void* bo,
                       const void* g1, const void* be1, const void* w1, const void* s1,
                       const void* b1, const void* w2, const void* s2, const void* b2,
                       const void* g2, const void* be2, int B, int L, int D, int H, int F,
                       void* stream_ptr) {
  if (!shapes_ok(B, L, D, H, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* attnb = static_cast<bf16*>(attn);
  bf16* x1b = static_cast<bf16*>(x1);
  bf16* hidb = static_cast<bf16*>(hid);
  auto f32 = [](const void* v) { return static_cast<const float*>(v); };
  const long long M = (long long)B * L;
  cudaError_t err;

  launch_rowquant(x, aq, ascale, M, D, s);
  VITIQ_TRY((launch_gemm_int8<kBias, true>(
      gemm_args(xb, D, nullptr, 0, f32(bqkv), qkvb, 3 * D, M, D, 0), aq, ascale, wqkv, sqkv,
      3 * D, tile_width(3 * D), s)));
  VITIQ_TRY(attention_core<false>(qkvb, attnb, B, L, D, H, (long long)L * D, s));
  GemmArgs proj = with_ln(gemm_args(attnb, D, nullptr, 0, f32(bo), x1b, D, M, D, 0), xb, D,
                          f32(g1), f32(be1));
  proj.cq = static_cast<int8_t*>(aq);
  proj.cscale = static_cast<float*>(ascale);
  VITIQ_TRY((launch_gemm_int8<kBiasResidualLNQuant, false>(proj, nullptr, nullptr, wo, so, D,
                                                           D, s)));
  VITIQ_TRY((launch_gemm_int8<kBiasRelu, true>(
      gemm_args(x1b, D, nullptr, 0, f32(b1), hidb, F, M, D, 0), aq, ascale, w1, s1, F,
      tile_width(F), s)));
  VITIQ_TRY((launch_gemm_int8<kBiasResidualLN, false>(
      with_ln(gemm_args(hidb, F, nullptr, 0, f32(b2), static_cast<bf16*>(out), D, M, F, 0), x1b,
              D, f32(g2), f32(be2)),
      nullptr, nullptr, w2, s2, D, D, s)));
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
  return encoder_layer(false, Core::kExp2, x, out, qkv, attn, x1, hid, wqkv, bqkv, wo, bo, g1, be1,
                       w1, b1, w2, b2, g2, be2, B, L, D, H, F, stream_ptr);
}

// K2: the layer for query row 0 only (see encoder_layer).
extern "C" int vitiq_encoder_layer_cls(
    const void* x, void* out, void* qkv, void* attn, void* x1, void* hid,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* g1, const void* be1, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* g2, const void* be2,
    int B, int L, int D, int H, int F, void* stream_ptr) {
  return encoder_layer(true, Core::kExp2, x, out, qkv, attn, x1, hid, wqkv, bqkv, wo, bo, g1, be1,
                       w1, b1, w2, b2, g2, be2, B, L, D, H, F, stream_ptr);
}

// K7: one full layer with the int8 attention core (see encoder_layer and
// attention_int8_kernel).
extern "C" int vitiq_encoder_layer_attn_int8_full(
    const void* x, void* out, void* qkv, void* attn, void* x1, void* hid,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* g1, const void* be1, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* g2, const void* be2,
    int B, int L, int D, int H, int F, void* stream_ptr) {
  return encoder_layer(false, Core::kInt8, x, out, qkv, attn, x1, hid, wqkv, bqkv, wo, bo, g1, be1,
                       w1, b1, w2, b2, g2, be2, B, L, D, H, F, stream_ptr);
}

// P3: K1's full layer with its softmax exp removed (attention_core_kernel<DH,
// true>; see encoder_layer). A timing probe, not a layer of the model.
extern "C" int vitiq_encoder_layer_full_noexp(
    const void* x, void* out, void* qkv, void* attn, void* x1, void* hid,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* g1, const void* be1, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* g2, const void* be2,
    int B, int L, int D, int H, int F, void* stream_ptr) {
  return encoder_layer(false, Core::kNoExp, x, out, qkv, attn, x1, hid, wqkv, bqkv, wo, bo, g1,
                       be1, w1, b1, w2, b2, g2, be2, B, L, D, H, F, stream_ptr);
}

// P3's attention core alone (attention_core_kernel<DH, true>) on
// qkv [B, L, 3D] bf16 -> out [B, L, D] bf16, to hold it to its plain version on the same
// qkv. Takes K1's shapes (F is not read).
extern "C" int vitiq_attention_noexp(const void* qkv, void* out, int B, int L, int D, int H,
                                     void* stream_ptr) {
  if (!shapes_ok(B, L, D, H, 128)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = attention_core<true>(static_cast<const bf16*>(qkv),
                                               static_cast<bf16*>(out), B, L, D, H,
                                               (long long)L * D,
                                               static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K7's attention core alone on qkv [B, L, 3D] bf16 -> out [B, L, D] bf16;
// with s_dump non-null, also its s32 scores s_dump [B, H, L, L], int8
// probabilities p_dump [B, H, L, L] and s32 tile products pv_dump
// [B, H, ceil(L / 128), L, D / H + 1] (for the bit-for-bit check of its
// products against the plain version). Takes K7's shapes (F is not read).
extern "C" int vitiq_attention_int8(const void* qkv, void* out, void* s_dump, void* p_dump,
                                    void* pv_dump, int B, int L, int D, int H,
                                    void* stream_ptr) {
  if (!shapes_ok(B, L, D, H, 128)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = attention_int8(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), B, L, D, H,
      static_cast<int*>(s_dump), static_cast<int8_t*>(p_dump), static_cast<int*>(pv_dump),
      static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K6: one full W8A8 layer (see encoder_layer_int8).
extern "C" int vitiq_encoder_layer_int8_full(
    const void* x, void* out, void* qkv, void* attn, void* x1, void* hid, void* aq,
    void* ascale, const void* wqkv, const void* sqkv, const void* bqkv, const void* wo,
    const void* so, const void* bo, const void* g1, const void* be1, const void* w1,
    const void* s1, const void* b1, const void* w2, const void* s2, const void* b2,
    const void* g2, const void* be2, int B, int L, int D, int H, int F, void* stream_ptr) {
  return encoder_layer_int8(x, out, qkv, attn, x1, hid, aq, ascale, wqkv, sqkv, bqkv, wo, so,
                            bo, g1, be1, w1, s1, b1, w2, s2, b2, g2, be2, B, L, D, H, F,
                            stream_ptr);
}

// One of K6's GEMM stages alone, c [M, N] bf16 = epilogue(int8_gemm(a)) with
// the bias (relu = 0) or the bias + ReLU (relu = 1) epilogue; a [M, K] bf16,
// wq [N, K] int8, wscale and bias [N] f32. With prequant = 1, a is quantized
// first by rowquant_kernel into the scratch aq [M, K] int8 and ascale [M]
// (K <= 1024), as the QKV and FFN1 stages take it, on the tiles those
// stages take (128 wide where 128 divides N, else 64); else in the GEMM's
// prologue and k loop, on one N-wide tile where N is 64, 128 or 256, as the
// out-projection and FFN2 stages take it (N = D). K % 64 == 0, N % 64 == 0.
extern "C" int vitiq_gemm_int8(const void* a, const void* wq, const void* wscale,
                               const void* bias, void* c, void* aq, void* ascale, int M, int K,
                               int N, int relu, int prequant, void* stream_ptr) {
  if (M <= 0 || K <= 0 || K % QBK || N <= 0 || N % 64 || (prequant && K > MAX_QUANT_K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const GemmArgs p = gemm_args(static_cast<const bf16*>(a), K, nullptr, 0,
                               static_cast<const float*>(bias), static_cast<bf16*>(c), N, M, K,
                               0);
  const int bn = !prequant && (N == 64 || N == 128 || N == 256) ? N : tile_width(N);
  cudaError_t err;
  if (prequant) {
    launch_rowquant(a, aq, ascale, M, K, s);
    if (relu)
      err = launch_gemm_int8<kBiasRelu, true>(p, aq, ascale, wq, wscale, N, bn, s);
    else
      err = launch_gemm_int8<kBias, true>(p, aq, ascale, wq, wscale, N, bn, s);
  } else if (relu) {
    err = launch_gemm_int8<kBiasRelu, false>(p, nullptr, nullptr, wq, wscale, N, bn, s);
  } else {
    err = launch_gemm_int8<kBias, false>(p, nullptr, nullptr, wq, wscale, N, bn, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One of K1's bf16 GEMM stages alone (gemm_wgmma_kernel): c [M, N] bf16 =
// a [M, K] @ w [K, N] + bias, then ReLU (epi = 1), or (epi = 2, N = 64, 128
// or 256) + res [M, N] and LayerNorm with gamma, beta; bias, gamma, beta f32.
// K % 64 == 0; W stays resident for K <= 256 and streams above.
extern "C" int vitiq_gemm_bf16(const void* a, const void* w, const void* bias, const void* res,
                               const void* gamma, const void* beta, void* c, int M, int K, int N,
                               int epi, void* stream_ptr) {
  if (M <= 0 || K <= 0 || K % 64 || N <= 0 || N % 64 || epi < 0 || epi > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  GemmArgs p = gemm_args(static_cast<const bf16*>(a), K, static_cast<const bf16*>(w), N,
                         static_cast<const float*>(bias), static_cast<bf16*>(c), N, M, K, 0);
  cudaError_t err;
  if (epi == 2) {
    err = launch_gemm<kBiasResidualLN>(
        with_ln(p, static_cast<const bf16*>(res), N, static_cast<const float*>(gamma),
                static_cast<const float*>(beta)),
        N, s);
  } else {
    p.relu = epi;
    err = launch_gemm<kBias>(p, N, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K1's attention core alone (attention_core_kernel) on qkv [B, L, 3D] bf16
// -> out [B, L, D] bf16, to hold it to its plain version on the same qkv.
// Takes K1's shapes (F is not read).
extern "C" int vitiq_attention_core(const void* qkv, void* out, int B, int L, int D, int H,
                                    void* stream_ptr) {
  if (!shapes_ok(B, L, D, H, 128)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = attention_core<false>(static_cast<const bf16*>(qkv),
                                                static_cast<bf16*>(out), B, L, D, H,
                                                (long long)L * D,
                                                static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
