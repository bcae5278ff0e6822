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
// W8A8, the attention stage K1's one-pass core (attention_core_kernel):
//   int8_gemm(t) = (f32(rowquant(t) @ Wq^T) * s_row) * s_col + b, with
//   s_row = max(max |t_row|, 1e-8) / 127 over the whole bf16 row and
//   rowquant(t) = clip(rint(t / s_row), -127, 127), s32 accumulation;
//   qkv = bf16(int8_gemm(x)); attn as K1; x1 = bf16(LN(int8_gemm(attn) + x));
//   h = bf16(relu(int8_gemm(x1))); y = bf16(LN(int8_gemm(h) + x1)).
// Its four stages (gemm_s8_kernel) run K1's persistent main loop
// (gemm_wgmma.cuh) on Hopper's s8 warpgroup MMA, wgmma m64nNk32 s32.s8.s8,
// s32 accumulators in registers, the int8 W [N, K] (nn.Linear's layout) a
// K-major B fed by TMA: resident where K = D <= 256 (QKV, out-projection,
// FFN1: the warpgroups in ping-pong, each on its own ring of A tiles),
// streamed in 128-deep steps for FFN2. The epilogues work in registers:
// dequant with each product rounded as the plain version's, then bias,
// ReLU, or residual + LayerNorm (each row of an m64 tile lies in one quad),
// bf16 stored 16 bytes a thread. A stage equals its plain version bit for
// bit: the same f32 row scales, the same levels (IEEE quotients without a
// divide, gemm_wgmma.cuh: quant_div), exact s32 sums, the same f32 dequant.
// Each operand is quantized where whole rows already are (bytes at the ViT
// shape, B = 4096: M = 528,384 rows, D = 128, F = 512):
//   x -> QKV     a row-quantization pass (rowquant_kernel: x read, 135.3 MB;
//                levels and scales written, 69.7 MB) for a stack's first
//                layer; the previous layer's FFN2 epilogue writes the next
//                one's levels and scales (69.7 MB), so QKV reads 69.7 MB of
//                levels, not 135.3 MB of bf16, and the stack quantizes once;
//   x1 -> FFN1   the out-projection's LN epilogue (BN = D: whole rows)
//                writes x1's levels and scales beside x1 (69.7 MB);
//   attn -> out-projection   quantized in registers (MmaS8QuantA): the
//                stage's resident A tile [64, D] holds whole bf16 rows, so
//                their absmax comes from shared memory (no bytes beyond the
//                tile) and each warp's fragments are quantized from it into
//                the register-A operand of the wgmma;
//   hid -> FFN2  FFN1's epilogue takes each row's max over its slab (ReLU:
//                the values are >= 0) and merges the slabs with atomicMax on
//                the f32 bits into a [M] scratch (2.1 MB; the out-projection
//                zeroes it), which FFN2 reads (2.1 MB) to quantize its
//                streamed bf16 tiles in registers: no pass over hid (541.1
//                MB) for its scales.
// Bound at the ViT shape: ~208 G int8 operations a layer (0.105 ms at 1979
// TOP/s) and the attention core's bf16 FLOPs (0.035 ms at 989 TFLOP/s)
// against ~3 GB of activation traffic between the stages (qkv, attn, x1 and
// hid each written and read, hid alone 1.08 GB; ~0.9 ms at 3.35 TB/s): the
// intermediates' round trips through device memory bound it, as K1's.
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

constexpr int ATTN_WARPS = 4;
constexpr int MAX_SMEM = 232448;  // shared memory a block may use on Hopper
constexpr float LN_EPS = 1e-12f;

enum Epilogue { kBias = 0, kBiasResidualLN = 2 };

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
  // the kBias epilogue: then ReLU. A runtime flag: FFN1 then shares the QKV
  // stage's instances instead of adding one wgmma instance per slab width
  // and W layout to every build, for one warp-uniform branch a tile.
  int relu;
};

// 8 bf16 (one 16-byte chunk) -> 8 int8 levels (one 8-byte chunk) with the
// row's scale s and y = RN(1 / s)
__device__ __forceinline__ uint2 quantize8(const uint4& chunk, float s, float y) {
  return make_uint2(quant4(make_uint2(chunk.x, chunk.y), s, y),
                    quant4(make_uint2(chunk.z, chunk.w), s, y));
}

__device__ __forceinline__ float absmax8(const uint4& chunk, float amax) {
  const bf16* e = reinterpret_cast<const bf16*>(&chunk);
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
  return amax;
}

// ---- K6: the row-quantization pass and the s8 GEMM stages -----------------
constexpr int MAX_QUANT_K = 1024;  // rowquant_kernel: 4 chunks of 8 per lane

// Row quantization of a bf16 [m, k] (k % 64 == 0, k <= MAX_QUANT_K), each
// row read once into registers by a group of G = k / 8 lanes (8, 16 or 32)
// up to k = 256, each lane one 16-byte chunk of four rows (four loads in
// flight a lane), else by 32 lanes, four chunks a lane: with LEVELS, q[r,
// :] = rowquant(a[r, :]) and s[r] its scale (the first layer's QKV input);
// else s[r] = the row's absmax, whose f32 bits an s8 stage that quantizes in
// registers reads (vitiq_gemm_int8 at K > 256).
__host__ __device__ inline int rowquant_group(int k) { return k >= 256 ? 32 : k >= 128 ? 16 : 8; }
__host__ __device__ inline int rowquant_rows(int k) {  // rows a block
  return 256 / rowquant_group(k) * (k <= 256 ? 4 : 1);
}

template <bool LEVELS>
__global__ void __launch_bounds__(256) rowquant_kernel(const bf16* __restrict__ a,
                                                      int8_t* __restrict__ q,
                                                      float* __restrict__ s, long long m, int k) {
  const int G = rowquant_group(k), groups = 256 / G, sub = threadIdx.x % G;
  const bool four_rows = k <= 256;
  const long long r0 = (long long)blockIdx.x * rowquant_rows(k) + threadIdx.x / G;
  uint4 chunks[4];
  float amax[4];
  long long rows[4];
  int cols[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    rows[j] = four_rows ? r0 + j * groups : r0;
    cols[j] = (four_rows ? sub : sub + 32 * j) * 8;
    chunks[j] = rows[j] < m && cols[j] < k
                    ? *reinterpret_cast<const uint4*>(a + rows[j] * k + cols[j])
                    : make_uint4(0u, 0u, 0u, 0u);
    amax[j] = absmax8(chunks[j], 0.f);
  }
  if (!four_rows) amax[0] = amax[1] = amax[2] = amax[3] =
      fmaxf(fmaxf(amax[0], amax[1]), fmaxf(amax[2], amax[3]));
  for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) amax[j] = fmaxf(amax[j], __shfl_xor_sync(0xffffffffu, amax[j], o));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long r = rows[j];
    const bool owner = sub == 0 && (four_rows || j == 0);  // writes the row's scale
    if (r >= m) continue;
    if constexpr (!LEVELS) {
      if (owner) s[r] = amax[j];
    } else {
      const float sc = row_scale_of(amax[j]), y = rcp_rn(sc);
      if (cols[j] < k) *reinterpret_cast<uint2*>(q + r * k + cols[j]) = quantize8(chunks[j], sc, y);
      if (owner) s[r] = sc;
    }
  }
}

// One of K6's s8 GEMM stages: C[:, n0 .. n0 + BN) = epilogue((f32(A_q Wq^T)
// * s_row) * s_col + bias) on gemm_wgmma.cuh's persistent main loop, W int8
// [N, K] (nn.Linear's layout: a K-major B), resident where K <= 256, else
// streamed in 128-deep steps. A arrives
//   MmaS8        as int8 levels [m, K] (TMA) with their row scales `ascale`:
//                the QKV input (rowquant_kernel, or the previous layer's
//                FFN2 epilogue) and FFN1's (the out-projection's epilogue);
//   MmaS8QuantA  as bf16 rows (TMA), quantized in registers into wgmma's
//                register-A fragments: resident, with the scales of the whole
//                rows in the tile (the out-projection: attn); streamed, with
//                those of `amax_in`, the rows' absmax (FFN2: hid, whose max
//                FFN1's epilogue merged).
// Epilogue in registers (each row of a warpgroup's m64 tile lies in one
// quad): dequant with each product rounded as the plain version's, then
//   + ReLU (relu), with row_max (MmaS8: FFN1): each row's max over the
//     slab, bf16-rounded, merged into row_max by atomicMax on its f32 bits
//     (non-negative floats order as unsigned integers: the max is exact and
//     order-free);
//   ln (MmaS8QuantA, BN = N = D): + residual, LayerNorm (two quad shuffles a
//     statistic), with cq: the bf16-rounded rows' levels and scales (their
//     absmax by quad shuffles), with clear: those rows of `clear` zeroed;
// then bf16, 16 bytes a thread.
struct S8Args {
  const float* ascale;      // MmaS8: A's row scales [m]
  const uint32_t* amax_in;  // MmaS8QuantA, streamed: the rows' absmax, f32 bits [m]
  const float* wscale;      // [N]
  const float* bias;        // [N]
  bf16* c;                  // C row r, column n at c + r * ldc + n
  long long ldc;
  const bf16* res;          // ln: residual rows, row r at res + r * ldr
  long long ldr;
  const float* gamma;
  const float* beta;
  int8_t* cq;               // ln: the output rows' levels [m, N] and scales [m],
  float* cscale;            //   or null
  uint32_t* row_max;        // relu: the rows' max (f32 bits) merged here, or null
  uint32_t* clear;          // ln: its rows zeroed (the next FFN1's row_max), or null
  long long m;              // rows
  int k;                    // depth (multiple of 64; of 128 above 256)
  int col0;                 // first column of W / C this launch computes
  int n_tiles;              // BN-wide column slabs this launch computes
  int relu, ln;
};

// Shared memory past the ring: bias, column scales, gamma, beta [4][BN]
__host__ __device__ constexpr int s8_extra(int bn) { return 16 * bn; }

// s32 -> f32, exact either way: the magic-number add where |v| < 2^22 (the
// resident stages: K <= 256, |v| <= 127 * 127 * 256), which stays on the FMA
// and integer pipes, else a conversion (16 a clock per SM)
template <bool SMALL>
__device__ __forceinline__ float s32_to_f32(int v) {
  if constexpr (SMALL)
    return __fsub_rn(__int_as_float(v + 0x4B400000), 12582912.0f);
  else
    return static_cast<float>(v);
}

// The levels of a warpgroup's 64 x BN tile (the low byte of lev(e) for
// accumulator e) stored as int8 rows ldq apart: per 64 columns each quad
// packs its bytes and transposes its words so that every thread stores 16
// contiguous bytes of one row; rows >= m are not stored.
template <int BN, class Lev>
__device__ __forceinline__ void store_levels(Lev lev, int8_t* q, long long ldq,
                                             const long long rows[2], long long m, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) {
      uint32_t w[4];  // word i: this thread's bytes of the 8-column blocks 8j + 2i, 8j + 2i + 1
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e0 = 4 * (8 * j + 2 * i) + 2 * hh, e1 = e0 + 4;
        w[i] = __byte_perm(__byte_perm(lev(e0), lev(e0 + 1), 0x0040),
                           __byte_perm(lev(e1), lev(e1 + 1), 0x0040), 0x5410);
      }
      const uint4 o = quad_transpose(w, t);
      if (rows[hh] < m)
        *reinterpret_cast<uint4*>(q + rows[hh] * ldq + 64 * j + 16 * t) =
            make_uint4(__byte_perm(o.x, o.y, 0x5410), __byte_perm(o.z, o.w, 0x5410),
                       __byte_perm(o.x, o.y, 0x7632), __byte_perm(o.z, o.w, 0x7632));
    }
  }
}

// The residual words (bf16 pairs) of a thread's accumulators, loaded when
// its tile starts so that they land during the tile's products (the ln
// epilogue up to BN = 128): word e / 2 for accumulators e, e + 1. A row past
// m reads row 0 (zeroed in the epilogue), so the loads carry no branch and
// go out together.
template <int BN>
__device__ __forceinline__ void s8_residual(uint32_t* resw, const S8Args& p, long long row0,
                                            const GwThread& th) {
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const long long row = row0 + 16 * th.warp + th.g + 8 * ((e >> 1) & 1);
    resw[e / 2] = ld_b32(p.res + (row < p.m ? row * p.ldr : 0) + (e >> 2) * 8 + 2 * th.t);
  }
}

// The 128-byte lines of a thread's two residual rows (BN bf16 each), asked
// into L2 when its tile starts (BN = 256, whose epilogue loads them), the
// quad's four threads splitting each row's lines.
template <int BN>
__device__ __forceinline__ void s8_prefetch_res(const S8Args& p, long long row0,
                                                const GwThread& th) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long row = row0 + 16 * th.warp + th.g + 8 * hh;
    if (row >= p.m) continue;
    const char* line = reinterpret_cast<const char*>(p.res + row * p.ldr);
#pragma unroll
    for (int l = th.t; l < BN * 2 / 128; l += 4)
      asm volatile("prefetch.global.L2::evict_last [%0];\n" ::"l"(line + l * 128));
  }
}

// The ln epilogue of a dequantized tile (the values' f32 bits in acc): +
// residual and LayerNorm over the whole row, as K1's; bf16 out; with p.cq
// the rows' levels and scales, with p.clear those rows of it zeroed.
template <int BN>
__device__ __forceinline__ void s8_ln_epilogue(int* acc, const S8Args& p, const long long rows[2],
                                               const float* vec, const uint32_t* resw, int t) {
  auto F = [&](int e) { return __int_as_float(acc[e]); };
  auto set = [&](int e, float v) { acc[e] = __float_as_int(v); };
  float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f}, rstd[2], amax[2] = {0.f, 0.f};
  // up to BN = 128 the residual words were loaded when the tile started
  // (s8_residual); at 256 their registers would spill beside the 128
  // accumulators, so they load here, 16 words at a time with no branch (a
  // row past m reads row 0, then zeros): one at a time behind a branch, they
  // left a 256-wide stage waiting on 64 round trips a tile.
  constexpr int GROUP = BN < 256 ? BN / 2 : 32;  // accumulators whose words load together
#pragma unroll
  for (int e0 = 0; e0 < BN / 2; e0 += GROUP) {
    uint32_t words[GROUP / 2];
#pragma unroll
    for (int i = 0; i < GROUP / 2; ++i) {
      const int e = e0 + 2 * i, hh = (e >> 1) & 1;
      words[i] = BN < 256 ? resw[e / 2]
                          : ld_b32(p.res + (rows[hh] < p.m ? rows[hh] * p.ldr : 0) +
                                   (e >> 2) * 8 + 2 * t);
    }
#pragma unroll
    for (int i = 0; i < GROUP / 2; ++i) {
      const int e = e0 + 2 * i, hh = (e >> 1) & 1;
      float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
      if (rows[hh] >= p.m) r = make_float2(0.f, 0.f);
      set(e, __fadd_rn(F(e), r.x));
      set(e + 1, __fadd_rn(F(e + 1), r.y));
      sum[hh] += F(e) + F(e + 1);
    }
    asm volatile("" ::: "memory");  // the next group's loads stay below
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) sum[hh] = quad_sum(sum[hh]) * (1.0f / BN);  // the mean
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const float d = F(e) - sum[(e >> 1) & 1];
    set(e, d);
    sq[(e >> 1) & 1] += d * d;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) rstd[hh] = rsqrtf(quad_sum(sq[hh]) * (1.0f / BN) + LN_EPS);
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const int hh = (e >> 1) & 1, c = (e >> 2) * 8 + 2 * t;
    const float2 gm = *reinterpret_cast<const float2*>(vec + 2 * BN + c);
    const float2 bt = *reinterpret_cast<const float2*>(vec + 3 * BN + c);
    // the bf16 output, kept as the value its levels are taken from
    const float y0 = __bfloat162float(__float2bfloat16(gm.x * (F(e) * rstd[hh]) + bt.x));
    const float y1 = __bfloat162float(__float2bfloat16(gm.y * (F(e + 1) * rstd[hh]) + bt.y));
    set(e, y0);
    set(e + 1, y1);
    amax[hh] = fmaxf(amax[hh], fmaxf(fabsf(y0), fabsf(y1)));
  }
  store_rows_bf16<BN>(F, p.c, p.ldc, rows, p.m, 0, t);
  if (p.cq) {
    RowQuant oq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) set_row_quant(oq, hh, quad_max(amax[hh]));
    store_levels<BN>(
        [&](int e) { return level_bits(F(e), oq.s[(e >> 1) & 1], oq.y[(e >> 1) & 1]); }, p.cq, BN,
        rows, p.m, t);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (t == 0 && rows[hh] < p.m) p.cscale[rows[hh]] = oq.s[hh];
  }
  if (p.clear) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (t == 0 && rows[hh] < p.m) p.clear[rows[hh]] = 0u;
  }
}

// The epilogue of a warpgroup's 64 x BN s32 tile: (f32(acc) * s_row) * s_col
// + bias (each product and the sum rounded, as the plain version's), then
// ln, or ReLU (relu) with the rows' max merged into row_max, and bf16 out.
template <bool QUANT_A, bool SMALL, int BN>
__device__ __forceinline__ void s8_epilogue(int* acc, const S8Args& p, long long row0, int n0,
                                            const float* vec, const RowQuant& rq,
                                            const uint32_t* resw, const GwThread& th) {
  const int t = th.t;
  const long long rows[2] = {row0 + 16 * th.warp + th.g, row0 + 16 * th.warp + th.g + 8};
  float srow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    srow[hh] = QUANT_A ? rq.s[hh] : rows[hh] < p.m ? p.ascale[rows[hh]] : 0.f;
  auto F = [&](int e) { return __int_as_float(acc[e]); };
  auto set = [&](int e, float v) { acc[e] = __float_as_int(v); };
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const int c = (e >> 2) * 8 + 2 * t;
    const float2 b = *reinterpret_cast<const float2*>(vec + c);
    const float2 sc = *reinterpret_cast<const float2*>(vec + BN + c);
    const float sr = srow[(e >> 1) & 1];
    set(e, __fadd_rn(__fmul_rn(__fmul_rn(s32_to_f32<SMALL>(acc[e]), sr), sc.x), b.x));
    set(e + 1, __fadd_rn(__fmul_rn(__fmul_rn(s32_to_f32<SMALL>(acc[e + 1]), sr), sc.y), b.y));
  }
  if constexpr (QUANT_A) {
    if (p.ln) {
      s8_ln_epilogue<BN>(acc, p, rows, vec, resw, t);
      return;
    }
  }
  if (!p.relu) {
    store_rows_bf16<BN>(F, p.c, p.ldc, rows, p.m, n0, t);
    return;
  }
  if constexpr (QUANT_A) {  // the standalone stage's ReLU: no row max there
    store_rows_bf16<BN>([&](int e) { return fmaxf(F(e), 0.f); }, p.c, p.ldc, rows, p.m, n0, t);
    return;
  }
  // ReLU on the bf16 pairs (relu(bf16(v)) = bf16(relu(v))) as a signed
  // 16-bit max with 0, and the row max as an unsigned one (bf16 >= 0 orders
  // as its bits), two integer ops a pair on the packed words
  uint32_t mx[2] = {0u, 0u};
  store_words_bf16<BN>(
      [&](int e) {
        const uint32_t w = __vmaxs2(pack_bf16x2(F(e), F(e + 1)), 0u);
        mx[(e >> 1) & 1] = __vmaxu2(mx[(e >> 1) & 1], w);
        return w;
      },
      p.c, p.ldc, rows, p.m, n0, t);
  if (p.row_max) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t w = max(mx[hh] & 0xffffu, mx[hh] >> 16) << 16;  // the bf16 max as f32 bits
      const uint32_t m = __float_as_uint(quad_max(__uint_as_float(w)));
      if (t == 0 && rows[hh] < p.m) atomicMax(p.row_max + rows[hh], m);
    }
  }
}

template <class Op, int BN, bool RESIDENT>
__global__ void __launch_bounds__(GW_THREADS, 1) gemm_s8_kernel(
    const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap w_map,
    S8Args p, int ring) {
  extern __shared__ unsigned char s8_raw[];
  const GwLayout s =
      gw_layout<BN, RESIDENT, Op::A_BYTES, Op::B_BYTES>(s8_raw, p.k, ring, s8_extra(BN));
  float* vec = reinterpret_cast<float*>(s.extra);
  const int slab = blockIdx.x % p.n_tiles, stride = gridDim.x / p.n_tiles;
  const int first = blockIdx.x / p.n_tiles;
  const int n0 = p.col0 + slab * BN;
  const long long tm = RESIDENT ? 64 : 128;
  const int n_rt = (int)((p.m + tm - 1) / tm);
  const GwThread th = gw_thread();

  for (int i = threadIdx.x; i < BN; i += GW_THREADS) {
    vec[i] = p.bias[n0 + i];
    vec[BN + i] = p.wscale[n0 + i];
    if (Op::QUANT_A && p.ln) {
      vec[2 * BN + i] = p.gamma[i];
      vec[3 * BN + i] = p.beta[i];
    }
  }
  RowQuant rq;
  constexpr bool PRELOAD = Op::QUANT_A && BN < 256;  // the ln epilogue's residual words
  uint32_t resw[PRELOAD ? BN / 4 : 1];
  gemm_wgmma_loop<BN, RESIDENT, 0, 0, false, Op>(
      a_map, w_map, s, p.k, n0, first, stride, n_rt, n_rt, ring, th,
      [&](int* acc, long long row0) {
        if constexpr (!Op::ZERO_FIRST) {  // else the first k-step starts them
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
        }
        if constexpr (PRELOAD) {
          if (p.ln) s8_residual<BN>(resw, p, row0, th);
        } else if constexpr (Op::QUANT_A) {
          if (p.ln) s8_prefetch_res<BN>(p, row0, th);
        }
        if constexpr (Op::QUANT_A && !RESIDENT) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const long long row = row0 + 16 * th.warp + th.g + 8 * hh;
            set_row_quant(rq, hh, row < p.m ? __uint_as_float(p.amax_in[row]) : 0.f);
          }
        }
      },
      [&](int* acc, long long row0, int) {
        s8_epilogue<Op::QUANT_A, RESIDENT, BN>(acc, p, row0, n0, vec, rq, resw, th);
      },
      &rq);
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

// One s8 stage instance (gemm_s8_kernel) over the n_cols columns from
// p.col0 in BN-wide slabs: TMA maps of A [m, k] (int8 levels or bf16 rows)
// and W [w_rows, k] int8, up to one block per SM, the SMs split evenly
// between the slabs.
template <class Op, int BN, bool RESIDENT>
cudaError_t launch_s8_bn(const void* a, S8Args p, const void* wq, int w_rows, int n_cols,
                         cudaStream_t stream) {
  constexpr int AB = Op::A_BYTES, BB = Op::B_BYTES;
  p.n_tiles = n_cols / BN;
  const int ring = gemm_ring(RESIDENT, BN, p.k, s8_extra(BN), AB, BB);
  if (n_cols % BN || !ring) return cudaErrorInvalidValue;
  const long long tm = RESIDENT ? 64 : 128;
  const uint64_t a_dims[2] = {(uint64_t)p.k, (uint64_t)p.m}, w_dims[2] = {(uint64_t)p.k,
                                                                        (uint64_t)w_rows};
  const uint64_t k_str[1] = {(uint64_t)p.k};
  const uint32_t a_box[2] = {128u / AB, (uint32_t)tm}, w_box[2] = {128u, (uint32_t)BN};
  CUtensorMap a_map, w_map;
  if (!make_map(&a_map, a, 2, a_dims, k_str, a_box, 128, AB) ||
      !make_map(&w_map, wq, 2, w_dims, k_str, w_box, 128, 1))
    return cudaErrorInvalidValue;
  const int smem = gemm_smem_bytes(RESIDENT, BN, p.k, ring, s8_extra(BN), AB, BB);
  const cudaError_t err = allow_smem(gemm_s8_kernel<Op, BN, RESIDENT>, smem);
  if (err != cudaSuccess) return err;
  gemm_s8_kernel<Op, BN, RESIDENT>
      <<<gw_blocks((p.m + tm - 1) / tm, p.n_tiles), GW_THREADS, smem, stream>>>(a_map, w_map, p,
                                                                                ring);
  return cudaSuccess;
}

// The slab width of an s8 stage: the whole width where it is 64, 128 or 256
// (the LN stages: BN = D), else the widest of 256, 128, 64 that divides it.
int s8_slab_width(int n_cols) {
  if (n_cols == 64 || n_cols == 128 || n_cols == 256) return n_cols;
  return n_cols % 256 == 0 ? 256 : n_cols % 128 == 0 ? 128 : 64;
}

template <class Op, bool RESIDENT>
cudaError_t launch_s8_width(const void* a, const S8Args& p, const void* wq, int n_cols,
                            cudaStream_t stream) {
  const int w_rows = p.col0 + n_cols;
  switch (s8_slab_width(n_cols)) {
    case 64: return launch_s8_bn<Op, 64, RESIDENT>(a, p, wq, w_rows, n_cols, stream);
    case 128: return launch_s8_bn<Op, 128, RESIDENT>(a, p, wq, w_rows, n_cols, stream);
    case 256: return launch_s8_bn<Op, 256, RESIDENT>(a, p, wq, w_rows, n_cols, stream);
  }
  return cudaErrorInvalidValue;
}

// One of K6's s8 stages (see gemm_s8_kernel) over n_cols columns: A as int8
// levels (quant_a false: MmaS8, p.ascale their scales) or as bf16 rows
// quantized in the stage (MmaS8QuantA; streamed, p.amax_in the rows'
// absmax); W resident where K <= 256, else streamed (K % 128 == 0).
cudaError_t launch_s8(const void* a, bool quant_a, const S8Args& p, const void* wq, int n_cols,
                      cudaStream_t stream) {
  if (p.m <= 0 || p.k <= 0 || p.k % 64 || (p.k > 256 && p.k % 128) || n_cols <= 0 ||
      n_cols % 64 || (p.ln && (!quant_a || p.relu || s8_slab_width(n_cols) != n_cols)) ||
      (quant_a && p.k > 256 && !p.amax_in) || (!quant_a && !p.ascale) ||
      (quant_a && p.row_max))
    return cudaErrorInvalidValue;
  if (quant_a)
    return p.k <= 256 ? launch_s8_width<MmaS8QuantA, true>(a, p, wq, n_cols, stream)
                      : launch_s8_width<MmaS8QuantA, false>(a, p, wq, n_cols, stream);
  return p.k <= 256 ? launch_s8_width<MmaS8, true>(a, p, wq, n_cols, stream)
                    : launch_s8_width<MmaS8, false>(a, p, wq, n_cols, stream);
}

S8Args s8_args(const void* bias, const void* wscale, void* c, long long ldc, long long m, int k) {
  S8Args p{};
  p.bias = static_cast<const float*>(bias);
  p.wscale = static_cast<const float*>(wscale);
  p.c = static_cast<bf16*>(c);
  p.ldc = ldc;
  p.m = m;
  p.k = k;
  return p;
}

S8Args with_ln(S8Args p, const void* res, long long ldr, const void* gamma, const void* beta) {
  p.ln = 1;
  p.res = static_cast<const bf16*>(res);
  p.ldr = ldr;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  return p;
}

template <bool LEVELS>
void launch_rowquant(const void* a, void* aq, void* ascale, long long m, int k,
                     cudaStream_t stream) {
  const long long rows_a_block = rowquant_rows(k);
  rowquant_kernel<LEVELS><<<(unsigned)((m + rows_a_block - 1) / rows_a_block), 256, 0, stream>>>(
      static_cast<const bf16*>(a), static_cast<int8_t*>(aq), static_cast<float*>(ascale), m, k);
}

// K6: one full W8A8 layer. x, out: [B, L, D] bf16. Scratch: qkv [B, L, 3D],
// attn and x1 [B, L, D], hid [B, L, F], bf16; aq [B, L, D] int8 and ascale
// [B, L] f32 (x's levels where the caller gives none, then x1's); hmax
// [B, L] (hid's row max, f32 bits). xq, xscale: x's levels and scales as
// row_quant gives them (the previous layer's oq, oscale), or null; oq,
// oscale: where out's levels and scales go (the next layer's xq, xscale), or
// null. Weights int8 in nn.Linear's [out, in] layout: wqkv [3D, D] (q, k, v
// rows), wo [D, D], w1 [F, D], w2 [D, F]; per-output-channel scales sqkv
// [3D], so [D], s1 [F], s2 [D] and biases f32, the q section of sqkv and
// bqkv multiplied by log2(e)/sqrt(dh); LN parameters f32. Returns the first
// launch error or cudaGetLastError().
//   [rowquant(x) -> aq]; QKV (levels) -> qkv; attention -> attn;
//   out-projection (attn quantized in registers) + LN1 -> x1, its levels ->
//   aq, hmax zeroed; FFN1 (levels) + ReLU -> hid, its row max -> hmax;
//   FFN2 (hid quantized in registers by hmax) + LN2 -> out [, its levels ->
//   oq].
int encoder_layer_int8(const void* x, void* out, void* qkv, void* attn, void* x1, void* hid,
                       void* aq, void* ascale, void* hmax, const void* xq, const void* xscale,
                       void* oq, void* oscale, const void* wqkv, const void* sqkv,
                       const void* bqkv, const void* wo, const void* so, const void* bo,
                       const void* g1, const void* be1, const void* w1, const void* s1,
                       const void* b1, const void* w2, const void* s2, const void* b2,
                       const void* g2, const void* be2, int B, int L, int D, int H, int F,
                       void* stream_ptr) {
  if (!shapes_ok(B, L, D, H, F) || !xq != !xscale || !oq != !oscale)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const long long M = (long long)B * L;
  cudaError_t err;
  if (!xq) {
    launch_rowquant<true>(x, aq, ascale, M, D, s);
    xq = aq;
    xscale = ascale;
  }
  S8Args qkv_p = s8_args(bqkv, sqkv, qkv, 3 * D, M, D);
  qkv_p.ascale = static_cast<const float*>(xscale);
  VITIQ_TRY(launch_s8(xq, false, qkv_p, wqkv, 3 * D, s));
  VITIQ_TRY(attention_core<false>(static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), B, L,
                                  D, H, (long long)L * D, s));
  S8Args proj = with_ln(s8_args(bo, so, x1, D, M, D), x, D, g1, be1);
  proj.cq = static_cast<int8_t*>(aq);
  proj.cscale = static_cast<float*>(ascale);
  proj.clear = static_cast<uint32_t*>(hmax);
  VITIQ_TRY(launch_s8(attn, true, proj, wo, D, s));
  S8Args ffn1 = s8_args(b1, s1, hid, F, M, D);
  ffn1.ascale = static_cast<const float*>(ascale);
  ffn1.relu = 1;
  ffn1.row_max = static_cast<uint32_t*>(hmax);
  VITIQ_TRY(launch_s8(aq, false, ffn1, w1, F, s));
  S8Args ffn2 = with_ln(s8_args(b2, s2, out, D, M, F), x1, D, g2, be2);
  ffn2.amax_in = static_cast<const uint32_t*>(hmax);
  ffn2.cq = static_cast<int8_t*>(oq);
  ffn2.cscale = static_cast<float*>(oscale);
  VITIQ_TRY(launch_s8(hid, true, ffn2, w2, D, s));
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
    void* ascale, void* hmax, const void* xq, const void* xscale, void* oq, void* oscale,
    const void* wqkv, const void* sqkv, const void* bqkv, const void* wo, const void* so,
    const void* bo, const void* g1, const void* be1, const void* w1, const void* s1,
    const void* b1, const void* w2, const void* s2, const void* b2, const void* g2,
    const void* be2, int B, int L, int D, int H, int F, void* stream_ptr) {
  return encoder_layer_int8(x, out, qkv, attn, x1, hid, aq, ascale, hmax, xq, xscale, oq, oscale,
                            wqkv, sqkv, bqkv, wo, so, bo, g1, be1, w1, s1, b1, w2, s2, b2, g2,
                            be2, B, L, D, H, F, stream_ptr);
}

// One of K6's s8 stages alone, as the layer launches it: c [M, N] bf16 from
// A [M, K] and wq [N, K] int8 with wscale, bias [N] f32. A is int8 levels aq
// with row scales ascale [M] (the QKV and FFN1 stages), or (aq null) bf16 a
// quantized in the stage: with the scales of its whole rows where K <= 256
// (the out-projection), else of amax_in [M], the rows' absmax as f32 bits
// (FFN2). Epilogue: + bias, then ReLU (relu = 1) with, for A as levels,
// each row's max merged into row_max (if not null; zero it first); or, with
// res non-null (A bf16,
// N = 64, 128 or 256), + res [M, N] and LayerNorm with gamma, beta, the
// rows' levels into cq [M, N] and scales into cscale [M] (if not null), and
// clear [M] zeroed (if not null). K % 64 == 0, and K % 128 == 0 above 256;
// N % 64 == 0.
extern "C" int vitiq_gemm_s8_stage(const void* a, const void* aq, const void* ascale,
                                   const void* amax_in, const void* wq, const void* wscale,
                                   const void* bias, const void* res, const void* gamma,
                                   const void* beta, void* c, void* cq, void* cscale,
                                   void* row_max, void* clear, int M, int K, int N, int relu,
                                   void* stream_ptr) {
  S8Args p = s8_args(bias, wscale, c, N, M, K);
  if (res) p = with_ln(p, res, N, gamma, beta);
  p.ascale = static_cast<const float*>(ascale);
  p.amax_in = static_cast<const uint32_t*>(amax_in);
  p.cq = static_cast<int8_t*>(cq);
  p.cscale = static_cast<float*>(cscale);
  p.row_max = static_cast<uint32_t*>(row_max);
  p.clear = static_cast<uint32_t*>(clear);
  p.relu = relu;
  if (!cq != !cscale) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      launch_s8(aq ? aq : a, aq == nullptr, p, wq, N, static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One of K6's GEMM stages alone, c [M, N] bf16 = epilogue(int8_gemm(a)) with
// the bias (relu = 0) or the bias + ReLU (relu = 1) epilogue; a [M, K] bf16,
// wq [N, K] int8, wscale and bias [N] f32. With prequant = 1, a is quantized
// first by rowquant_kernel into the scratch aq [M, K] int8 and ascale [M],
// and the stage reads the levels, as the QKV and FFN1 stages take them;
// else the stage quantizes a in registers, as the out-projection and FFN2
// stages do (above K = 256 from the rows' absmax, which rowquant_kernel
// writes into ascale first). K % 64 == 0 (K % 128 == 0 and K <= 1024 above
// 256; K <= 1024 with prequant), N % 64 == 0.
extern "C" int vitiq_gemm_int8(const void* a, const void* wq, const void* wscale,
                               const void* bias, void* c, void* aq, void* ascale, int M, int K,
                               int N, int relu, int prequant, void* stream_ptr) {
  if (M <= 0 || K <= 0 || ((prequant || K > 256) && K > MAX_QUANT_K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  S8Args p = s8_args(bias, wscale, c, N, M, K);
  p.relu = relu;
  cudaError_t err;
  if (prequant) {
    launch_rowquant<true>(a, aq, ascale, M, K, s);
    p.ascale = static_cast<const float*>(ascale);
    err = launch_s8(aq, false, p, wq, N, s);
  } else {
    if (K > 256) {
      launch_rowquant<false>(a, nullptr, ascale, M, K, s);
      p.amax_in = static_cast<const uint32_t*>(ascale);
    }
    err = launch_s8(a, true, p, wq, N, s);
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
