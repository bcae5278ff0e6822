// Fused post-norm encoder layer for inference on Hopper (sm_90a).
//
// Replaces (TPU Pallas kernels of the JAX reference package):
//   K1  vitiq/ops/pallas/fused_encoder_layer.py: fused_encoder_layer_v3_stack
//       -> _fused_layer_kernel_v3 with the cross-head packed core
//          _v3_attention_core_xpack (every full layer of the stack)
//   K2  vitiq/ops/pallas/fused_encoder_layer.py: _fused_layer_kernel_v3_cls
//       with the chained core _v3_attention_core (last layer, CLS row only)
//       -> encoder_layer_cls: the layer reassociated so that no K or V is
//          formed, its attention a pooling of x (cls_pool_kernel)
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
//            one-pass core; K2's over its 16-token steps); the sums in f32
//            over the rounded p, rescaled by exp2(m_old - m_new) with the
//            numerators when a tile raises the max
//   x1     = bf16(LN(attn @ Wo + bo + x))    LN: biased variance, eps 1e-12,
//   y      = bf16(LN(relu(x1 @ W1 + b1) @ W2 + b2 + x1))   f32 stats, rsqrt
// All four GEMMs accumulate bf16 products in f32 (onto the bias, and the
// residual in the LN stages). K2 computes the same layer for query row 0
// only, attending over every token, out [B, 1, D]; it forms no K or V and
// rounds qt = W_k^T q and the pooled tokens xbar to bf16 where this rounds k
// and v (see encoder_layer_cls), an error of the same size.
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
//   1. gemm_wgmma_kernel<kBias>            QKV
//   2. attention_core_kernel<DH>           the one-pass core, every query row
//   3. gemm_wgmma_kernel<kBiasResidualLN>  out-projection + bias + residual + LN1
//   4. gemm_wgmma_kernel<kBias>, ReLU      FFN1 + bias + ReLU
//   5. gemm_wgmma_kernel<kBiasResidualLN>  FFN2 + bias + residual + LN2
// K2 launches seven: the q stage (row 0), the qt stage, cls_pool_kernel,
// the V stage, then 3-5 on its B rows (encoder_layer_cls).
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
//       (K2: cls_pool_kernel): heads are independent blocks, so neither the
//       block-diagonal packing (xpack, K13) nor the per-head chain (chain)
//       nor key tiling (kt, K9) has a
//       counterpart; a frame-head's K/V fit shared memory up to ~2.9K
//       tokens at d_head 16 (~1.6K at d_head 32, ~850 at d_head 64, so the
//       conv1d arm's 1025 tokens with n_head 2 are turned away by shapes_ok
//       and run the plain layers; K2's pooling streams x and has no bound of
//       its own); checked against the plain version on the card at the
//       conv1d arm's 1025 tokens.
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
//       are zero-filled up to the 64-key tile (TMA), and K2's x stages up to
//       16 tokens.
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
// and P [v | 1] as s8 x s8 -> s32 products on Hopper's s8 warpgroup MMA
// (wgmma m64nNk32: q's levels in registers against the int8 k rows, then
// P packed from the s32 accumulators straight into the register A fragment
// against v^T), probabilities rint(exp2(s - tile max) * 127) in 128-key
// tiles, each tile's scores computed once, merged on a running max in f32,
// one f32 divide per output. The ones column of [v | 1] shares v's scale
// (so av >= 1); its s32 product is rint(127 / av) times the row's sum of
// int8 probabilities, the same integer the TPU kernel's ones-column product
// gives. The frame-head's bf16 k and v are read once, by TMA, and quantized
// in place in shared memory (k K-major, v transposed with its keys
// permuted in 32s so that the s32 score fragments are P's s8 A fragment).
// At L <= 96 (the rawIQ arms' 65 tokens) the layer takes the earlier
// two-pass mma.sync core instead (attention_int8_sync_kernel, the same
// function), which measured faster there.
// The TPU kernel's block of G frames (VITIQ_V3_G, _pick_batch_block_v3) ->
// one frame-head an item: ak and av are per frame-head, which is the TPU
// kernel at G = 1 (its parity test pins g_override=1). Its Lp padding to 16
// rows -> none: the TPU kernel's padded rows carry nonzero k (at least the
// k bias), which enters its ak and each tile's row max; here keys stop at L,
// so at L != Lp the two differ by quantization noise and match closely where
// L = Lp. What bounds K7: its four bf16 GEMM stages are K1's (the bound
// counts their FLOPs at 989 TFLOP/s plus the s8 score and P [v | 1] products,
// 2 L^2 dh + 2 L^2 (dh + 1) operations a frame-head, at 1979 TOP/s); its core
// takes K1's core's shared memory, so it takes every shape K1 takes. The
// core is bound by latency: its per-tile chain (Q K^T, the softmax's IEEE
// arithmetic on 64 scores a thread, P V), a frame-head's load and
// quantization, and the blocks an SM its registers allow (PERF.md).

#include "common.cuh"
#include "hopper.cuh"
#include "attention_core.cuh"
#include "gemm_wgmma.cuh"

namespace {

constexpr int MAX_SMEM = 232448;  // shared memory a block may use on Hopper

// Launches of the kernels a layer's C entry launches one of among its
// stages, counted where each is launched (vitiq_kernel_launches): K2's
// pooling kernel and K7's two cores
enum CountedKernel { kCountClsPool = 0, kCountInt8Wgmma = 1, kCountInt8Sync = 2, kCounted = 3 };
unsigned long long launch_counts[kCounted] = {};
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

// The byte at offset `off` of a tile of `span`-byte rows (32, 64 or 128) as
// a TMA load (or wgmma's descriptor) with the swizzle of that width lays it
// out, from a base on the swizzle's repeat
__device__ __forceinline__ uint32_t swizzled(uint32_t off, int span) {
  return off ^ (((off >> 7) & (span / 16 - 1)) << 4);
}

// The shared-memory formula of the shape gate (shapes_ok): a frame-head's k
// rows and v^T in bf16, padded, the layout of K2's former two-pass core,
// which set the bound the gate has kept since (at d_head 64, L up to 848).
// K1's and K7's cores (core_smem_bytes) fit within it at every L it admits.
// fused_encoder_layer.attention_smem_bytes repeats it.
__host__ __device__ inline size_t gate_smem_bytes(int L, int dh) {
  const size_t lp = round16(L);
  return (lp * (dh + 8) + (size_t)dh * (lp + 8)) * sizeof(bf16);
}

// ---- K2: the CLS query's attention as one read of x (cls_pool_kernel) ------
// K2 forms no K or V. For the CLS row's q (pre-scaled by log2(e)/sqrt(dh)),
// head h and tokens x_j: s_hj = q_h . (W_k,h x_j + b_k,h) = x_j . qt_h +
// const_h with qt_h = W_k,h^T q_h (the constant cancels in the softmax), and
// o_h = sum_j p_hj (W_v,h x_j + b_v,h) = W_v,h xbar_h + b_v,h with xbar_h =
// sum_j p_hj x_j / sum_j p_hj. So qt [B, H, D] comes from a GEMM stage on a
// block operand (Kblk [D, H D]), this kernel pools each frame's tokens into
// xbar [B, H, D], and the V stage is a GEMM stage on Vblk [H D, D] + b_v.
constexpr int POOL_WARPS = 4;     // warps a block, each on frames of its own
constexpr int POOL_STEP = 16;     // tokens a ring stage holds: the mma's M
constexpr int POOL_RING = 20480;  // bytes of a warp's ring below D = 256

// Stages of a warp's ring: 20 KB below D = 256 (at most 8), 2 at D = 256,
// so that two blocks fit an SM at every width but d_model 256 with d_head 16
__host__ __device__ constexpr int pool_stages(int D) {
  return D >= 256 ? 2 : POOL_RING / (POOL_STEP * 2 * D) > 8 ? 8 : POOL_RING / (POOL_STEP * 2 * D);
}
// qt's rows in shared memory (bf16): padded so that the 32-bit loads of a
// warp's B fragments (8 heads x 4) fall on distinct banks
__host__ __device__ constexpr int pool_qld(int D) { return D + 8; }

// Shared memory of cls_pool_kernel (fused_encoder_layer.pool_smem_bytes
// repeats it): 1 KB to align the rings to the swizzle's repeat, then per
// warp its ring, two buffers of qt rows (8 heads a head block) and an
// mbarrier a stage.
__host__ __device__ inline size_t pool_smem_bytes(int D, int nhb) {
  const int ns = pool_stages(D);
  return 1024 + (size_t)POOL_WARPS * ((size_t)ns * POOL_STEP * D * 2 +
                                      (size_t)2 * nhb * 8 * pool_qld(D) * 2 + ns * 8);
}

// 16 bytes global -> shared, asynchronously (cp.async, L2 only); a thread's
// copies form groups (cp_async_commit), cp_async_wait<N> waits until at most
// N of its latest groups are pending
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of token r (0-15), column col (a multiple of 8) in a stage:
// D / 64 boxes [16 tokens][64 columns], 128-byte swizzled as TMA wrote them
__device__ __forceinline__ uint32_t pool_x_off(int r, int col) {
  return (col >> 6) * (POOL_STEP * 128) + swizzled(r * 128 + (col & 63) * 2, 128);
}

// Ring item it of a warp (its lane 0): step it % n_steps of its frame
// first + (it / n_steps) stride, into stage it % NS, D / 64 boxes on the
// stage's mbarrier
template <int D, int NS>
__device__ __forceinline__ void pool_issue(const CUtensorMap* x_map, unsigned char* ring,
                                           uint64_t* full, int it, int n_steps, int first,
                                           int stride) {
  const int f = first + (it / n_steps) * stride, step = it % n_steps, s = it % NS;
  mbar_expect_tx(&full[s], POOL_STEP * D * 2);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_3d(ring + s * (POOL_STEP * D * 2) + c * (POOL_STEP * 128), x_map, &full[s], 64 * c,
                step * POOL_STEP, f);
}

// xbar [B, H, D] bf16 from x [B, L, D] and qt [B, H, D] (bf16):
//   s_hj = x_j . qt_h (log2 units), p_hj = exp2(s_hj - m_h) rounded to bf16
//   at the running max m_h of 16-token steps, l_h = the f32 sum of the
//   rounded p (both rescaled by exp2(m_old - m_new) when a step raises the
//   max), xbar_h = bf16(sum_j p_hj x_j / l_h).
// Each warp takes frames of its own (frame blockIdx.x * POOL_WARPS + warp,
// then every gridDim.x * POOL_WARPS; the grid fills the SMs once) and
// streams each frame's x once through its ring of 16-token stages (TMA, a
// 3-D map over x, boxes past L zero-filled; lane 0 refills a stage once the
// warp is past it), the stages running on across frames. Per step, with
// the heads as the mma's N (8 a head block; H <= 8 but at d_model 256,
// d_head 16):
//   S [16 tokens, 8 heads] = X qt^T: mma.sync m16n8k16, X's A fragments by
//   ldmatrix from the stage, qt's B fragments from the warp's copy of the
//   frame's qt rows (heads past H zero; the next frame's rows arrive by
//   cp.async meanwhile); tokens past L -> -inf;
//   each head's column max by three shuffles (the tokens lie across the
//   quads), the online softmax in registers; P packed to bf16 and moved
//   into the B fragment of the next product by movmatrix (a transpose in
//   registers);
//   xbar^T [D, 8 heads] += X^T P: mma.sync with X^T's A fragments by
//   ldmatrix .trans from the same stage, the accumulators in registers (D /
//   16 tiles of 4 a head block).
// What bounds it: reading x once (B L D bf16); its MMAs are 4 B L D 8 FLOPs
// per head block on the tensor cores, and ldmatrix reads each stage twice.
template <int D, int NHB>
__global__ void __launch_bounds__(POOL_WARPS * 32, 1) cls_pool_kernel(
    const __grid_constant__ CUtensorMap x_map, const bf16* __restrict__ qt,
    bf16* __restrict__ xbar, int B, int L, int H) {
  constexpr int NS = pool_stages(D), STAGE = POOL_STEP * D * 2, QLD = pool_qld(D), MT = D / 16;
  extern __shared__ unsigned char pool_raw[];
  unsigned char* smem = pool_raw + ((1024 - (smem_u32(pool_raw) & 1023)) & 1023);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned char* ring = smem + (size_t)warp * NS * STAGE;
  unsigned char* rest = smem + (size_t)POOL_WARPS * NS * STAGE;
  bf16* qs2 = reinterpret_cast<bf16*>(rest) + warp * 2 * NHB * 8 * QLD;  // [2][NHB 8][QLD]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(rest + (size_t)POOL_WARPS * 2 * NHB * 8 * QLD * 2) + warp * NS;
  const int n_steps = (L + POOL_STEP - 1) / POOL_STEP;
  const int first = blockIdx.x * POOL_WARPS + warp, stride = gridDim.x * POOL_WARPS;
  const int n_frames = first < B ? (B - 1 - first) / stride + 1 : 0;
  const int n_items = n_frames * n_steps;

  if (lane == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncwarp();
  if (lane == 0)
    for (int it = 0; it < NS && it < n_items; ++it)
      pool_issue<D, NS>(&x_map, ring, full, it, n_steps, first, stride);

  // the frames' qt rows in two buffers: the next frame's copied (cp.async)
  // while this one runs; rows of heads past H are zero in both
  for (int i = lane; i < 2 * NHB * 8 * (D / 8); i += 32) {
    const int hh = i / (D / 8) % (NHB * 8), c = 8 * (i % (D / 8));
    if (hh >= H)
      *reinterpret_cast<uint4*>(qs2 + (i / (D / 8)) * QLD + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  auto copy_qt = [&](int k) {  // frame k's qt rows into buffer k & 1
    const bf16* src = qt + (long long)(first + k * stride) * H * D;
    bf16* dst = qs2 + (k & 1) * NHB * 8 * QLD;
    for (int i = lane; i < H * (D / 8); i += 32)
      cp_async16(dst + (i / (D / 8)) * QLD + 8 * (i % (D / 8)), src + 8 * i);
  };
  if (n_frames > 0) copy_qt(0);
  cp_async_commit();

  const uint32_t ring_addr = smem_u32(ring);
  int it = 0;
  for (int k = 0; k < n_frames; ++k) {
    const int f = first + k * stride;
    if (k + 1 < n_frames) copy_qt(k + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this frame's copy is done
    __syncwarp();
    const bf16* qs = qs2 + (k & 1) * NHB * 8 * QLD;
    float acc[NHB][MT][4];
    float m[NHB][2], l[NHB][2];
#pragma unroll
    for (int hb = 0; hb < NHB; ++hb) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[hb][mt][i] = 0.f;
      m[hb][0] = m[hb][1] = -INFINITY;
      l[hb][0] = l[hb][1] = 0.f;
    }
    for (int step = 0; step < n_steps; ++step, ++it) {
      const int s = it % NS;
      mbar_wait(&full[s], (uint32_t)((it / NS) & 1));
      const uint32_t tile = ring_addr + s * STAGE;
      // two chains of products (even and odd 16-deep steps), then summed
      float sc[NHB][4], sc2[NHB][4];
#pragma unroll
      for (int hb = 0; hb < NHB; ++hb)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[hb][i] = sc2[hb][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, tile + pool_x_off(lane & 15, 16 * kk + 8 * (lane >> 4)));
#pragma unroll
        for (int hb = 0; hb < NHB; ++hb) {
          const bf16* qrow = qs + (8 * hb + g) * QLD + 16 * kk + 2 * t;
          mma_bf16_16816((kk & 1) ? sc2[hb] : sc[hb], a, ld_b32(qrow), ld_b32(qrow + 8));
        }
      }
#pragma unroll
      for (int hb = 0; hb < NHB; ++hb)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[hb][i] += sc2[hb][i];
      const int tok0 = step * POOL_STEP;
      uint32_t pb[NHB][2];
#pragma unroll
      for (int hb = 0; hb < NHB; ++hb) {
        if (tok0 + POOL_STEP > L) {  // warp-uniform
          if (tok0 + g >= L) sc[hb][0] = sc[hb][1] = -INFINITY;
          if (tok0 + g + 8 >= L) sc[hb][2] = sc[hb][3] = -INFINITY;
        }
        float mn[2], a[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // head 8 hb + 2t + c: its column of the step
          float cm = fmaxf(sc[hb][c], sc[hb][c + 2]);
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 4));
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 8));
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 16));
          mn[c] = fmaxf(m[hb][c], cm);
          a[c] = exp2_sfu(m[hb][c] - mn[c]);
          m[hb][c] = mn[c];
        }
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(exp2_sfu(sc[hb][0] - mn[0]), exp2_sfu(sc[hb][1] - mn[1]));
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(exp2_sfu(sc[hb][2] - mn[0]), exp2_sfu(sc[hb][3] - mn[1]));
        const float2 flo = __bfloat1622float2(lo), fhi = __bfloat1622float2(hi);
        l[hb][0] = l[hb][0] * a[0] + (flo.x + fhi.x);
        l[hb][1] = l[hb][1] * a[1] + (flo.y + fhi.y);
        if (__any_sync(0xffffffffu, a[0] != 1.f || a[1] != 1.f)) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            acc[hb][mt][0] *= a[0];
            acc[hb][mt][1] *= a[1];
            acc[hb][mt][2] *= a[0];
            acc[hb][mt][3] *= a[1];
          }
        }
        // P [16 tokens, 8 heads] as two 8 x 8 bf16 matrices (tokens g, g + 8),
        // transposed into the B fragment [tokens 2t.., 8 + 2t..][head g]
        pb[hb][0] = movmatrix_trans(*reinterpret_cast<const uint32_t*>(&lo));
        pb[hb][1] = movmatrix_trans(*reinterpret_cast<const uint32_t*>(&hi));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, tile + pool_x_off((lane & 7) + 8 * (lane >> 4),
                                               16 * mt + 8 * ((lane >> 3) & 1)));
#pragma unroll
        for (int hb = 0; hb < NHB; ++hb) mma_bf16_16816(acc[hb][mt], a, pb[hb][0], pb[hb][1]);
      }
      __syncwarp();  // the warp is past the stage: lane 0 refills it
      if (lane == 0 && it + NS < n_items)
        pool_issue<D, NS>(&x_map, ring, full, it + NS, n_steps, first, stride);
    }
    // each head's sum over the quads (lanes of one t hold one head's tokens)
    bf16* o = xbar + (long long)f * H * D;
#pragma unroll
    for (int hb = 0; hb < NHB; ++hb) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        l[hb][c] += __shfl_xor_sync(0xffffffffu, l[hb][c], 4);
        l[hb][c] += __shfl_xor_sync(0xffffffffu, l[hb][c], 8);
        l[hb][c] += __shfl_xor_sync(0xffffffffu, l[hb][c], 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int head = 8 * hb + 2 * t + (i & 1), dim = 16 * mt + g + 8 * (i >> 1);
          if (head < H) o[head * D + dim] = __float2bfloat16(acc[hb][mt][i] / l[hb][i & 1]);
        }
    }
    __syncwarp();  // every lane is past qs before the copy after next lands in it
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

// ---- K7: the int8 attention core on s8 wgmma --------------------------------
constexpr int K7_TILE = 128;               // keys per tile, as the TPU kernel's
constexpr float K7_SCALE_FLOOR = 1e-8f;    // aq, ak floor
constexpr float K7_DEQ = 127.0f * 127.0f;  // scores = s32 * aq * (ak / 127^2)

__device__ __forceinline__ int quad_sum_int(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// round(v * m) as an int8 level (|v * m| <= 127 by construction: m = 127 /
// absmax of the values v comes from), in the low byte: the bits of rn(v m)
// + 1.5 * 2^23 are 0x4B400000 + rint(v m) (RN-even, as __float2int_rn;
// a negative level borrows from the zero low byte, its two's complement),
// on the FMA pipe where a conversion would take the one MUFU uses
__device__ __forceinline__ uint32_t level_byte(float v, float m) {
  return __float_as_uint(__fadd_rn(__fmul_rn(v, m), 12582912.0f));
}
// four levels' low bytes as one word, the first in the low byte
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// The bf16 pair in a word as f32: the low element, the high one
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 8 bf16 values (one 16-byte chunk) -> their 8 int8 levels at the multiplier m
__device__ __forceinline__ uint2 levels8(const uint4& chunk, float m) {
  const uint32_t w[4] = {chunk.x, chunk.y, chunk.z, chunk.w};
  uint32_t b[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b[2 * i] = level_byte(bf16_lo(w[i]), m);
    b[2 * i + 1] = level_byte(bf16_hi(w[i]), m);
  }
  return make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
}

// The max of |x| over the bf16 values of a chunk and `amax` (bf16 magnitude
// bits, both halves of each word): finite bf16 magnitudes order as their
// 15-bit integers, so the max is taken on the packed pairs
__device__ __forceinline__ uint32_t absmax_bits8(const uint4& chunk, uint32_t amax) {
  amax = __vmaxu2(amax, chunk.x & 0x7fff7fffu);
  amax = __vmaxu2(amax, chunk.y & 0x7fff7fffu);
  amax = __vmaxu2(amax, chunk.z & 0x7fff7fffu);
  return __vmaxu2(amax, chunk.w & 0x7fff7fffu);
}
// the f32 value of absmax_bits8's result (the larger half)
__device__ __forceinline__ float absmax_of_bits(uint32_t amax) {
  return __uint_as_float(max(amax & 0xffffu, amax >> 16) << 16);
}

// The int8 k rows' width: one s8 k-step (32 bytes) at d_head 16 and 32, the
// head's 64 bytes at d_head 64
template <int DH>
__host__ __device__ constexpr int k8_span() { return DH < 32 ? 32 : DH; }

// Shared memory of attention_int8_kernel at L tokens: the frame-head's bf16
// k and v in 64-key tiles (K1's core's), an mbarrier and 1 KB of alignment
// (fused_encoder_layer_int8attn.attention_int8_smem_bytes repeats it); it
// fits every L the shape gate admits.
__host__ __device__ inline size_t k7_smem_bytes(int L, int dh) {
  const size_t n_kt = (L + CORE_KT - 1) / CORE_KT;
  return 1024 + n_kt * CORE_KT * dh * 2 * 2 + 8;
}

// Where the int8 v^T tiles start: at the bf16 v tiles' start (n_kt 64-key
// tiles of k before them), a multiple of the swizzle's 1 KB repeat
template <int DH>
__host__ __device__ __forceinline__ uint32_t v8_base(int n_kt) {
  return (uint32_t)n_kt * CORE_KT * DH * 2;
}

// One 128-key tile of K7's core for one warpgroup's 64 query rows, NT keys
// wide (128, or the narrowest of 64, 32, 16 that covers a ragged last tile):
//   s = qq kq^T (s32, m64nNTk32 from q's levels in registers against the
//   int8 k rows, K-major), dequantized, the tile's row max tm, p =
//   rint(exp2(s - tm) * 127) packed from the accumulators straight into the
//   s8 A fragment of P [v | 1] (m64nDHk32 against v^T, its keys permuted as
//   v8_col), the ones column's product one * sum p; merged onto the running
//   max in f32. Keys past L are -inf (p = 0); a warp whose rows all lie past
//   L skips the softmax (its P is zero). Every wgmma is issued by the whole
//   warpgroup on every path.
struct K7Rows {  // a thread's two query rows: the running state of the merge
  float m_lo, m_hi, den_lo, den_hi;
};

struct K7Dump {  // the DUMP variant's outputs and where this tile's go
  int* s;
  int8_t* p;
  int* pv;
  long long head;  // frame * H + head
  int n_tiles, kt;
};

template <int DH, bool DUMP, int NT>
__device__ __forceinline__ void k7_tile(float* acc, K7Rows& st, const uint32_t (*qa)[4],
                                        uint32_t k_tile, uint32_t v_tile, int key0, int L,
                                        float deq_lo, float deq_hi, int one, bool first,
                                        bool live, int r_lo, int t, const K7Dump& dump) {
  constexpr int KSPAN = k8_span<DH>(), KC = KSPAN / 32;
  constexpr int KS = (NT + 31) / 32;  // s8 k-steps of P [v | 1]
  int s[NT / 2];
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    WgmmaS8<NT>::rs(s, qa[kc], smem_desc(k_tile + kc * 32, KSPAN, 8 * KSPAN, 8 * KSPAN), kc);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<NT / 2>(s);
  const int r_hi = r_lo + 8;
  // DUMP: this thread's two rows of the scores and probabilities at the
  // tile's key 2t, rows lp = 128 n_tiles apart (the keys past L in them are
  // not read; rows past L are not written)
  const long long lp = 128LL * dump.n_tiles;
  const long long row_lo = (dump.head * L + r_lo) * lp + key0 + 2 * t, row_hi = row_lo + 8 * lp;
  if constexpr (DUMP) {
#pragma unroll
    for (int e = 0; e < NT / 2; ++e)
      if (((e & 2) ? r_hi : r_lo) < L)
        dump.s[((e & 2) ? row_hi : row_lo) + 8 * (e >> 2) + (e & 1)] = s[e];
  }
  uint32_t pa[KS][4];
  int psum_lo = 0, psum_hi = 0;
  float tm_lo = -INFINITY, tm_hi = -INFINITY;
  if (live) {
    const bool ragged = key0 + NT > L;  // uniform: keys past L in the tile
    float f[NT / 2];
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) {
      f[e] = __fmul_rn(s32_to_f32<true>(s[e]), (e & 2) ? deq_hi : deq_lo);
      if (ragged && key0 + 8 * (e >> 2) + 2 * t + (e & 1) >= L) f[e] = -INFINITY;
      if (e & 2)
        tm_hi = fmaxf(tm_hi, f[e]);
      else
        tm_lo = fmaxf(tm_lo, f[e]);
    }
    tm_lo = quad_max(tm_lo);
    tm_hi = quad_max(tm_hi);
    // p as the bits of x + 1.5 * 2^23, x = exp2(s - tm) * 127: the low byte is
    // rint(x) (RN-even, exact for 0 <= x <= 127), and the bits summed less
    // 0x4B400000 each (modulo 2^32) are the sum of p. exp2 on MUFU.EX2 (the
    // plain version's exp2f takes the same instruction where the result is
    // normal; below, both p are 0). Each k-step's 16 p are packed as they are
    // formed: its A fragment [row g | g+8][k' = 4t.. | 16 + 4t..] holds keys
    // 2t, 2t+1, 8+2t, 9+2t of the step's first / second 16 (v8_col).
    uint32_t bsum_lo = 0u, bsum_hi = 0u;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = 4 * ks + 2 * (a >> 1), i = (a & 1) * 2;  // key groups j, j + 1; row i / 2
        if (j >= NT / 8) {
          pa[ks][a] = 0u;
          continue;
        }
        uint32_t b4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = 4 * (j + (u >> 1)) + i + (u & 1);
          const float x = __fmul_rn(exp2_sfu(__fsub_rn(f[e], i ? tm_hi : tm_lo)), 127.f);
          b4[u] = __float_as_uint(__fadd_rn(x, 12582912.0f));
          if (i)
            bsum_hi += b4[u];
          else
            bsum_lo += b4[u];
          if constexpr (DUMP) {
            if ((i ? r_hi : r_lo) < L)
              dump.p[(i ? row_hi : row_lo) + 8 * (j + (u >> 1)) + (u & 1)] =
                  static_cast<int8_t>(b4[u] & 0xffu);
          }
        }
        pa[ks][a] = pack4(b4[0], b4[1], b4[2], b4[3]);
      }
    psum_lo = (int)(bsum_lo - (uint32_t)(NT / 4) * 0x4B400000u);
    psum_hi = (int)(bsum_hi - (uint32_t)(NT / 4) * 0x4B400000u);
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) pa[ks][0] = pa[ks][1] = pa[ks][2] = pa[ks][3] = 0u;
  }
  int part[DH / 2];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    WgmmaS8<DH>::rs(part, pa[ks], smem_desc(v_tile + ks * 32, 128, 1024, 1024), ks);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<DH / 2>(part);
  const int den_int_lo = one * quad_sum_int(psum_lo), den_int_hi = one * quad_sum_int(psum_hi);
  if constexpr (DUMP) {
    int* pv = dump.pv + ((dump.head * dump.n_tiles) + dump.kt) * L * (DH + 1);
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) {
      const int r = (e & 2) ? r_hi : r_lo;
      if (r < L) pv[r * (DH + 1) + 8 * (e >> 2) + 2 * t + (e & 1)] = part[e];
    }
    if (t == 0) {
      if (r_lo < L) pv[r_lo * (DH + 1) + DH] = den_int_lo;
      if (r_hi < L) pv[r_hi * (DH + 1) + DH] = den_int_hi;
    }
  }
  // merge the tile onto the running max
  if (first) {
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) acc[e] = static_cast<float>(part[e]);
    st.den_lo = static_cast<float>(den_int_lo);
    st.den_hi = static_cast<float>(den_int_hi);
    st.m_lo = tm_lo;
    st.m_hi = tm_hi;
  } else {
    const float new_lo = fmaxf(st.m_lo, tm_lo), new_hi = fmaxf(st.m_hi, tm_hi);
    const float old_lo = exp2f(__fsub_rn(st.m_lo, new_lo)), cur_lo = exp2f(__fsub_rn(tm_lo, new_lo));
    const float old_hi = exp2f(__fsub_rn(st.m_hi, new_hi)), cur_hi = exp2f(__fsub_rn(tm_hi, new_hi));
#pragma unroll
    for (int e = 0; e < DH / 2; ++e)
      acc[e] = __fadd_rn(__fmul_rn(acc[e], (e & 2) ? old_hi : old_lo),
                         __fmul_rn(static_cast<float>(part[e]), (e & 2) ? cur_hi : cur_lo));
    st.den_lo = __fadd_rn(__fmul_rn(st.den_lo, old_lo), __fmul_rn(static_cast<float>(den_int_lo), cur_lo));
    st.den_hi = __fadd_rn(__fmul_rn(st.den_hi, old_hi), __fmul_rn(static_cast<float>(den_int_hi), cur_hi));
    st.m_lo = new_lo;
    st.m_hi = new_hi;
  }
}

// K7's attention core on qkv [B, L, 3D]
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
// One block of one warpgroup a frame-head (blockIdx.x = b H + h). Its bf16
// k and v arrive once, by TMA (K1's 3-D map over qkv, 64-key tiles, zeros
// past L), on one mbarrier, while the first query tile's q loads. Both
// absmaxes come from shared memory (on the bf16 magnitude bits, two a
// word); then the block quantizes in place, 128
// keys a round (each round reads its two tiles of k and of v into
// registers, passes a barrier, writes): k into int8 rows [key][k8_span]
// from the start (a K-major B operand, swizzled by its width), v into v^T
// tiles [128-key tile][dim][128 keys'] from v8_base, the v tiles' start
// (K-major, 128-byte swizzle), each thread four keys' levels a word (a
// warp's stores one v^T row each), keys permuted in 32s (v8_col: key 16h +
// 8a + 2t + e at 16h + 4t + 2a + e) so
// that the probabilities a thread holds in the s32 score accumulators form
// P's s8 A fragment as they are. A round's writes land only on the bytes it
// read: the int8 k rows of its 128 keys end by 128 k8_span <= its two k
// tiles' end (k8_span <= 2 DH), and its v^T tile takes its two v tiles'
// place. The warpgroup then takes the 64-row query tiles in turn: q's
// levels in registers (a quad holds a row), then each 128-key tile once
// (k7_tile). bf16 values are unpacked by shifts of their words and the
// absmaxes taken on their magnitude bits (with bf16 pointers to register
// words and f32 maxima, the prologue measured twice as long).
// Registers are held to 128 a thread at d_head 16 and 170 at 32 and 64, so
// that four and three blocks fit an SM without a spill: the core is
// latency-bound (PERF.md). (Persistent blocks walking the frame-heads with
// the next one's tiles loading took 30-80 registers more a thread.)
// With DUMP, the s32 scores, the int8 probabilities and each tile's s32
// [P V | den] go to device memory for the check against the plain version:
// s_dump [B, H, L, Lp], p_dump [B, H, L, Lp] (Lp = 128 ceil(L / 128); the
// keys past L hold what the tile computed there), pv_dump [B, H, ceil(L /
// 128), L, DH + 1].
template <int DH, bool DUMP>
__global__ void __launch_bounds__(128, DUMP ? 1 : DH == 16 ? 4 : 3) attention_int8_kernel(
    const __grid_constant__ CUtensorMap kv_map, const bf16* __restrict__ qkv,
    bf16* __restrict__ out, int L, int D, int H, int* __restrict__ s_dump,
    int8_t* __restrict__ p_dump, int* __restrict__ pv_dump) {
  static_assert(DH == 16 || DH == 32 || DH == 64, "d_head 16, 32 or 64");
  constexpr int TK = CORE_KT * DH * 2;  // bytes of a bf16 k or v tile
  constexpr int SPAN = DH * 2;          // its rows, and TMA's swizzle
  constexpr int KSPAN = k8_span<DH>(), KC = KSPAN / 32;
  extern __shared__ unsigned char k7_raw[];
  __shared__ float red[2][4];
  unsigned char* smem = k7_raw + ((1024 - (smem_u32(k7_raw) & 1023)) & 1023);
  const int n_kt = (L + CORE_KT - 1) / CORE_KT;
  unsigned char* vs = smem + (size_t)n_kt * TK;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + (size_t)2 * n_kt * TK);
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nthr = 128, lane = threadIdx.x & 31;
  // the warp index broadcast from lane 0, so that ptxas sees it warp-uniform
  // (wgmma under control flow it takes for divergent is serialized)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), warp_id = warp;
  const int g = lane >> 2, t = lane & 3;
  const long long row3 = 3LL * D;
  const int n_tiles = (L + K7_TILE - 1) / K7_TILE;
  const bf16* base = qkv + (long long)b * L * row3 + (long long)h * DH;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_expect_tx(bar, 2 * n_kt * TK);
    for (int i = 0; i < n_kt; ++i) {
      tma_load_3d(smem + (size_t)i * TK, &kv_map, bar, D + h * DH, i * CORE_KT, b);
      tma_load_3d(vs + (size_t)i * TK, &kv_map, bar, 2 * D + h * DH, i * CORE_KT, b);
    }
  }
  // this thread's q words for a query tile: rows q0 + 16 warp + g (+ 8 where
  // a & 1), dims 32kc + 4t.. and 32kc + 16 + 4t.. (a >> 1); the first tile's
  // load is in flight while the k and v tiles arrive
  auto load_q = [&](uint2 (&raw)[KC][4], int q0) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = q0 + warp * 16 + g + 8 * (a & 1), d0 = kc * 32 + (a >> 1) * 16 + 4 * t;
        raw[kc][a] = r < L && d0 < DH ? *reinterpret_cast<const uint2*>(base + r * row3 + d0)
                                      : make_uint2(0u, 0u);
      }
  };
  uint2 qraw[KC][4];
  load_q(qraw, 0);
  __syncthreads();  // the mbarrier is initialized
  mbar_wait(bar, 0);
  // the frame-head's k and v absmax (rows past L arrived as zeros)
  uint32_t kbits = 0u, vbits = 0u;
  for (int i = threadIdx.x; i < n_kt * TK / 16; i += nthr) {
    kbits = absmax_bits8(*reinterpret_cast<const uint4*>(smem + 16 * i), kbits);
    vbits = absmax_bits8(*reinterpret_cast<const uint4*>(vs + 16 * i), vbits);
  }
  float ka = warp_max(absmax_of_bits(kbits)), va = warp_max(absmax_of_bits(vbits));
  if (lane == 0) {
    red[0][warp_id] = ka;
    red[1][warp_id] = va;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    ka = fmaxf(ka, red[0][w]);
    va = fmaxf(va, red[1][w]);
  }
  const float ak = fmaxf(ka, K7_SCALE_FLOOR), av = fmaxf(va, 1.0f);
  const float kmul = __fdiv_rn(127.f, ak), vmul = __fdiv_rn(127.f, av);
  const int one = __float2int_rn(vmul);
  const float ak_deq = __fdiv_rn(ak, K7_DEQ);
  const uint32_t v8 = v8_base<DH>(n_kt);

  // In place, 128 keys (two bf16 tiles of k and of v) a round: a k unit is
  // one key's 8 dims (16 bytes -> 8), a v unit keys 16h + 2t, +1, +8, +9 at
  // 8 dims (each dim's four levels one word of its v^T row); every read of a
  // round precedes its barrier, every write follows it
  constexpr int K_UNITS = 2 * CORE_KT * DH / 8, V_UNITS = 2 * CORE_KT / 16 * 4 * (DH / 8);
  constexpr int K_PER = K_UNITS / 128, V_PER = (V_UNITS + 127) / 128;  // at 128 threads
  for (int i = 0; i < n_kt; i += 2) {
    const int keys = min(2 * CORE_KT, (n_kt - i) * CORE_KT);  // the round's tile keys
    uint2 lev[K_PER];
#pragma unroll
    for (int u = 0; u < K_PER; ++u) {
      const int idx = threadIdx.x + u * nthr, key = idx / (DH / 8), c = idx % (DH / 8);
      if (idx < K_UNITS && key < keys)
        lev[u] = levels8(*reinterpret_cast<const uint4*>(
                             smem + (size_t)i * TK + (key >= CORE_KT ? TK : 0) +
                             swizzled((key % CORE_KT) * SPAN + 16 * c, SPAN)),
                         kmul);
    }
    uint32_t w[V_PER][8];
#pragma unroll
    for (int u = 0; u < V_PER; ++u) {
      // a warp's units share their 8 dims (c), so that each of its stores
      // writes one v^T row's 32 words
      const int idx = threadIdx.x + u * nthr, c = idx / 32, tt = idx % 4;
      const int grp = idx / 4 % 8;  // 16-key group of the round's 128
      if (idx < V_UNITS && 16 * grp < keys) {
        uint2 lv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int key = 16 * grp + 2 * tt + (k & 1) + 8 * (k >> 1);
          lv[k] = levels8(*reinterpret_cast<const uint4*>(
                              vs + (size_t)i * TK + (key >= CORE_KT ? TK : 0) +
                              swizzled((key % CORE_KT) * SPAN + 16 * c, SPAN)),
                          vmul);
        }
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          const int sh = 8 * (d & 3);
          auto byte = [&](int k) { return ((d < 4) ? lv[k].x : lv[k].y) >> sh; };
          w[u][d] = pack4(byte(0), byte(1), byte(2), byte(3));
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < K_PER; ++u) {
      const int idx = threadIdx.x + u * nthr, key = idx / (DH / 8), c = idx % (DH / 8);
      if (idx < K_UNITS && key < keys)
        *reinterpret_cast<uint2*>(
            smem + swizzled((i * CORE_KT + key) * KSPAN + 8 * c, KSPAN)) = lev[u];
    }
    const uint32_t tile = v8 + (uint32_t)(i >> 1) * DH * 128;
#pragma unroll
    for (int u = 0; u < V_PER; ++u) {
      const int idx = threadIdx.x + u * nthr, c = idx / 32, tt = idx % 4, grp = idx / 4 % 8;
      if (idx < V_UNITS && 16 * grp < keys) {
#pragma unroll
        for (int d = 0; d < 8; ++d)
          *reinterpret_cast<uint32_t*>(
              smem + tile + swizzled((8 * c + d) * 128 + 16 * grp + 4 * tt, 128)) = w[u][d];
      }
    }
  }
  fence_proxy_async();  // the levels, written by threads, are read by wgmma
  __syncthreads();

  const uint32_t k8_addr = smem_u32(smem), v8_addr = smem_u32(smem) + v8;
  K7Dump dump{s_dump, p_dump, pv_dump, (long long)blockIdx.x, n_tiles, 0};
  for (int q0 = 0; q0 < L; q0 += 64) {
    const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
    const bool live = q0 + warp * 16 < L;  // warp-uniform
    if (q0 > 0) load_q(qraw, q0);
    float qf[KC][4][4];
    float amax_lo = 0.f, amax_hi = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const uint2 q4 = qraw[kc][a];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t w = e < 2 ? q4.x : q4.y;
          qf[kc][a][e] = (e & 1) ? bf16_hi(w) : bf16_lo(w);
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
          const float m = (a & 1) ? qmul_hi : qmul_lo;
          qa[kc][a] = pack4(level_byte(qf[kc][a][0], m), level_byte(qf[kc][a][1], m),
                            level_byte(qf[kc][a][2], m), level_byte(qf[kc][a][3], m));
        }

    float acc[DH / 2];
    K7Rows st{};
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int key0 = kt * K7_TILE, valid = L - key0;  // uniform
      const uint32_t k_tile = k8_addr + key0 * KSPAN, v_tile = v8_addr + kt * DH * 128;
      dump.kt = kt;
      if (valid > 64)
        k7_tile<DH, DUMP, 128>(acc, st, qa, k_tile, v_tile, key0, L, deq_lo, deq_hi, one,
                               kt == 0, live, r_lo, t, dump);
      else if (valid > 32)
        k7_tile<DH, DUMP, 64>(acc, st, qa, k_tile, v_tile, key0, L, deq_lo, deq_hi, one,
                              kt == 0, live, r_lo, t, dump);
      else if (valid > 16)
        k7_tile<DH, DUMP, 32>(acc, st, qa, k_tile, v_tile, key0, L, deq_lo, deq_hi, one,
                              kt == 0, live, r_lo, t, dump);
      else
        k7_tile<DH, DUMP, 16>(acc, st, qa, k_tile, v_tile, key0, L, deq_lo, deq_hi, one,
                              kt == 0, live, r_lo, t, dump);
    }

    bf16* o_base = out + (long long)b * L * D + h * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (r_lo < L)
        *reinterpret_cast<uint32_t*>(o_base + (long long)r_lo * D + j * 8) =
            pack_bf16x2(__fdiv_rn(acc[4 * j], st.den_lo), __fdiv_rn(acc[4 * j + 1], st.den_lo));
      if (r_hi < L)
        *reinterpret_cast<uint32_t*>(o_base + (long long)r_hi * D + j * 8) =
            pack_bf16x2(__fdiv_rn(acc[4 * j + 2], st.den_hi),
                        __fdiv_rn(acc[4 * j + 3], st.den_hi));
    }
  }
}

// ---- K7's core at short L: two passes on mma.sync ---------------------------
// At short L the wgmma core's 64-row query tiles and 128-wide key tile
// compute mostly padding (at 65 tokens two query tiles, the second with one
// live row, against 128 keys: 3.9x the scores), and the warpgroup waits on
// every wgmma; there the two-pass core below, whose 16-row tiles and
// 32-key blocks follow L, measured faster. Over L the two cross between 81
// and 97 tokens at d_head 16 and 32 (the sync core's cost is flat from 81
// to 96: the same six row tiles and three key blocks), so it takes
// L <= K7_SYNC_MAX_L (PERF.md). It computes the same function: the same
// 128-key tiles, levels, IEEE roundings and scale floors, so its s32
// products are the plain version's bit for bit too. The route depends on L
// alone (k7_sync_core).
constexpr int K7_SYNC_WARPS = 4;
constexpr int K7_SYNC_MAX_L = 96;

__host__ __device__ inline bool k7_sync_core(int L) { return L <= K7_SYNC_MAX_L; }

// Its shared memory at L tokens: the head's int8 k rows [key][DH + 16] and
// [v | 1]'s v part transposed [dim][round32(L) + 16], keys rounded up to the
// 32 of an s8 k-step (the pads keep the eight rows a fragment load touches
// on distinct banks).
template <int DH>
__host__ __device__ constexpr int k8_ld() { return DH + 16; }
__host__ __device__ __forceinline__ int round32(int n) { return (n + 31) & ~31; }
__host__ __device__ __forceinline__ int v8_ld(int L) { return round32(L) + 16; }

template <int DH>
__host__ __device__ __forceinline__ size_t k7_sync_smem_bytes(int L) {
  return (size_t)round32(L) * k8_ld<DH>() + (size_t)DH * v8_ld(L);
}

// round(v * m) as an int8 level (|v * m| <= 127 by construction)
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

// One block per (frame b, head h), the function of attention_int8_kernel
// (below). The block quantizes k into shared memory [key][dim] (the B
// operand of Q K^T) and v transposed [dim][key'] (keys permuted in 32s,
// v8_col) for P V; each warp takes 16 query rows at a time, quantizes them
// in registers (a quad holds a row), and makes two passes over each tile's
// keys in 32s on the s8 tensor cores (mma.sync.m16n8k32): the row max, then
// the probabilities, whose s32 score fragments are repacked as P's A
// fragment in registers. With DUMP, its s32 scores, int8 probabilities and
// each tile's s32 [P V | den] go to device memory in attention_int8_kernel's
// layout.
template <int DH, bool DUMP>
__global__ void __launch_bounds__(K7_SYNC_WARPS * 32) attention_int8_sync_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out, int L, int D,
    int* __restrict__ s_dump, int8_t* __restrict__ p_dump, int* __restrict__ pv_dump) {
  static_assert(DH % 16 == 0, "head width must be a multiple of 16");
  constexpr int KC = DH < 32 ? 1 : DH / 32, KLD = k8_ld<DH>(), CH = DH / 8;
  extern __shared__ __align__(16) unsigned char k7s_raw[];
  __shared__ float red[2][K7_SYNC_WARPS];
  const int lp = round32(L), vld = v8_ld(L);
  int8_t* ks = reinterpret_cast<int8_t*>(k7s_raw);  // [lp][KLD]
  int8_t* vt = ks + (size_t)lp * KLD;               // [DH][vld]

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
  for (int w = 0; w < K7_SYNC_WARPS; ++w) {
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
  const long long ld_dump = (long long)K7_TILE * n_tiles;  // the dump's rows
  for (int r0 = warp * 16; r0 < L; r0 += K7_SYNC_WARPS * 16) {
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
                s_dump[(head * L + r) * ld_dump + key] = raw[nb][i];
                p_dump[(head * L + r) * ld_dump + key] = static_cast<int8_t>(p[nb][i]);
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

// K1's 3-D tensor map over qkv [B, L, 3D] in [DH][64-key] boxes, swizzled by
// the row width: a frame-head's k or v tile (K1's and K7's cores)
bool kv_tensor_map(CUtensorMap* map, const bf16* qkv, int B, int L, int D, int dh) {
  const uint64_t dims[3] = {(uint64_t)3 * D, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)3 * D, (uint64_t)3 * D * L};
  const uint32_t box[3] = {(uint32_t)dh, CORE_KT, 1};
  return make_map(map, qkv, 3, dims, strides, box, dh * 2);
}

template <int DH, bool NOEXP>
cudaError_t launch_core(const bf16* qkv, bf16* out, int B, int L, int D, int H,
                        long long out_frame_stride, cudaStream_t stream) {
  const size_t smem = core_smem_bytes(L, DH);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  CUtensorMap map;
  if (!kv_tensor_map(&map, qkv, B, L, D, DH)) return cudaErrorInvalidValue;
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

// K7's core: one block of one warpgroup a frame-head (blockIdx.x = b H + h),
// K1's map and K1's core's shared memory
template <int DH, bool DUMP>
cudaError_t launch_attention_int8(const bf16* qkv, bf16* out, int B, int L, int D, int H,
                                  int* s_dump, int8_t* p_dump, int* pv_dump,
                                  cudaStream_t stream) {
  const size_t smem = k7_smem_bytes(L, DH);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  CUtensorMap map;
  if (!kv_tensor_map(&map, qkv, B, L, D, DH)) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(attention_int8_kernel<DH, DUMP>, smem);
  if (err != cudaSuccess) return err;
  attention_int8_kernel<DH, DUMP><<<(unsigned)(B * H), 128, smem, stream>>>(
      map, qkv, out, L, D, H, s_dump, p_dump, pv_dump);
  ++launch_counts[kCountInt8Wgmma];
  return cudaSuccess;
}

// K7's core at short L: one block of four warps a frame-head (grid B x H)
template <int DH, bool DUMP>
cudaError_t launch_attention_int8_sync(const bf16* qkv, bf16* out, int B, int L, int D, int H,
                                       int* s_dump, int8_t* p_dump, int* pv_dump,
                                       cudaStream_t stream) {
  const size_t smem = k7_sync_smem_bytes<DH>(L);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(attention_int8_sync_kernel<DH, DUMP>, smem);
  if (err != cudaSuccess) return err;
  attention_int8_sync_kernel<DH, DUMP><<<dim3((unsigned)B, (unsigned)H), K7_SYNC_WARPS * 32,
                                         smem, stream>>>(qkv, out, L, D, s_dump, p_dump, pv_dump);
  ++launch_counts[kCountInt8Sync];
  return cudaSuccess;
}

template <int DH, bool DUMP>
cudaError_t launch_k7_core(bool sync, const bf16* qkv, bf16* out, int B, int L, int D, int H,
                           int* s_dump, int8_t* p_dump, int* pv_dump, cudaStream_t stream) {
  return sync ? launch_attention_int8_sync<DH, DUMP>(qkv, out, B, L, D, H, s_dump, p_dump,
                                                     pv_dump, stream)
              : launch_attention_int8<DH, DUMP>(qkv, out, B, L, D, H, s_dump, p_dump, pv_dump,
                                                stream);
}

// K7's attention core: attention_int8_sync_kernel where k7_sync_core(L)
// holds, else attention_int8_kernel (`core` 1 or 2 takes the wgmma or the
// mma.sync core at any L, for the checks and timings of the two); with the
// dump pointers set, the variant that also writes its s32 scores, int8
// probabilities and s32 tile products.
cudaError_t attention_int8(const bf16* qkv, bf16* out, int B, int L, int D, int H,
                           int* s_dump, int8_t* p_dump, int* pv_dump, cudaStream_t stream,
                           int core = 0) {
  const bool dump = s_dump != nullptr, sync = core == 0 ? k7_sync_core(L) : core == 2;
  switch (D / H) {
    case 16:
      return dump ? launch_k7_core<16, true>(sync, qkv, out, B, L, D, H, s_dump, p_dump, pv_dump, stream)
                  : launch_k7_core<16, false>(sync, qkv, out, B, L, D, H, nullptr, nullptr, nullptr, stream);
    case 32:
      return dump ? launch_k7_core<32, true>(sync, qkv, out, B, L, D, H, s_dump, p_dump, pv_dump, stream)
                  : launch_k7_core<32, false>(sync, qkv, out, B, L, D, H, nullptr, nullptr, nullptr, stream);
    case 64:
      return dump ? launch_k7_core<64, true>(sync, qkv, out, B, L, D, H, s_dump, p_dump, pv_dump, stream)
                  : launch_k7_core<64, false>(sync, qkv, out, B, L, D, H, nullptr, nullptr, nullptr, stream);
  }
  return cudaErrorInvalidValue;
}

// K2's pooling stage: one block of POOL_WARPS warps a frame group, as many
// blocks as fill the SMs once (each warp then walks its frames)
template <int D, int NHB>
cudaError_t launch_cls_pool(const bf16* x, const bf16* qt, bf16* xbar, int B, int L, int H,
                            cudaStream_t stream) {
  const size_t smem = pool_smem_bytes(D, NHB);
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)D, (uint64_t)D * L};
  const uint32_t box[3] = {64, POOL_STEP, 1};
  CUtensorMap map;
  if (!make_map(&map, x, 3, dims, strides, box, 128)) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(cls_pool_kernel<D, NHB>, smem);
  if (err != cudaSuccess) return err;
  static int per_sm = 0;
  if (!per_sm)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cls_pool_kernel<D, NHB>,
                                                  POOL_WARPS * 32, smem);
  const long long want = ((long long)B + POOL_WARPS - 1) / POOL_WARPS;
  const long long fill = (long long)(per_sm < 1 ? 1 : per_sm) * sm_count();
  cls_pool_kernel<D, NHB><<<(unsigned)(want < fill ? want : fill), POOL_WARPS * 32, smem,
                            stream>>>(map, qt, xbar, B, L, H);
  ++launch_counts[kCountClsPool];
  return cudaSuccess;
}

// xbar [B, H, D] from x [B, L, D] and qt [B, H, D] (cls_pool_kernel): one
// head block of 8 up to H = 8, two at d_model 256 with d_head 16
cudaError_t cls_pool(const bf16* x, const bf16* qt, bf16* xbar, int B, int L, int D, int H,
                     cudaStream_t stream) {
  switch (D) {
    case 64: return launch_cls_pool<64, 1>(x, qt, xbar, B, L, H, stream);
    case 128: return launch_cls_pool<128, 1>(x, qt, xbar, B, L, H, stream);
    case 256:
      return H > 8 ? launch_cls_pool<256, 2>(x, qt, xbar, B, L, H, stream)
                   : launch_cls_pool<256, 1>(x, qt, xbar, B, L, H, stream);
  }
  return cudaErrorInvalidValue;
}

// The shapes K1, K2, K6 and K7 take (fused_encoder_layer.fused_infer_supported
// is the same predicate): D 64, 128 or 256; d_head 16, 32 or 64; an FFN width
// that is a multiple of 128; and an L within the gate's shared-memory bound
// (gate_smem_bytes).
bool shapes_ok(int B, int L, int D, int H, int F) {
  if (B <= 0 || L <= 0 || H <= 0 || D % H) return false;
  if (D != 64 && D != 128 && D != 256) return false;
  const int dh = D / H;
  if (dh != 16 && dh != 32 && dh != 64) return false;
  return F > 0 && F % 128 == 0 && gate_smem_bytes(L, dh) <= (size_t)MAX_SMEM;
}

// Returns from the enclosing entry with a launch's error (`err` in scope).
#define VITIQ_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err

// The attention core of a layer: K1's (exp2 softmax), P3's (K1's without the
// exp) or K7's (int8).
enum class Core { kExp2, kNoExp, kInt8 };

// The layer's tail for R rows (attn [R, D]): out-projection + bias +
// residual (rows x_ld apart in x) + LN1 -> x1; FFN1 + ReLU -> hid; FFN2 +
// bias + residual + LN2 -> out.
cudaError_t layer_tail(const bf16* attn, const bf16* x, long long x_ld, bf16* x1, bf16* hid,
                       void* out, const void* wo, const void* bo, const void* g1,
                       const void* be1, const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* g2, const void* be2, long long rows, int D,
                       int F, cudaStream_t s) {
  cudaError_t err = launch_gemm<kBiasResidualLN>(
      with_ln(gemm_args(attn, D, static_cast<const bf16*>(wo), D, static_cast<const float*>(bo),
                        x1, D, rows, D, 0),
              x, x_ld, static_cast<const float*>(g1), static_cast<const float*>(be1)),
      D, s);
  if (err != cudaSuccess) return err;
  GemmArgs ffn1 = gemm_args(x1, D, static_cast<const bf16*>(w1), F,
                            static_cast<const float*>(b1), hid, F, rows, D, 0);
  ffn1.relu = 1;
  if ((err = launch_gemm<kBias>(ffn1, F, s)) != cudaSuccess) return err;
  return launch_gemm<kBiasResidualLN>(
      with_ln(gemm_args(hid, F, static_cast<const bf16*>(w2), D, static_cast<const float*>(b2),
                        static_cast<bf16*>(out), D, rows, F, 0),
              x1, D, static_cast<const float*>(g2), static_cast<const float*>(be2)),
      D, s);
}

// One full layer, every query row (K1, P3 with Core::kNoExp, K7 with
// Core::kInt8). x, out: [B, L, D]. Scratch: qkv [B, L, 3D]; attn and x1
// [B, L, D] and hid [B, L, F]. Weights: wqkv [D, 3D] with its q columns
// pre-scaled by log2(e)/sqrt(dh), wo [D, D], w1 [D, F], w2 [F, D] in bf16;
// biases and LN parameters f32. Returns the first launch error or
// cudaGetLastError().
int encoder_layer(Core core, const void* x, void* out, void* qkv, void* attn, void* x1,
                  void* hid, const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                  const void* g1, const void* be1, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* g2, const void* be2, int B, int L,
                  int D, int H, int F, void* stream_ptr) {
  if (!shapes_ok(B, L, D, H, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* attnb = static_cast<bf16*>(attn);
  const long long M = (long long)B * L, frame = (long long)L * D;
  cudaError_t err;
  VITIQ_TRY(launch_gemm<kBias>(gemm_args(xb, D, static_cast<const bf16*>(wqkv), 3 * D,
                                         static_cast<const float*>(bqkv), qkvb, 3 * D, M, D, 0),
                               3 * D, s));
  if (core == Core::kInt8) {
    VITIQ_TRY(attention_int8(qkvb, attnb, B, L, D, H, nullptr, nullptr, nullptr, s));
  } else if (core == Core::kNoExp) {
    VITIQ_TRY(attention_core<true>(qkvb, attnb, B, L, D, H, frame, s));
  } else {
    VITIQ_TRY(attention_core<false>(qkvb, attnb, B, L, D, H, frame, s));
  }
  VITIQ_TRY(layer_tail(attnb, xb, D, static_cast<bf16*>(x1), static_cast<bf16*>(hid), out, wo,
                       bo, g1, be1, w1, b1, w2, b2, g2, be2, M, D, F, s));
  return (int)cudaGetLastError();
}

// K2: the layer for row 0 (the CLS token) of each frame, x [B, L, D] ->
// out [B, 1, D], with no K or V formed (see cls_pool_kernel):
//   q = bf16(x_0 Wq + b_q)                 q stage: A rows a frame apart
//   qt = bf16(q Kblk)                      [B, H D]: Kblk [D, H D] holds
//                                          W_k,h^T in block (h, h), zeros
//                                          elsewhere (kzero: its zero bias)
//   xbar = cls_pool(x, qt)                 [B, H, D]
//   attn = bf16(xbar Vblk + b_v)           Vblk [H D, D] holds W_v,h in
//                                          block (h, h)
//   then the tail (layer_tail) on the B rows, residual x_0.
// Seven launches. Scratch: q, attn, x1 [B, D]; qt, xbar [B, H D]; hid
// [B, F]. Rounding: qt and xbar are rounded to bf16 where the TPU kernel
// rounds k and v (an error of the same size).
int encoder_layer_cls(const void* x, void* out, void* q, void* qt, void* xbar, void* attn,
                      void* x1, void* hid, const void* wqkv, const void* bqkv, const void* wo,
                      const void* bo, const void* g1, const void* be1, const void* w1,
                      const void* b1, const void* w2, const void* b2, const void* g2,
                      const void* be2, const void* kblk, const void* vblk, const void* kzero,
                      int B, int L, int D, int H, int F, void* stream_ptr) {
  if (!shapes_ok(B, L, D, H, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* b_qkv = static_cast<const float*>(bqkv);
  bf16 *qb = static_cast<bf16*>(q), *qtb = static_cast<bf16*>(qt);
  bf16 *xbarb = static_cast<bf16*>(xbar), *attnb = static_cast<bf16*>(attn);
  const long long frame = (long long)L * D;
  const int HD = H * D;
  cudaError_t err;
  VITIQ_TRY(launch_gemm<kBias>(
      gemm_args(xb, frame, static_cast<const bf16*>(wqkv), 3 * D, b_qkv, qb, D, B, D, 0), D, s));
  VITIQ_TRY(launch_gemm<kBias>(gemm_args(qb, D, static_cast<const bf16*>(kblk), HD,
                                         static_cast<const float*>(kzero), qtb, HD, B, D, 0),
                               HD, s));
  VITIQ_TRY(cls_pool(xb, qtb, xbarb, B, L, D, H, s));
  VITIQ_TRY(launch_gemm<kBias>(
      gemm_args(xbarb, HD, static_cast<const bf16*>(vblk), D, b_qkv + 2 * D, attnb, D, B, HD, 0),
      D, s));
  VITIQ_TRY(layer_tail(attnb, xb, frame, static_cast<bf16*>(x1), static_cast<bf16*>(hid), out, wo,
                       bo, g1, be1, w1, b1, w2, b2, g2, be2, B, D, F, s));
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
  return encoder_layer(Core::kExp2, x, out, qkv, attn, x1, hid, wqkv, bqkv, wo, bo, g1, be1,
                       w1, b1, w2, b2, g2, be2, B, L, D, H, F, stream_ptr);
}

// K2: the layer for query row 0 only (see encoder_layer_cls).
extern "C" int vitiq_encoder_layer_cls(
    const void* x, void* out, void* q, void* qt, void* xbar, void* attn, void* x1, void* hid,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* g1, const void* be1, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* g2, const void* be2,
    const void* kblk, const void* vblk, const void* kzero,
    int B, int L, int D, int H, int F, void* stream_ptr) {
  return encoder_layer_cls(x, out, q, qt, xbar, attn, x1, hid, wqkv, bqkv, wo, bo, g1, be1, w1,
                           b1, w2, b2, g2, be2, kblk, vblk, kzero, B, L, D, H, F, stream_ptr);
}

// K2's pooling stage alone (cls_pool_kernel): x [B, L, D] and qt [B, H, D]
// bf16 -> xbar [B, H, D] bf16, to hold it to its plain version. Takes K2's
// shapes (F is not read).
extern "C" int vitiq_cls_pool(const void* x, const void* qt, void* xbar, int B, int L, int D,
                              int H, void* stream_ptr) {
  if (!shapes_ok(B, L, D, H, 128)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cls_pool(static_cast<const bf16*>(x), static_cast<const bf16*>(qt),
                                   static_cast<bf16*>(xbar), B, L, D, H,
                                   static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K7: one full layer with the int8 attention core (see encoder_layer and
// attention_int8_kernel).
extern "C" int vitiq_encoder_layer_attn_int8_full(
    const void* x, void* out, void* qkv, void* attn, void* x1, void* hid,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* g1, const void* be1, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* g2, const void* be2,
    int B, int L, int D, int H, int F, void* stream_ptr) {
  return encoder_layer(Core::kInt8, x, out, qkv, attn, x1, hid, wqkv, bqkv, wo, bo, g1, be1,
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
  return encoder_layer(Core::kNoExp, x, out, qkv, attn, x1, hid, wqkv, bqkv, wo, bo, g1,
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
// with s_dump non-null, also its s32 scores s_dump [B, H, L, Lp], int8
// probabilities p_dump [B, H, L, Lp] (Lp = 128 ceil(L / 128): the keys
// past L are not the function's) and s32 tile products pv_dump
// [B, H, ceil(L / 128), L, D / H + 1] (for the bit-for-bit check of its
// products against the plain version). `core` 0 takes the layer's route
// (k7_sync_core), 1 the wgmma core, 2 the mma.sync core. Takes K7's shapes
// (F is not read).
extern "C" int vitiq_attention_int8(const void* qkv, void* out, void* s_dump, void* p_dump,
                                    void* pv_dump, int B, int L, int D, int H, int core,
                                    void* stream_ptr) {
  if (!shapes_ok(B, L, D, H, 128) || core < 0 || core > 2) return (int)cudaErrorInvalidValue;
  const cudaError_t err = attention_int8(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), B, L, D, H,
      static_cast<int*>(s_dump), static_cast<int8_t*>(p_dump), static_cast<int*>(pv_dump),
      static_cast<cudaStream_t>(stream_ptr), core);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launches of cls_pool_kernel, attention_int8_kernel and
// attention_int8_sync_kernel since the last reset, into out[3]; with
// `reset`, the counts then start again from 0.
extern "C" int vitiq_kernel_launches(unsigned long long* out, int reset) {
  for (int i = 0; i < kCounted; ++i) {
    if (out) out[i] = launch_counts[i];
    if (reset) launch_counts[i] = 0;
  }
  return 0;
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
