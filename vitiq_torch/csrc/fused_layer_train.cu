// Fused post-norm encoder layer for TRAINING on Hopper (sm_90a): K3, the
// forward and the recompute backward, and K4, the stash forward and the
// stash backward.
//
// Replaces (TPU Pallas kernels of the JAX reference package):
//   K3-fwd  vitiq/ops/pallas/fused_layer_train.py: _fwd_kernel (pallas_call in
//           _run_fwd), the training layer with in-kernel dropout
//   K3-bwd  vitiq/ops/pallas/fused_layer_train.py: _bwd_kernel in its
//           recompute regime (pallas_call in _fused_train_layer_bwd): dx and
//           all 12 weight, bias and LN gradients
//   K4-fwd  vitiq/ops/pallas/fused_layer_train.py: _fwd_kernel_stash (pallas_call
//           in _run_fwd with the stash on); _fwd_kernel_stash_xpack and
//           _fwd_kernel_stash_stacked are TPU schedules of the same function
//   K4-bwd  vitiq/ops/pallas/fused_layer_train.py: _bwd_kernel with stash=True
//           (and _bwd_kernel_stacked, its layers-per-call schedule)
//
// Function, per layer, on a bf16 [B, L, D] activation (D = 64, 128 or 256,
// d_head 16, 32 or 64, an FFN width that is a multiple of 64; shapes_ok, and
// fused_layer_train.fused_train_supported in the wrapper, say which shapes the
// kernels take):
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
// K3 backward (recompute regime: the forward saves only x, the seed and the
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
// K4 (stash regime). K4-fwd is K3-fwd (the same y) that also writes the
// stash: attn [B, L, D], LN1's and LN2's normalized inputs xh1, xh2 [B, L, D]
// in bf16 (the TPU kernel stores them in x's dtype), their 1/std r1, r2
// [B, L] f32, and pbar = bf16(bf16(exp2(s - max)) / l) [B, H, L,
// stash_cols(L)] (the port's layout, rows padded with zeros to 8 elements;
// the TPU kernel packs [B, Lp, H*Lp]). K4-bwd runs no
// attention, out-projection+LN1 or FFN2+LN2 recompute; it rebuilds what the
// TPU stash backward rebuilds, at the same rounding points: qkv =
// bf16(x Wqkv + bqkv), x1 = bf16(f32(xh1) g1 + be1), h = bf16(relu(x1 W1 + b1)
// m2). The LN backwards read the stashed bf16 xh widened to f32; then come
// K3's gradient stages, except that the attention backward reads pbar from
// the stash instead of recomputing Q K^T and exp2.
//
// Design: one __global__ launch per stage, on the caller's stream.
//   train_gemm_kernel<EPI, BN, RESIDENT>
//                          the GEMM stages: persistent wgmma blocks fed by TMA,
//                          the main loop K1's stages share (gemm_wgmma.cuh),
//                          with K3's epilogues in registers on the wgmma
//                          accumulator layout. The forward stages take W [K,
//                          N] as an MN-major B; the input-gradient stages B =
//                          W^T, K-major, read from W [N, K] as stored; the
//                          weight gradients A = act^T, MN-major, read from act
//                          [B*L, K1], split over the rows into f32 partials
//                          (the persistent grid walks (output tile, split)
//                          items). W stays resident where K <= 256 (not for
//                          the 256-wide LayerNorm stages: K1's resident
//                          instance of that width spilled beside its 128
//                          accumulators), else streams through the ring.
//                          The accumulators start from what is added before
//                          the product (bias; the f32 residual of the LN1
//                          backward and of dx). Epilogues (Epi): bias, ReLU
//                          and the dropout mask, LayerNorm forward (BN = D: the
//                          row lies in one quad; xh f32 or bf16 and 1/std
//                          out) or backward (dz f32 and bf16(dz m) out), and
//                          the column sums of the bias and LN gradients, per
//                          64-row tile: shuffles over a warp's row groups,
//                          then the four warps in shared memory, in a fixed
//                          order. The mask's (frame, token) is found once per
//                          accumulator row, each column hashed as the plain
//                          version hashes it (FFN2's input gradient needs no
//                          hash: where h > 0 its mask is the keep scale).
//                          The bf16 row operands of the LN forward and FFN2
//                          input-gradient epilogues (residual, h) are asked
//                          into L2 when a tile starts, and the epilogues'
//                          loads carry no branch, so that they go out
//                          together.
//   wg_recompute_attention_fwd<DH, NG>, wg_recompute_attention_bwd<DH, NG>
//                          K3's two attention passes on wgmma (below), where
//                          round16(L) <= 144: every shape K3 trains, but the
//                          ViT flagship's forward (d_head 16, 129 tokens)
//   train_attention_fwd    K3's forward past that (round16(L) > 144, and d_head
//                          16 past 80 keys): one block per (frame, head), K1's
//                          register-fragment core (mma.sync), q scaled in the
//                          kernel, optionally writing each row's max and sum
//                          for the backward's recompute
//   train_attention_bwd    K3's backward past 144 keys: one block per (frame,
//                          head), a query-major pass (dQ) and a key-major pass
//                          (dK, dV), holding q, k, v, dO and their transposes
//                          in shared memory and recomputing P in mma.sync
//                          fragments in both passes (146,112 bytes at d_head
//                          64, L = 129); each pass parks its column sums in
//                          shared memory when it ends. Its shared memory is
//                          still K3's shape gate (shapes_ok: L up to 224 at
//                          d_head 64)
//   wg_attention_fwd<DH, NG>, wg_attention_bwd_stash<DH, NG, RESIDENT>
//                          K4's two attention passes on wgmma (below)
//   ln_bwd_rows<XH, DW>    LN2 backward, one warp per row of DW = D columns
//                          (64, 128 or 256), xh f32 or bf16
//   rebuild_ln_out         K4's x1 = bf16(f32(xh1) g1 + be1)
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
// backward most of all. The stages keep them in device memory (each stage
// reads its inputs once and writes its outputs once: PERF.md's staged byte
// floor); fusing the FFN hidden is later work.
// K4 trades the recompute for stash bytes. At the rawIQ flagship shape (L =
// 65, F = 1024, H = 8) the stash is 125,320 bytes per frame and layer (pbar
// 74,880 of it, its rows padded from 65 to 72 elements; 118,040 unpadded):
// K4-fwd writes it once; K4-bwd reads it, pbar once. The recompute it saves
// is the attention forward (score and PV products), the out-projection and
// FFN2 GEMMs with their LN epilogues: ~21 MFLOP and ~0.34 MB of device-
// memory traffic per frame (the FFN hidden read back is most of it). K4-bwd
// keeps the QKV and FFN1 GEMMs. So K4 moves about as many bytes as K3 and
// saves its FLOPs and launches; the stash is ~0.5 GB a layer at B = 4096,
// held from the forward to the backward.
//
// K4's attention passes (in place of mma.sync passes, one block and four
// independent warps a frame-head, that formed pbar in a third pass). Both
// are bound by bytes: at the rawIQ shape, B = 4096, the forward reads qkv
// and writes attn and pbar (549.5 MB, 0.164 ms at 3.35 TB/s), the backward
// reads qkv, attn, dattn and pbar and writes dqkv (822 MB, 0.247 ms),
// against under a tenth of that in tensor FLOPs; so each moves every byte
// once, as tiles, and keeps everything else on chip. Blocks of one warpgroup (128 threads);
// every product is a wgmma on a 64-row tile whose B operand (and, for dV and
// dK, A operand) TMA has put in shared memory, swizzled by its row width.
//   wg_attention_fwd<DH, NG> (K4-fwd): persistent blocks, the SMs' worth,
//     each walking frame-heads with q, k and v arriving by TMA into one of
//     two buffers while the other is computed. Per 64-query tile the scores
//     of all keys stay in registers as NG groups of 16 keys (m64n16, NG = 2,
//     4 or 5: round16(L) <= 80), so the row max, p = bf16(exp2(s - m))
//     (MUFU.EX2) and l come from one product and pbar = bf16(p / l) from the
//     kept p: two passes over the scores in registers, not three over the
//     keys. P is packed from the accumulators into the A fragments of P V.
//     pbar goes to a staging tile in shared memory, [rows][64 keys] chunks
//     in TMA's 128-byte swizzle (a warp's 4-byte writes fall on 32 distinct
//     banks), and leaves by one TMA store per chunk when the frame-head
//     ends. Quotients are IEEE's without a divide (quant_div,
//     gemm_wgmma.cuh, from y = RN(1 / l)); pbar takes the product p y, which
//     rounds to the same bf16 unless it lies within 3 ulps of a bf16
//     midpoint (about one product in 10^4), where its warp takes the
//     quotients instead. Past 80 keys
//     (only where VITIQ_TRAIN_STASH=1 admits such an L) the scores are formed
//     twice in 64-key tiles, p staged per query tile and divided by l in
//     place once l is whole. K3 has its own passes (below): with its row
//     stats in place of pbar this forward measured slower at K3's shapes (ViT,
//     129 tokens: three 64-row query tiles, the last with one live row).
//   wg_attention_bwd_stash<DH, NG, RESIDENT> (K4-bwd): one block a
//     frame-head. q (scaled in place), k, v and dO rows and, resident
//     (round16(L) <= 80: NG = 2, 4 or 5, every shape K4 trains), the whole
//     pbar plane arrive by TMA. dV = pbar^T dO per 64-key chunk, pbar^T read
//     straight from the plane as an MN-major A (the transpose bit); then per
//     64-query tile dP = dO V^T (dO's A fragments from shared memory, the row
//     term dO . O from them and O's), dS = bf16(pbar (dP - row)) written over
//     pbar in the plane, dQ = dS K with dS packed into the A fragments; then
//     dK = dS^T Qs from the plane, MN-major A again. pbar is read once, as
//     tiles. Streamed (L > 80), one [64][64] pbar tile at a time: dQ per
//     query tile, then per key tile dP and dS again into a dS tile for dV and
//     dK. (Persistent double-buffered blocks, as the forward's, measured
//     slower here: twice the shared memory a block, half the blocks an SM.)
//   Idle rows: M = 64, so at L = 65 the second query tile holds one live row
//   (its other three warps skip the softmax and dS work but issue the
//   wgmma): the passes form 128 query rows for 65 (49% idle in the
//   products, 19% of the elementwise work, whose unit is a warp's 16 rows);
//   the 80 key columns of NG = 5 hold 65 keys (19% idle). pbar's layout is
//   the port's: [B, H, L, stash_cols(L)], rows padded with zeros to a
//   multiple of 8 elements, so that every row starts 16-byte aligned for TMA
//   (the TPU kernel packs [B, Lp, H Lp]); the backward's map spans L
//   columns, so the padding is never read.
//   Registers (ptxas, NVIDIA H100 80GB HBM3 build): the forward at d_head
//   16 / 32 / 64, NG 2: 75 / 92 / 120, NG 4: 101 / 128 / 134, NG 5: 128 / 140
//   / 168, so 4 blocks an SM at the rawIQ shape (d_head 16, NG 5); the
//   resident backward NG 2: 48 / 52 / 72, NG 4: 62 / 66 / 90, NG 5: 72 / 76
//   / 119 (6 blocks an SM at the rawIQ shape, by its 32.5 KB of shared
//   memory), streamed 98 / 124 / 179. None spills.
//
// K3's attention passes (in place of the mma.sync passes, which formed each
// score and exp2 twice in the backward, and twice in the forward). Both are
// bound by bytes: at the ViT flagship's shape, B = 4096, the forward reads
// qkv and writes attn and each row's f32 (m, l) (575 MB, 0.172 ms at 3.35
// TB/s), the backward reads qkv, attn, dattn and the stats and writes dqkv
// and the frames' column sums (1.12 GB, 0.335 ms); the tensor FLOPs are a
// tenth of that. They are latency-bound on the card: one warpgroup's chain
// of products, exp2 and quotients a tile, so what a pass gains comes from
// the warps an SM holds. The routing is by shape alone (recompute_wgmma,
// recompute_fwd_wgmma), in attention_fwd and attention_bwd:
//   wg_recompute_attention_fwd<DH, NG> (K3-fwd, K3-bwd's recompute):
//     wg_attention_fwd's persistent blocks with q, k, v by TMA in two
//     buffers; the scores of a 64-query tile over all 16 NG keys (NG = 2,
//     4, 5 or 9, the least that covers round16(L) <= 144) in registers, the
//     row max, p (MUFU.EX2) into P V's A fragments, l; attn = bf16(O / l)
//     without a divide; (m, l) to the stats. At d_head 16 and NG 9 (the ViT
//     flagship) train_attention_fwd measured faster (rc_fwd_built), so that
//     shape keeps it and <16, 9> is not built.
//   wg_recompute_attention_bwd<DH, NG> (K3-bwd): K4's resident backward with
//     its pbar plane formed in the kernel, not loaded: per 64-query tile S =
//     Qs K^T (one wgmma a group) and pbar = bf16(bf16(exp2(s - m)) / l) from
//     the forward's stats (MUFU.EX2, IEEE quotients from div_pair) into the
//     128-byte-swizzled plane [16 NG queries][64-key chunks], rows and keys
//     >= L 0; then K4's sequence (dV = pbar^T dO with the plane as MN-major
//     A; dP, dS over pbar, dQ per query tile; dK = dS^T Qs). Each score
//     costs one product and one exp2, where it cost two of each (the TPU's
//     VITIQ_TRAIN_PB=reuse). The row terms dO . O are formed once from
//     16-byte loads of O. Scores and dP of up to 4 groups are one wgmma a
//     k-step (times_rows_t_wide: m64n32 to m64n64, m64n48 at NG 9). One
//     block a frame-head; at NG 9 past d_head 16 three warpgroups (384
//     threads), each taking 3 of a query tile's 9 key groups and a key
//     chunk of dV and dK, the dQ partials added through shared memory in
//     warpgroup order: one warpgroup held vit_tpu_production's block (133
//     KB) to 4 warps an SM. Column sums in a fixed order, no atomics. Shared
//     memory at 129 tokens: 76,112 bytes at d_head 16 (one warpgroup, 3
//     blocks an SM), 172,624 at 64 (1); at rawiq_best's 65 tokens (d_head
//     32) 43,856 (5).
//   Registers (ptxas, NVIDIA H100 80GB HBM3 build; none spills): see
//   PERF.md §6, printed by chip_smoke.py's build phase.
//
// TPU schedule knobs of K3 and K4 and what computes each here (all are the
// same function):
//   VITIQ_TRAIN_STASH (K4 on / off / auto)  -> the wrapper's stash_enabled
//       routes each layer to K4 or K3, with the TPU gate unchanged.
//   VITIQ_TRAIN_FWD (xpack / chain stash forward)
//                                           -> wg_attention_fwd; the packed
//       [B, Lp, H*Lp] probability layout has no counterpart, pbar is [B, H,
//       L, stash_cols(L)].
//   VITIQ_TRAIN_PB (recompute / reuse the probability tiles)
//                          -> K3: wg_recompute_attention_bwd forms pbar once
//                             into its plane and reuses it for dV and dS
//                             (the TPU's reuse; past 144 keys
//                             train_attention_bwd recomputes P in both of its
//                             passes); K4: wg_attention_bwd_stash reads pbar.
//   VITIQ_TRAIN_EPI (wide / head divide)    -> one f32 divide per output.
//   VITIQ_TRAIN_ATTN (xpack / auto: K8, train_xpack.py:
//       fused_train_layer_stack_xpack, _fwd_kernel_x and _bwd_kernel_x: the
//       packed attention forward and the hybrid packed-recompute backward)
//                                           -> K3's attention passes, routed
//       by shape (wg_recompute_attention_fwd / _bwd, else train_attention_fwd
//       / _bwd); K8's dropout hash is the one these kernels draw
//       (tests/test_torch_train_layer.py holds K8 in interpret mode to K3's
//       plain versions).
//   VITIQ_TRAIN_DW (merged / batched dW)    -> one split-K GEMM over all rows.
//   VITIQ_TRAIN_DWPACK (0 / p1 / full)      -> four separate dW GEMMs, in
//       both regimes.
//   VITIQ_TRAIN_FPA, _FPG, _FPV, _ATTNBWD   -> wg_recompute_attention_bwd
//       (K3; train_attention_bwd past 144 keys) and wg_attention_bwd_stash
//       (K4): heads are independent blocks, so neither the full-product
//       packing of heads nor the block-diagonal scratch nor the per-head
//       chain has a counterpart; pbar is formed once (or read) per 64-query
//       tile into a plane that dS overwrites.
//   VITIQ_TRAIN_RFWD, _RBWD (xpack cores)   -> K3's attention passes, routed
//       by shape as VITIQ_TRAIN_ATTN's.
//   VITIQ_TRAIN_TAIL (VPU tail keys)        -> keys are masked per 8-key
//       fragment column; activations stay [B, L, D] unpadded. The stash gate
//       still turns K4 off where the TPU's tail mode would be on.
//   VITIQ_TRAIN_LPC (layers per call: _fused_train_chunk,
//       _fwd_kernel_stash_stacked, _bwd_kernel_stacked), VITIQ_TRAIN_G
//       (frames per block)                  -> one host call per layer; the
//       GEMMs tile B*L rows, attention is one block per frame and head.
//   VITIQ_TRAIN_PROBE                       -> timing-only surgery; none.

#include <algorithm>
#include <type_traits>

#include "attention_core.cuh"
#include "common.cuh"
#include "gemm_wgmma.cuh"
#include "hopper.cuh"

namespace {

constexpr int ROW_TILE = 64;  // rows of a column-sum partial (a warpgroup's tile)
constexpr int THREADS = 256;  // the row kernels' blocks (ln_bwd_rows, reduce_rows)
constexpr int FFN_MULTIPLE = 64;  // the narrowest GEMM slab
constexpr int ATTN_WARPS = 4;
constexpr int MAX_SMEM = 232448;  // shared memory a block may use on Hopper
constexpr float LN_EPS = 1e-12f;

// ---------------------------------------------------------------------------
// dropout: keep/(1-rate) from a stateless hash of the absolute position
// ---------------------------------------------------------------------------

// The step's seed is read from device memory, not passed by value, so that a
// CUDA graph captured over train steps draws each replayed step's masks from
// the seed the step itself computed there.
struct Drop {
  const int* seed;     // the step's int32 seed (device memory)
  uint32_t salt;       // the (layer, site) salt
  uint32_t thresh;     // dropped iff (hash & 0x7fffffff) < thresh
  float scale;         // 1 / (1 - rate)
  int L;               // tokens per frame: row r is frame r / L, token r % L
  int on;
};

// _hash_mask of train_xpack.py is murmur3's fmix32 over (b C1) ^ (l C2) ^
// (w C3) + seed + salt for frame b, token l, lane w. row_mix is a row's part
// (b C1) ^ (l C2), found once per row; seed_salt loads the seed and adds the
// salt: once per block in the row kernels and in kLnBwd's GEMM stages (into
// shared memory: see ln_bwd_epilogue), once per tile's epilogue in the other
// GEMM stages that hash (a value held across the main loop would cost the
// 256-wide stages a register they lack); keep_of finishes the hash of one
// lane.
__device__ __forceinline__ uint32_t row_mix(const Drop& d, long long row) {
  const long long b = row / d.L;
  const uint32_t l = (uint32_t)(row - b * d.L);
  return ((uint32_t)b * 0x9E3779B1u) ^ (l * 0x85EBCA77u);
}

__device__ __forceinline__ uint32_t seed_salt(const Drop& d) {
  return (uint32_t)__ldg(d.seed) + d.salt;
}

__device__ __forceinline__ float keep_of(const Drop& d, uint32_t ss, uint32_t mix, int col) {
  uint32_t h = (mix ^ ((uint32_t)col * 0xC2B2AE3Du)) + ss;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (h & 0x7fffffffu) >= d.thresh ? d.scale : 0.f;
}

// ---------------------------------------------------------------------------
// GEMM stages: the shared wgmma main loop with K3's epilogues
// ---------------------------------------------------------------------------

enum Epi {
  kBias = 0,       // out = bf16(acc + bias)
  kReluDrop = 1,   // out = bf16(relu(acc + bias) * mask)
  kLnFwd = 2,      // z = (acc + bias) * mask + res; out = bf16(LN(z)); xh (f32 or
                   // bf16), 1/std
  kStore = 3,      // out = bf16(acc)
  kDpre = 4,       // d = h > 0 ? acc * mask : 0; out = bf16(d); column sums of d
  kLnBwd = 5,      // g = acc + res32; dz = LN backward of g; out32 = dz;
                   // out = bf16(dz * mask); column sums of g*xh, g, dz*mask
  kResOut = 6,     // out = bf16(acc + res32)
  kPartial = 7,    // out32[split] = acc (split-K partial of a weight gradient)
};

// The operand forms of each epilogue's stage: A = act^T (MN-major) for the
// weight gradients, B = W^T (K-major, W [N, K] as stored) for the input
// gradients, else A rows and W [K, N].
__host__ __device__ constexpr int a_transposed(int epi) { return epi == kPartial; }
__host__ __device__ constexpr int b_mn_major(int epi) {
  return epi == kBias || epi == kReluDrop || epi == kLnFwd || epi == kPartial;
}
__host__ __device__ constexpr bool is_ln(int epi) { return epi == kLnFwd || epi == kLnBwd; }
// shared memory an epilogue adds to the main loop's: bias, gamma, beta of the
// slab (f32), and the column sums' scratch [warpgroup][sum][warp][BN]
__host__ __device__ constexpr int col_sums(int epi) {
  return epi == kLnBwd ? 3 : epi == kDpre ? 1 : 0;
}
__host__ __device__ constexpr int stage_extra(int epi, int bn) {
  return 3 * bn * 4 + 2 * col_sums(epi) * 4 * bn * 4;
}

struct Stage {
  const bf16* a;  // A rows: row r at a + r*lda (K-major); with a_transposed, act
  long long lda;  //   [depth][lda], whose columns are the output rows
  const bf16* b;  // W [K, N] or the gradient [depth][N] (MN-major); W [N, K]
  long long ldb;  //   (K-major); rows ldb apart
  long long m;      // output rows
  int k;            // depth of one work item (a multiple of 64)
  long long depth;  // the weight gradients' whole depth (rows of act and of
  int splits;       //   the gradient) and its splits of k rows; 1 elsewhere
  int n_tiles;      // BN-wide slabs (the launcher sets it)
  long long ldo;    // row stride of every [row][column] operand of the epilogue
  const float* bias;
  bf16* out;
  float* out32;
  const bf16* res;     // kLnFwd: bf16 residual; kDpre: the FFN hidden h
  const float* res32;  // kLnBwd, kResOut: f32 residual
  const float* xh;     // kLnBwd: LN's normalized input (f32), or
  const bf16* xh16;    //   the same in bf16 (K4's stash)
  const float* rstd;   // kLnBwd: LN's 1/std per row
  float* xh_out;       // kLnFwd (may be null)
  bf16* xh_out16;      // kLnFwd: xh in bf16 (may be null)
  float* rstd_out;     // kLnFwd (may be null)
  const float* gamma;
  const float* beta;
  float* part;         // column partial sums [sum][64-row tile][ldo]
  Drop drop;
};

// A pair of a row operand (f32 or bf16) at offset `at`, widened to f32:
// read unconditionally (a row past m reads row 0, and its pair is zero) so
// that the compiler can issue an epilogue's loads together instead of one
// branch, and one wait, at a time.
__device__ __forceinline__ float2 ld_pair(const float* base, long long at, bool in) {
  const float2 v = *reinterpret_cast<const float2*>(base + at);
  return in ? v : make_float2(0.f, 0.f);
}
__device__ __forceinline__ float2 ld_pair(const bf16* base, long long at, bool in) {
  const uint32_t word = ld_b32(base + at);
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&word));
  return in ? v : make_float2(0.f, 0.f);
}

__device__ __forceinline__ void prefetch_l2(const void* ptr) {
  asm volatile("prefetch.global.L2::evict_last [%0];\n" ::"l"(ptr));
}

// A thread's share of the 128-byte lines of its two rows of an epilogue
// operand ([row][ldo] from column n0, BN wide), asked into L2 before the
// tile's products so that the epilogue, which waits on its loads, finds
// them there; the quad's four threads split each row's lines. For the bf16
// rows of kLnFwd and kDpre: on an H100 at rawiq_best's shape kDpre took 0.51
// ms with it against 0.65 without, while LN1's backward read its f32 xh
// slower with it (1.07 against 0.96 ms).
template <int BN, class T>
__device__ __forceinline__ void prefetch_rows(const T* base, const Stage& p, long long row0,
                                              int n0, const GwThread& th) {
  constexpr int LINES = BN * (int)sizeof(T) / 128;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long row = row0 + th.warp * 16 + th.g + 8 * hh;
    if (row >= p.m) continue;
    const char* line = reinterpret_cast<const char*>(base + row * p.ldo + n0);
    for (int l = th.t; l < LINES; l += 4) prefetch_l2(line + l * 128);
  }
}

// A warpgroup's accumulators before its first wgmma: the bias, the f32
// residual rows (zeros past m), or zeros; and the epilogue's row operands
// asked into L2. Accumulator e is row row0 + 16 warp + g (+ 8 where (e >>
// 1) & 1), column n0 + 8 (e / 4) + 2t + (e & 1).
template <int EPI, int BN>
__device__ __forceinline__ void stage_init(float* acc, const Stage& p, long long row0, int n0,
                                           const float* vec, const GwThread& th) {
  if constexpr (EPI == kLnFwd || EPI == kDpre) prefetch_rows<BN>(p.res, p, row0, n0, th);
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const int c = (e >> 2) * 8 + 2 * th.t;
    float2 v = make_float2(0.f, 0.f);
    if constexpr (EPI == kBias || EPI == kReluDrop || EPI == kLnFwd) {
      v = *reinterpret_cast<const float2*>(vec + c);
    } else if constexpr (EPI == kLnBwd || EPI == kResOut) {
      const long long row = row0 + th.warp * 16 + th.g + 8 * ((e >> 1) & 1);
      v = ld_pair(p.res32, (row < p.m ? row * p.ldo : 0) + n0 + c, row < p.m);
    }
    acc[e] = v.x;
    acc[e + 1] = v.y;
  }
}

// x[2j + u]: a thread's sums over its two rows of column 2t + u of the four
// 8-column blocks 4G + j of a 32-column group. Adds them over the warp's
// eight row groups by halving (lanes 16, 8, 4 apart) and returns the warp's
// sum of column 8 (2 ((g >> 2) & 1) + ((g >> 1) & 1)) + 2t + (g & 1) of the
// group: each lane ends with a distinct one of the 32, in a fixed order.
__device__ __forceinline__ float reduce_scatter8(const float x[8], int g) {
  float y[4], z[2];
  const bool h4 = g & 4, h2 = g & 2, h1 = g & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y[i] = (h4 ? x[4 + i] : x[i]) + __shfl_xor_sync(0xffffffffu, h4 ? x[i] : x[4 + i], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    z[i] = (h2 ? y[2 + i] : y[i]) + __shfl_xor_sync(0xffffffffu, h2 ? y[i] : y[2 + i], 8);
  return (h1 ? z[1] : z[0]) + __shfl_xor_sync(0xffffffffu, h1 ? z[0] : z[1], 4);
}

// The column (in the slab) that reduce_scatter8 leaves with lane (g, t) for
// group G
__device__ __forceinline__ int scatter_col(int G, int g, int t) {
  return 32 * G + 8 * (2 * ((g >> 2) & 1) + ((g >> 1) & 1)) + 2 * t + (g & 1);
}

// 64-row tiles between two column sums in part: ceil(m / 64) rounded up to
// even. A streamed stage's last 128-row tile leaves one warpgroup no row
// where m = 64 mod 128; its (zero) sums land in the spare tile, which no
// reduction reads.
__host__ __device__ inline long long sum_stride(long long m) { return (m + 127) / 128 * 2; }

// The tile's column sums: red[s][warp][BN] holds each warp's sums of sum s;
// the warpgroup adds its four warps in order into part[(s * sum_stride(m) +
// rt) * ldo + n0 + c] (rt the 64-row tile), between two named barriers (id
// 3 + wg) so that no warp refills red before every sum is read.
template <int BN, int S>
__device__ __forceinline__ void store_col_sums(const float* red, const Stage& p, long long row0,
                                               int n0, const GwThread& th) {
  const long long RT = sum_stride(p.m), rt = row0 / ROW_TILE;
  named_bar_sync(3 + th.wg, 128);
  for (int i = threadIdx.x & 127; i < S * BN; i += 128) {
    const int s = i / BN, c = i % BN;
    const float* r = red + s * 4 * BN + c;
    p.part[(s * RT + rt) * p.ldo + n0 + c] = ((r[0] + r[BN]) + r[2 * BN]) + r[3 * BN];
  }
  named_bar_sync(3 + th.wg, 128);
}

// kLnBwd's epilogue on LN's normalized input xh in f32 (K3) or bf16 (K4):
// g = acc; per row s1 = sum g gamma, s2 = sum g gamma xh; dz = rstd (g
// gamma - s1 / D - xh s2 / D) to out32, acc = dz mask; the warps' column
// sums of g xh, g and dz mask into red. rows, at, in: the thread's rows,
// their offsets and bounds (ld_pair); mix their dropout hash parts. Three
// passes over the accumulators (the sums that need no xh first, then those
// that do, then dz), so that few values besides the 128 accumulators of a
// 256-wide tile live at once. The seed plus salt is read for the third from
// vec[0], where the block stored it (a value loaded from global memory, even
// just before the third pass, spilled the 256-wide XH16 instance).
template <int BN, class XH>
__device__ __forceinline__ void ln_bwd_epilogue(float* acc, const Stage& p, const XH* xh,
                                                const long long rows[2], const long long at[2],
                                                const bool in[2], const uint32_t mix[2],
                                                const float* vec, float* red,
                                                const GwThread& th) {
  const int warp = th.warp, g = th.g, t = th.t;
  float rr[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float r = p.rstd[in[hh] ? rows[hh] : 0];
    rr[hh] = in[hh] ? r : 0.f;
  }
#pragma unroll
  for (int G = 0; G < BN / 32; ++G) {  // s1 and the column sums of g
    float cb[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = (4 * G + j) * 8 + 2 * t;
      const float2 gm = *reinterpret_cast<const float2*>(vec + BN + c);
      cb[2 * j] = cb[2 * j + 1] = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = (4 * G + j) * 4 + 2 * hh;
        s1[hh] += acc[e] * gm.x;
        s1[hh] += acc[e + 1] * gm.y;
        cb[2 * j] += acc[e];
        cb[2 * j + 1] += acc[e + 1];
      }
    }
    red[(4 + warp) * BN + scatter_col(G, g, t)] = reduce_scatter8(cb, g);
  }
#pragma unroll
  for (int G = 0; G < BN / 32; ++G) {  // s2 and the column sums of g xh
    float ca[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = (4 * G + j) * 8 + 2 * t;
      const float2 gm = *reinterpret_cast<const float2*>(vec + BN + c);
      ca[2 * j] = ca[2 * j + 1] = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = (4 * G + j) * 4 + 2 * hh;
        const float2 x = ld_pair(xh, at[hh] + c, in[hh]);
        s2[hh] += (acc[e] * gm.x) * x.x;
        s2[hh] += (acc[e + 1] * gm.y) * x.y;
        ca[2 * j] += acc[e] * x.x;
        ca[2 * j + 1] += acc[e + 1] * x.y;
      }
    }
    red[warp * BN + scatter_col(G, g, t)] = reduce_scatter8(ca, g);
  }
  float m1[2], m2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m1[hh] = quad_sum(s1[hh]) * (1.0f / BN);
    m2[hh] = quad_sum(s2[hh]) * (1.0f / BN);
  }
  const uint32_t ss = p.drop.on ? reinterpret_cast<const uint32_t*>(vec)[0] : 0u;
#pragma unroll
  for (int G = 0; G < BN / 32; ++G) {  // dz, dz mask and its column sums
    float cc[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = (4 * G + j) * 8 + 2 * t;
      const float2 gm = *reinterpret_cast<const float2*>(vec + BN + c);
      cc[2 * j] = cc[2 * j + 1] = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = (4 * G + j) * 4 + 2 * hh;
        const float2 x = ld_pair(xh, at[hh] + c, in[hh]);
        const float dz0 = rr[hh] * (acc[e] * gm.x - m1[hh] - x.x * m2[hh]);
        const float dz1 = rr[hh] * (acc[e + 1] * gm.y - m1[hh] - x.y * m2[hh]);
        if (in[hh]) *reinterpret_cast<float2*>(p.out32 + at[hh] + c) = make_float2(dz0, dz1);
        float k0 = 1.f, k1 = 1.f;
        if (p.drop.on) {
          k0 = keep_of(p.drop, ss, mix[hh], c);
          k1 = keep_of(p.drop, ss, mix[hh], c + 1);
        }
        acc[e] = dz0 * k0;
        acc[e + 1] = dz1 * k1;
        cc[2 * j] += acc[e];
        cc[2 * j + 1] += acc[e + 1];
      }
    }
    red[(8 + warp) * BN + scatter_col(G, g, t)] = reduce_scatter8(cc, g);
  }
}

// The epilogue of a warpgroup's tile (see Epi), from its accumulators;
// `split` is the weight gradient's depth split, red the warpgroup's column
// sum scratch; XH16: kLnBwd reads xh in bf16 (K4's stash).
template <int EPI, int BN, bool XH16>
__device__ __forceinline__ void stage_store(float* acc, const Stage& p, long long row0, int n0,
                                            int split, const float* vec, float* red,
                                            const GwThread& th) {
  const int warp = th.warp, g = th.g, t = th.t;
  const long long rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  const bool in[2] = {rows[0] < p.m, rows[1] < p.m};
  // the rows' offsets in the [row][ldo] operands, row 0's past m (see ld_pair)
  const long long at[2] = {in[0] ? rows[0] * p.ldo : 0, in[1] ? rows[1] * p.ldo : 0};
  uint32_t mix[2] = {0u, 0u}, ss = 0u;
  if (EPI != kDpre && EPI != kPartial && p.drop.on) {
    mix[0] = row_mix(p.drop, rows[0]);
    mix[1] = row_mix(p.drop, rows[1]);
    if (EPI != kLnBwd) ss = seed_salt(p.drop);  // kLnBwd reads the block's, vec[0]
  }
  if constexpr (EPI == kPartial) {
    float* dst = p.out32 + (long long)split * p.m * p.ldo + n0;
#pragma unroll
    for (int e = 0; e < BN / 2; e += 2) {
      const int hh = (e >> 1) & 1;
      if (in[hh])
        *reinterpret_cast<float2*>(dst + rows[hh] * p.ldo + (e >> 2) * 8 + 2 * t) =
            make_float2(acc[e], acc[e + 1]);
    }
    return;
  } else if constexpr (EPI == kReluDrop) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      float v = fmaxf(acc[e], 0.f);
      if (p.drop.on)
        v *= keep_of(p.drop, ss, mix[(e >> 1) & 1], n0 + (e >> 2) * 8 + 2 * t + (e & 1));
      acc[e] = v;
    }
  } else if constexpr (EPI == kLnFwd) {
    // z = (acc + bias) * mask + res, then LayerNorm over the row (BN = D),
    // centred in place as K1's epilogue
    float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f}, rstd[2];
#pragma unroll
    for (int e = 0; e < BN / 2; e += 2) {
      const int hh = (e >> 1) & 1, c = (e >> 2) * 8 + 2 * t;
      const float2 r = ld_pair(p.res, at[hh] + c, in[hh]);
      if (p.drop.on) {
        acc[e] *= keep_of(p.drop, ss, mix[hh], c);
        acc[e + 1] *= keep_of(p.drop, ss, mix[hh], c + 1);
      }
      acc[e] += r.x;
      acc[e + 1] += r.y;
      sum[hh] += acc[e] + acc[e + 1];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) sum[hh] = quad_sum(sum[hh]) * (1.0f / BN);  // the mean
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      acc[e] -= sum[(e >> 1) & 1];
      sq[(e >> 1) & 1] += acc[e] * acc[e];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rstd[hh] = rsqrtf(quad_sum(sq[hh]) * (1.0f / BN) + LN_EPS);
      if (p.rstd_out && t == 0 && in[hh]) p.rstd_out[rows[hh]] = rstd[hh];
    }
#pragma unroll
    for (int e = 0; e < BN / 2; e += 2) {  // xh
      const int hh = (e >> 1) & 1;
      acc[e] *= rstd[hh];
      acc[e + 1] *= rstd[hh];
      if (p.xh_out && in[hh])
        *reinterpret_cast<float2*>(p.xh_out + rows[hh] * p.ldo + (e >> 2) * 8 + 2 * t) =
            make_float2(acc[e], acc[e + 1]);
    }
    if (p.xh_out16) store_tile_bf16<BN>(acc, p.xh_out16, p.ldo, rows, p.m, 0, t);
    if (!p.out) return;  // the recompute's LN2: only xh and 1/std
#pragma unroll
    for (int e = 0; e < BN / 2; e += 2) {
      const int c = (e >> 2) * 8 + 2 * t;
      const float2 gm = *reinterpret_cast<const float2*>(vec + BN + c);
      const float2 bt = *reinterpret_cast<const float2*>(vec + 2 * BN + c);
      acc[e] = gm.x * acc[e] + bt.x;
      acc[e + 1] = gm.y * acc[e + 1] + bt.y;
    }
  } else if constexpr (EPI == kDpre) {
    // d = h > 0 ? acc * mask : 0, its column sums by 32-column group. Where
    // h > 0 the FFN1 mask kept the lane (h = bf16(relu(.) mask)), so the mask
    // there is its scale: no hash.
    const float keep = p.drop.on ? p.drop.scale : 1.f;
    float* mine = red + warp * BN;
#pragma unroll
    for (int G = 0; G < BN / 32; ++G) {
      float cs[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (4 * G + j) * 8 + 2 * t;
        cs[2 * j] = cs[2 * j + 1] = 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int e = (4 * G + j) * 4 + 2 * hh;
          const float2 h = ld_pair(p.res, at[hh] + n0 + c, in[hh]);
          acc[e] = h.x > 0.f ? acc[e] * keep : 0.f;
          acc[e + 1] = h.y > 0.f ? acc[e + 1] * keep : 0.f;
          cs[2 * j] += acc[e];
          cs[2 * j + 1] += acc[e + 1];
        }
      }
      mine[scatter_col(G, g, t)] = reduce_scatter8(cs, g);
    }
  } else if constexpr (EPI == kLnBwd) {
    if constexpr (XH16)
      ln_bwd_epilogue<BN>(acc, p, p.xh16, rows, at, in, mix, vec, red, th);
    else
      ln_bwd_epilogue<BN>(acc, p, p.xh, rows, at, in, mix, vec, red, th);
  }
  store_tile_bf16<BN>(acc, p.out, p.ldo, rows, p.m, n0, t);
  if constexpr (col_sums(EPI) > 0) store_col_sums<BN, col_sums(EPI)>(red, p, row0, n0, th);
}

// One GEMM stage (see the header): TA, TB from the epilogue; the slab
// blockIdx.x % n_tiles, its items walked from blockIdx.x / n_tiles. XH16
// (kLnBwd only): xh in bf16, an instance of its own, so that neither
// instance carries the other's loads in its 256-wide tile's registers.
template <int EPI, int BN, bool RESIDENT, bool XH16>
__global__ void __launch_bounds__(GW_THREADS, 1) train_gemm_kernel(
    const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
    Stage p, int ring) {
  extern __shared__ unsigned char gw_raw[];
  const GwLayout s = gw_layout<BN, RESIDENT>(gw_raw, p.k, ring, stage_extra(EPI, BN));
  float* vec = reinterpret_cast<float*>(s.extra);  // bias, gamma, beta
  const int slab = blockIdx.x % p.n_tiles, stride = gridDim.x / p.n_tiles;
  const int first = blockIdx.x / p.n_tiles;
  const int n0 = slab * BN;
  const long long tm = RESIDENT ? 64 : 128;
  const int n_rt = (int)((p.m + tm - 1) / tm);
  const GwThread th = gw_thread();
  float* red = vec + 3 * BN + th.wg * col_sums(EPI) * 4 * BN;

  for (int i = threadIdx.x; i < BN; i += GW_THREADS) {
    if (EPI == kBias || EPI == kReluDrop || EPI == kLnFwd) vec[i] = p.bias[n0 + i];
    if (is_ln(EPI)) vec[BN + i] = p.gamma[i];
    if (EPI == kLnFwd) vec[2 * BN + i] = p.beta[i];
  }
  // kLnBwd's seed plus salt, once a block, in the bias slot it does not read
  if (EPI == kLnBwd && threadIdx.x == 0 && p.drop.on)
    reinterpret_cast<uint32_t*>(vec)[0] = seed_salt(p.drop);
  gemm_wgmma_loop<BN, RESIDENT, a_transposed(EPI), b_mn_major(EPI), EPI == kPartial>(
      a_map, b_map, s, p.k, n0, first, stride, n_rt, n_rt * p.splits, ring, th,
      [&](float* acc, long long row0) { stage_init<EPI, BN>(acc, p, row0, n0, vec, th); },
      [&](float* acc, long long row0, int split) {
        stage_store<EPI, BN, XH16>(acc, p, row0, n0, split, vec, red, th);
      });
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

// K3's attention forward: k as rows and v transposed
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

// pbar = bf16(bf16(exp2(s - m)) / l), the normalized probability as the
// JAX backward rounds it
__device__ __forceinline__ float pbar(float s, float m, float l) {
  return bf16_round(bf16_round(exp2f(s - m)) / l);
}

// K3's attention forward, one block per (frame b, head h): K1's
// register-fragment core with the q columns of qkv unscaled, scaled here as
// bf16(q * scale2). With `stats` (K3's recompute), writes each query row's
// max (log2 units) and sum of bf16 probabilities to
// stats[((b*H + h)*L + i)*2 + {0, 1}].
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

// Scale a warp's 16-row accumulator (rows r_lo and r_hi of each thread) in
// place, store its rows < L as bf16 at column offset `col` of dqkv, and add
// them to the thread's column sums.
template <int DH>
__device__ __forceinline__ void store_rows(float acc[DH / 8][4], float scale, bf16* out_base,
                                           int r_lo, int r_hi, int L, long long row3, int col,
                                           float cs[DH / 8][2]) {
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] *= scale;
    if (r_lo < L) {
      *reinterpret_cast<uint32_t*>(out_base + (long long)r_lo * row3 + col + nd * 8) =
          pack_bf16x2(acc[nd][0], acc[nd][1]);
      cs[nd][0] += acc[nd][0];
      cs[nd][1] += acc[nd][1];
    }
    if (r_hi < L) {
      *reinterpret_cast<uint32_t*>(out_base + (long long)r_hi * row3 + col + nd * 8) =
          pack_bf16x2(acc[nd][2], acc[nd][3]);
      cs[nd][0] += acc[nd][2];
      cs[nd][1] += acc[nd][3];
    }
  }
}

// A warp's column sums of section s (0 dq, 1 dk, 2 dv) over its 8 row groups,
// parked in red[warp][s][DH] (shared memory) when the pass that formed them
// ends, so that they leave the registers.
template <int DH>
__device__ __forceinline__ void park_column_sums(const float cs[DH / 8][2], float* red, int s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v = cs[nd][u];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[(warp * 3 + s) * DH + nd * 8 + 2 * t + u] = v;
    }
}

// The block's column sums of dq, dk and dv: the parked warp sums added over
// the warps in a fixed order, into part[s * D + c] (section s, the head's
// column c).
template <int DH, int NW = ATTN_WARPS>
__device__ __forceinline__ void store_column_sums(const float* red, float* part, int D) {
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * DH; i += blockDim.x) {
    const int s = i / DH, c = i % DH;
    float sum = 0.f;
    for (int w = 0; w < NW; ++w) sum += red[(w * 3 + s) * DH + c];
    part[s * D + c] = sum;
  }
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
  bf16* out_base = dqkv + (long long)b * L * row3 + (long long)h * DH + 2 * t;

  // pass 1: dQ for 16 query rows per warp
  float cs_q[DH / 8][2] = {};  // column sums of dq over this thread's rows
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
    store_rows<DH>(dq, dq_scale, out_base, r_lo, r_hi, L, row3, 0, cs_q);
  }
  park_column_sums<DH>(cs_q, red, 0);

  // pass 2: dK and dV for 16 key rows per warp
  float cs_k[DH / 8][2] = {}, cs_v[DH / 8][2] = {};
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
    store_rows<DH>(dk, dk_scale, out_base, k_lo, k_hi, L, row3, D, cs_k);
    store_rows<DH>(dv, 1.f, out_base, k_lo, k_hi, L, row3, 2 * D, cs_v);
  }
  park_column_sums<DH>(cs_k, red, 1);
  park_column_sums<DH>(cs_v, red, 2);

  store_column_sums<DH>(red, part + (long long)b * row3 + h * DH, D);
}

// ---------------------------------------------------------------------------
// K4's attention passes on wgmma: the forward that writes pbar, the backward
// that reads it (see the header)
// ---------------------------------------------------------------------------

constexpr int WG_T = 64;             // rows of a wgmma tile: 64 queries, or 64 keys
constexpr int RESIDENT_ROWS = 80;    // the backward holds a frame-head whole up to round16(L) = 80
constexpr int PLANE_CHUNK = 8192;    // a [64][64] bf16 tile, 128-byte swizzled

// 16-key groups of the forward's score tile: the scores of a 64-query tile
// over all keys, in registers, where round16(L) <= 80 (NG 2, 4 or 5, the
// least that covers L); else 64-key tiles (NG 4), the scores formed twice.
__host__ __device__ inline int fwd_groups(int L) {
  const int ng = round16(L) / 16;
  return ng <= 2 ? 2 : ng <= 4 ? 4 : ng <= 5 ? 5 : 4;
}
// rows of k and v the forward loads: its one tile's, or whole 64-key tiles
__host__ __device__ inline int fwd_key_rows(int L) {
  const int ng = fwd_groups(L);
  return L <= 16 * ng ? 16 * ng : (L + WG_T - 1) / WG_T * WG_T;
}
// The backward holds q, k, v, dO and all of pbar at once where round16(L) <=
// 80 (resident: keys in NG = 2, 4 or 5 groups, rows 16 NG), else streams pbar
// in [64][64] tiles (NG 4, rows round64(L)).
__host__ __device__ inline bool bwd_resident(int L) { return round16(L) <= RESIDENT_ROWS; }
__host__ __device__ inline int bwd_groups(int L) {
  const int r = round16(L);
  return r <= 32 ? 2 : r <= 64 ? 4 : r <= RESIDENT_ROWS ? 5 : 4;
}
__host__ __device__ inline int bwd_rows(int L) {
  return bwd_resident(L) ? 16 * bwd_groups(L) : (L + WG_T - 1) / WG_T * WG_T;
}
// TMA box rows over an operand region of `rows` rows: one box up to 256
// (TMA's most), else 64-row boxes
__host__ __device__ inline int box_rows_of(int rows) { return rows <= 256 ? rows : WG_T; }
// pbar's row stride in the stash: L rounded up to 8 elements (16 bytes)
__host__ __device__ inline int stash_cols(int L) { return (L + 7) & ~7; }

// Shared memory, the 1 KB of alignment included. Forward: two buffers of q,
// k and v rows [fwd_key_rows][DH], each rounded up to 1 KB (the 128-byte
// swizzle's repeat); the pbar staging chunks [rows][64 keys] (all
// queries, fwd_key_rows, where the scores are one tile; else one 64-query
// tile's); two mbarriers. Backward: q (scaled in place), k, v and dO
// rows [bwd_rows][DH]; then resident, the pbar plane of
// ceil(rows / 64) key chunks [rows][64], which dS overwrites; streamed, one
// pbar tile and one dS tile [64][64]; the column-sum scratch [4 warps][3][DH]
// (f32) and two mbarriers. fused_layer_train.stash_attention_fwd_smem_bytes
// and stash_attention_bwd_smem_bytes repeat these formulas.
__host__ __device__ inline size_t wg_fwd_smem_bytes(int L, int dh) {
  const int kr = fwd_key_rows(L);
  const bool single = L <= 16 * fwd_groups(L);  // fwd_single
  const size_t staging = (size_t)(kr + 63) / 64 * (single ? kr : WG_T) * 128;
  return 1024 + 2 * (((size_t)6 * kr * dh + 1023) / 1024 * 1024) + staging + 16;
}
__host__ __device__ inline size_t wg_bwd_smem_bytes(int L, int dh) {
  const int r = bwd_rows(L);
  const size_t plane = bwd_resident(L) ? (size_t)(r + 63) / 64 * r * 128 : 2 * PLANE_CHUNK;
  return 1024 + (size_t)8 * r * dh + plane + (size_t)ATTN_WARPS * 3 * dh * 4 + 16;
}

// Byte offset of (row, col) in a plane of key chunks [rows][64 columns],
// chunk_bytes apart, each as a TMA box with the 128-byte swizzle lays it out
// (the chunk 1024-byte aligned): row r's 16-byte unit u at unit u ^ (r % 8).
__device__ __forceinline__ uint32_t plane_off(int row, int col, uint32_t chunk_bytes) {
  const int c = col & 63;
  return (uint32_t)(col >> 6) * chunk_bytes + row * 128 + ((((c >> 3) ^ row) & 7) << 4) +
         (c & 7) * 2;
}

// A fragments (warp rows r_lo, r_lo + 8, DH columns) from rows [row][DH] in
// shared memory as TMA writes them, swizzled by the row width: the 16-byte
// unit of byte offset o moves by (o >> 7) % (DH / 8) units.
template <int DH>
__device__ __forceinline__ void smem_frags(uint32_t a[DH / 16][4], const unsigned char* rows,
                                           int r_lo, int t) {
  constexpr uint32_t SPAN = DH * 2;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t off = (uint32_t)(r_lo + 8 * (i & 1)) * SPAN + (kk * 16 + 8 * (i >> 1) + 2 * t) * 2;
      off ^= ((off >> 7) & (SPAN / 16 - 1)) << 4;
      a[kk][i] = *reinterpret_cast<const uint32_t*>(rows + off);
    }
}

// c[grp] = A Rows^T for NG groups of 16 rows: A a 64-row tile in registers
// (DH deep), Rows [rows][DH] in shared memory from `rows` (K-major B, m64n16
// per group and k-step): the scores against k, dP against v.
template <int DH, int NG>
__device__ __forceinline__ void times_rows_t(float (*c)[8], const uint32_t (*a)[4], uint32_t rows) {
  constexpr int SPAN = DH * 2;
  constexpr uint32_t SBO = 8 * SPAN;
  wgmma_fence();
#pragma unroll
  for (int grp = 0; grp < NG; ++grp)
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      Wgmma<16>::template rs<0>(c[grp], a[kk],
                                smem_desc(rows + grp * 16 * SPAN + kk * 32, SPAN, SBO, SBO), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<8 * NG>(&c[0][0]);
}

// times_rows_t with the NG groups as one product of N = 16 NG a k-step
// where wgmma has that width from registers (NG 2 to 4), so that a
// warpgroup issues one wgmma where it issued NG; the accumulators of an
// m64nN tile are the NG m64n16 tiles' in order.
template <int DH, int NG>
__device__ __forceinline__ void times_rows_t_wide(float (*c)[8], const uint32_t (*a)[4],
                                                  uint32_t rows) {
  if constexpr (NG >= 2 && NG <= 4) {
    constexpr int SPAN = DH * 2;
    constexpr uint32_t SBO = 8 * SPAN;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      Wgmma<16 * NG>::template rs<0>(&c[0][0], a[kk], smem_desc(rows + kk * 32, SPAN, SBO, SBO),
                                     kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<8 * NG>(&c[0][0]);
  } else {
    times_rows_t<DH, NG>(c, a, rows);
  }
}

// acc += sum over the NG groups of A[grp] Rows[grp]: A the A fragments of a
// 64-row tile over 16 rows of Rows each (P, dS), Rows [rows][DH] from `rows`
// (MN-major B): P V, dS K.
template <int DH, int NG>
__device__ __forceinline__ void times_rows(float* acc, const uint32_t (*a)[4], uint32_t rows) {
  constexpr int SPAN = DH * 2;
  constexpr uint32_t SBO = 8 * SPAN;
  wgmma_fence();
#pragma unroll
  for (int grp = 0; grp < NG; ++grp)
    Wgmma<DH>::template rs<1>(acc, a[grp], smem_desc(rows + grp * 16 * SPAN, SPAN, SBO, SBO), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<DH / 2>(acc);
}

// acc += Tile^T Rows over n_k steps of 16 queries, issued (the caller fences,
// commits and waits): Tile a key chunk [queries][64 keys] of a plane read as
// the MN-major A (the 64 keys are the product's rows: pbar^T, dS^T), Rows
// [queries][DH] the MN-major B (dO, q scaled): dV and dK.
template <int DH>
__device__ __forceinline__ void issue_tile_t_rows(float* acc, uint32_t tile, uint32_t rows,
                                                  int n_k) {
  constexpr int SPAN = DH * 2;
  constexpr uint32_t SBO = 8 * SPAN;
  for (int kq = 0; kq < n_k; ++kq)
    Wgmma<DH>::template ss<1, 1>(acc, smem_desc(tile + kq * 2048, 128, 8192, 1024),
                                 smem_desc(rows + kq * 16 * SPAN, SPAN, SBO, SBO), 1);
}

// Whether accumulator e of a 16-key group (column 8 (e / 4) + 2t + (e & 1))
// holds one of the group's `left` keys below L
__device__ __forceinline__ bool key_in(int e, int t, int left) {
  return 8 * (e >> 2) + 2 * t + (e & 1) < left;
}

// The row maxima of a score tile over its keys < L (key0 the tile's first
// key): whole groups unmasked, the group that L cuts masked, groups past L
// skipped (each test uniform)
template <int NG>
__device__ __forceinline__ void tile_max(const float (*s)[8], int key0, int L, int t, float& m_lo,
                                         float& m_hi) {
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
    const int left = L - key0 - 16 * grp;  // keys of the group below L
    if (left <= 0) continue;
    const bool whole = left >= 16;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = whole || key_in(e, t, left) ? s[grp][e] : -INFINITY;
      if (e & 2)
        m_hi = fmaxf(m_hi, v);
      else
        m_lo = fmaxf(m_lo, v);
    }
  }
}

// p = bf16(exp2(s - m)) of a score tile (MUFU.EX2), 0 for keys >= L, packed
// into the A fragments of P V (pair i of a group: row hi where i is odd,
// columns 8 (i / 2) + 2t and + 1), and the f32 sums of the rounded p of the
// thread's rows
template <int NG>
__device__ __forceinline__ void tile_probs(const float (*s)[8], uint32_t (*pa)[4], int key0, int L,
                                           int t, float m_lo, float m_hi, float& l_lo,
                                           float& l_hi) {
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
    const int left = L - key0 - 16 * grp;
    float p[8];
    if (left >= 16) {
#pragma unroll
      for (int e = 0; e < 8; ++e) p[e] = exp2_sfu(s[grp][e] - ((e & 2) ? m_hi : m_lo));
    } else if (left > 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        p[e] = key_in(e, t, left) ? exp2_sfu(s[grp][e] - ((e & 2) ? m_hi : m_lo)) : 0.f;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) p[e] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 pb = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
      const float2 pf = __bfloat1622float2(pb);
      if (i & 1)
        l_hi += pf.x + pf.y;
      else
        l_lo += pf.x + pf.y;
      pa[grp][i] = *reinterpret_cast<const uint32_t*>(&pb);
    }
  }
}

// A bf16 pair divided by l, each quotient IEEE-rounded without a divide
// (quant_div, gemm_wgmma.cuh, from y = RN(1 / l)), then rounded to bf16:
// pbar = bf16(p / l) as the plain version rounds it.
__device__ __forceinline__ uint32_t div_pair(uint32_t w, float l, float y) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return pack_bf16x2(quant_div(f.x, l, y), quant_div(f.y, l, y));
}

// The same from x y alone (y = RN(1 / l)), which lies within 2 ulps of x /
// l and so rounds to the bf16 that the IEEE quotient rounds to unless it
// lies within 3 ulps of a bf16 rounding midpoint (low 16 bits 0x8000): `near`
// is then set, and the caller takes div_pair.
__device__ __forceinline__ uint32_t mul_pair(uint32_t w, float y, bool& near) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  const float q0 = f.x * y, q1 = f.y * y;
  near |= (__float_as_uint(q0) & 0xffffu) - 0x7ffdu <= 6u;
  near |= (__float_as_uint(q1) & 0xffffu) - 0x7ffdu <= 6u;
  return pack_bf16x2(q0, q1);
}

// Whether the forward keeps the scores of all keys in one tile (round16(L)
// <= 80): its pbar is staged for all queries and stored once; else per
// 64-query tile.
__host__ __device__ inline bool fwd_single(int L) { return L <= 16 * fwd_groups(L); }

// K4-fwd's attention: persistent blocks of one warpgroup, each taking the
// frame-heads (frame b, head h) = item b H + h, items blockIdx.x,
// blockIdx.x + gridDim.x, ... (n_items = B H). qkv_map: 3-D map over qkv [B,
// L, 3D], boxes of DH columns and box_rows_of(fwd_key_rows(L)) rows; an
// item's q, k and v arrive by TMA in one of two buffers, the next item's
// while this one is computed. q's A fragments are bf16(q scale2). Per
// 64-query tile: the scores of all keys (one tile of 16 NG keys held in
// registers, or 64-key tiles formed twice), the row max m, p = bf16(exp2(s -
// m)) (MUFU.EX2), l = the f32 sum of the rounded p, attn = bf16(P V / l);
// pbar = bf16(p / l) is staged in shared memory in 64-key chunks [rows][64]
// (in one tile from the kept p, by a product where it rounds as the
// quotient does; else p itself per tile, divided by l in place once l is
// whole), then stored by TMA (pbar_map:
// [B H, L, stash_cols(L)], boxes of 64 columns and `rows` rows; rows past L
// are not stored, columns in [L, stash_cols) are 0): in one tile, every
// query's rows at once when the item ends; else per query tile.
template <int DH, int NG>
__global__ void __launch_bounds__(128) wg_attention_fwd(
    const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap pbar_map,
    bf16* __restrict__ out, int L, int D, int H, int n_items, float scale2) {
  constexpr int SPAN = DH * 2;
  constexpr int KT = 16 * NG;  // keys of a tile
  extern __shared__ unsigned char wa_raw[];
  unsigned char* smem = wa_raw + ((1024 - (smem_u32(wa_raw) & 1023)) & 1023);
  const int kr = fwd_key_rows(L), box = box_rows_of(kr), n_kc = (kr + 63) / 64;
  const int n_t = (L + KT - 1) / KT;  // key tiles (uniform)
  const uint32_t chunk = (n_t == 1 ? kr : WG_T) * 128;  // a staging chunk: [rows][64 keys]
  const uint32_t buf_bytes = (3 * kr * SPAN + 1023) & ~1023;  // q, k, v; the swizzle's 1 KB repeat
  unsigned char* stage = smem + 2 * buf_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + n_kc * chunk);
  auto load = [&](int item, int buf) {  // one thread
    unsigned char* q = smem + buf * buf_bytes;
    const int b = item / H, h = item % H;
    mbar_expect_tx(&full[buf], 3 * kr * SPAN);
    for (int r = 0; r < kr; r += box)
      for (int sec = 0; sec < 3; ++sec)  // q, k, v
        tma_load_3d(q + (sec * kr + r) * SPAN, &qkv_map, &full[buf], sec * D + h * DH, r, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init_fence();
    for (int u = 0; u < 2 && blockIdx.x + u * gridDim.x < n_items; ++u)
      load(blockIdx.x + u * gridDim.x, u);
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int u = 0;
  for (int bh = blockIdx.x; bh < n_items; bh += gridDim.x, ++u) {
    const int b = bh / H, h = bh % H;
    const unsigned char* qs = smem + (u & 1) * buf_bytes;
    const uint32_t k_addr = smem_u32(qs + kr * SPAN), v_addr = smem_u32(qs + 2 * kr * SPAN);
    if (threadIdx.x == 0) tma_store_wait_read();  // the previous item's pbar has left
    __syncthreads();
    mbar_wait(&full[u & 1], (u >> 1) & 1);
    for (int q0 = 0; q0 < L; q0 += WG_T) {
      const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
      const bool live = q0 + 16 * warp < L;  // the warp holds a row < L (warp-uniform)
      // staging row of the thread's lo row: the query in one tile, else in its query tile
      const int srow = n_t == 1 ? r_lo : 16 * warp + g;
      uint32_t qa[DH / 16][4];
      if (live) {
        smem_frags<DH>(qa, qs, r_lo, t);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[kk][i] = scale_pair(qa[kk][i], scale2);
      } else {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[kk][i] = 0u;
      }
      float s[NG][8];
      float m_lo = -INFINITY, m_hi = -INFINITY;
      for (int kt = 0; kt < n_t; ++kt) {
        times_rows_t<DH, NG>(s, qa, k_addr + kt * KT * SPAN);
        if (live) tile_max<NG>(s, kt * KT, L, t, m_lo, m_hi);
      }
      m_lo = quad_max(m_lo);
      m_hi = quad_max(m_hi);
      float o[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      float l_lo = 0.f, l_hi = 0.f;
      uint32_t pa[NG][4];
      for (int kt = 0; kt < n_t; ++kt) {
        if (n_t > 1) times_rows_t<DH, NG>(s, qa, k_addr + kt * KT * SPAN);
        if (live) {
          tile_probs<NG>(s, pa, kt * KT, L, t, m_lo, m_hi, l_lo, l_hi);
          if (n_t > 1)  // p itself, divided by l once l is whole
#pragma unroll
            for (int grp = 0; grp < NG; ++grp)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                *reinterpret_cast<uint32_t*>(stage + plane_off(srow + 8 * (i & 1),
                                                               kt * KT + 16 * grp + 8 * (i >> 1) +
                                                                   2 * t,
                                                               chunk)) = pa[grp][i];
        } else {
#pragma unroll
          for (int grp = 0; grp < NG; ++grp)
#pragma unroll
            for (int i = 0; i < 4; ++i) pa[grp][i] = 0u;
        }
        times_rows<DH, NG>(o, pa, v_addr + kt * KT * SPAN);
      }
      l_lo = quad_sum(l_lo);
      l_hi = quad_sum(l_hi);
      const float y_lo = live ? rcp_rn(l_lo) : 1.f, y_hi = live ? rcp_rn(l_hi) : 1.f;

      bf16* o_base = out + (long long)b * L * D + h * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        if (r_lo < L)
          *reinterpret_cast<uint32_t*>(o_base + (long long)r_lo * D + j * 8) =
              pack_bf16x2(quant_div(o[4 * j], l_lo, y_lo),
                          quant_div(o[4 * j + 1], l_lo, y_lo));
        if (r_hi < L)
          *reinterpret_cast<uint32_t*>(o_base + (long long)r_hi * D + j * 8) =
              pack_bf16x2(quant_div(o[4 * j + 2], l_hi, y_hi),
                          quant_div(o[4 * j + 3], l_hi, y_hi));
      }
      // pbar = bf16(p / l): in one tile from the kept p by a product, the
      // warp dividing only where a lane's product lies near a bf16 midpoint;
      // else in place, divided
      auto pbar_at = [&](int kt, int grp, int i) {
        const int col = kt * KT + 16 * grp + 8 * (i >> 1) + 2 * t;
        return reinterpret_cast<uint32_t*>(stage + plane_off(srow + 8 * (i & 1), col, chunk));
      };
      if (live && n_t == 1) {
        bool near = false;
#pragma unroll
        for (int grp = 0; grp < NG; ++grp)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *pbar_at(0, grp, i) = mul_pair(pa[grp][i], (i & 1) ? y_hi : y_lo, near);
        if (__any_sync(0xffffffffu, near))
#pragma unroll
          for (int grp = 0; grp < NG; ++grp)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              *pbar_at(0, grp, i) =
                  div_pair(pa[grp][i], (i & 1) ? l_hi : l_lo, (i & 1) ? y_hi : y_lo);
      } else if (live) {
        for (int kt = 0; kt < n_t; ++kt)
#pragma unroll
          for (int grp = 0; grp < NG; ++grp)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              uint32_t* w = pbar_at(kt, grp, i);
              *w = div_pair(*w, (i & 1) ? l_hi : l_lo, (i & 1) ? y_hi : y_lo);
            }
      }
      if (n_t > 1) {  // this query tile's pbar
        fence_proxy_async();
        __syncthreads();
        if (threadIdx.x == 0) {
          for (int c = 0; c < n_kc; ++c)
            tma_store_3d(&pbar_map, stage + c * chunk, 64 * c, q0, bh);
          tma_store_commit();
          tma_store_wait_read();
        }
        __syncthreads();
      }
    }
    // the item is done with its buffer (which takes the item after next); in
    // one tile, its pbar leaves
    if (n_t == 1) fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      if (n_t == 1) {
        for (int c = 0; c < n_kc; ++c) tma_store_3d(&pbar_map, stage + c * chunk, 64 * c, 0, bh);
        tma_store_commit();
      }
      if (bh + 2 * gridDim.x < n_items) load(bh + 2 * gridDim.x, u & 1);
    }
  }
  if (threadIdx.x == 0) tma_store_wait_read();
}

// dS = bf16(pbar (dP - row)) of a warp's 16 query rows over NG groups of 16
// keys: dp the dP accumulators, pbar read from the plane at `pb` (key chunks
// chunk_bytes apart; the thread's lo row at `prow`, group 0 at column col0),
// packed into the A fragments dsa and, with ds_out, written there at the
// same offsets. Groups wholly past L (key0 the absolute key of group 0) and a
// warp that is not live give zeros; `clear`: such a warp writes its zeros
// to ds_out (a streamed dS tile, whose queries past L must add nothing).
template <int NG>
__device__ __forceinline__ void tile_ds(const float (*dp)[8], uint32_t (*dsa)[4],
                                        const unsigned char* pb, unsigned char* ds_out,
                                        uint32_t chunk_bytes, int prow, int col0, int key0, int L,
                                        float d_lo, float d_hi, int t, bool live, bool clear) {
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
    const bool on = live && key0 + 16 * grp < L;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off =
          plane_off(prow + 8 * (i & 1), col0 + 16 * grp + 8 * (i >> 1) + 2 * t, chunk_bytes);
      uint32_t w = 0u;
      if (on) {
        const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pb + off));
        const float d = (i & 1) ? d_hi : d_lo;
        w = pack_bf16x2(p.x * (dp[grp][2 * i] - d), p.y * (dp[grp][2 * i + 1] - d));
      }
      dsa[grp][i] = w;
      if (ds_out && (on || (clear && !live))) *reinterpret_cast<uint32_t*>(ds_out + off) = w;
    }
  }
}

// The row terms dO_i . O_i (f32) of the thread's rows, from their dO and O A
// fragments; the quad sums them.
template <int DH>
__device__ __forceinline__ void row_terms(const uint32_t (*da)[4], const uint32_t (*oa)[4],
                                          float& d_lo, float& d_hi) {
  d_lo = d_hi = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&da[kk][e]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&oa[kk][e]));
      if (e & 1)
        d_hi += x.x * y.x + x.y * y.y;
      else
        d_lo += x.x * y.x + x.y * y.y;
    }
  d_lo = quad_sum(d_lo);
  d_hi = quad_sum(d_hi);
}

// A query tile's dO A fragments, from the dO rows in shared memory, and O's,
// from device memory (zeros for a warp that is not live); the caller forms
// the row terms once dP has been issued, so that O's loads overlap it.
template <int DH>
__device__ __forceinline__ void tile_frags(uint32_t (*da)[4], uint32_t (*oa)[4],
                                           const unsigned char* dos, const bf16* o_head, int D,
                                           int r_lo, int L, int t, bool live) {
  if (live) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const bf16* lo = o_head + (long long)r_lo * D + kk * 16 + 2 * t;
      const bf16* hi = lo + 8LL * D;
      oa[kk][0] = r_lo < L ? ld_b32(lo) : 0u;
      oa[kk][1] = r_lo + 8 < L ? ld_b32(hi) : 0u;
      oa[kk][2] = r_lo < L ? ld_b32(lo + 8) : 0u;
      oa[kk][3] = r_lo + 8 < L ? ld_b32(hi + 8) : 0u;
    }
    smem_frags<DH>(da, dos, r_lo, t);
  } else {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) da[kk][i] = oa[kk][i] = 0u;
  }
}

// K4-bwd's attention, one block of one warpgroup per (frame b, head h) =
// blockIdx.x: the outputs of train_attention_bwd from the stashed pbar. q,
// k, v (qkv_map) and dO (do_map, over dattn [B, L, D]) arrive by TMA in
// boxes of DH columns and box_rows_of(bwd_rows(L)) rows; q is scaled in
// place; a query tile's dO A fragments come from there, its row terms dO . O
// with O read from attn [B, L, D].
// Resident (NG 2, 4 or 5): the whole pbar plane arrives with them (pbar_map:
// [B H, L, L] over the stash's row stride, so its padding is never read;
// boxes [bwd_rows][64]); dV = pbar^T dO per 64-key chunk; then per 64-query
// tile dP = dO V^T, dS = bf16(pbar (dP - row)) written over pbar in the
// plane, dQ = dS K; then dK = dS^T Qs per key chunk. Streamed (NG 4, L > 80):
// per query tile, over 64-key tiles of pbar (boxes [64][64], one at a time),
// dP, dS and dQ; then per key tile, over query tiles, dP and dS again into a
// dS tile, and dV, dK. Writes the head's dq, dk, dv columns of dqkv [B, L,
// 3D] and the frame's column sums of the f32 gradients to part[b][3D].
template <int DH, int NG, bool RES>
__global__ void __launch_bounds__(128) wg_attention_bwd_stash(
    const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap pbar_map, const bf16* __restrict__ attn,
    bf16* __restrict__ dqkv, float* __restrict__ part, int L, int D, int H, float scale2,
    float dq_scale, float dk_scale) {
  constexpr int SPAN = DH * 2;
  extern __shared__ unsigned char wa_raw[];
  unsigned char* smem = wa_raw + ((1024 - (smem_u32(wa_raw) & 1023)) & 1023);
  const int R = bwd_rows(L), box = box_rows_of(R), n_kc = (R + 63) / 64;
  const uint32_t chunk = RES ? R * 128 : PLANE_CHUNK;
  unsigned char* qs = smem;
  unsigned char* ks = qs + R * SPAN;
  unsigned char* vs = ks + R * SPAN;
  unsigned char* dos = vs + R * SPAN;
  unsigned char* pl = dos + R * SPAN;
  float* red = reinterpret_cast<float*>(pl + (RES ? n_kc * chunk : 2 * PLANE_CHUNK));
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + ATTN_WARPS * 3 * DH);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init_fence();
    mbar_expect_tx(&bar[0], 4 * R * SPAN + (RES ? n_kc * chunk : 0));
    for (int r = 0; r < R; r += box) {
      tma_load_3d(qs + r * SPAN, &qkv_map, &bar[0], h * DH, r, b);
      tma_load_3d(ks + r * SPAN, &qkv_map, &bar[0], D + h * DH, r, b);
      tma_load_3d(vs + r * SPAN, &qkv_map, &bar[0], 2 * D + h * DH, r, b);
      tma_load_3d(dos + r * SPAN, &do_map, &bar[0], h * DH, r, b);
    }
    if (RES)
      for (int c = 0; c < n_kc; ++c) tma_load_3d(pl + c * chunk, &pbar_map, &bar[0], 64 * c, 0, bh);
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row3 = 3LL * D;
  const bf16* o_head = attn + (long long)b * L * D + h * DH;
  bf16* out_base = dqkv + (long long)b * L * row3 + h * DH + 2 * t;
  const uint32_t qs_a = smem_u32(qs), ks_a = smem_u32(ks), vs_a = smem_u32(vs);
  const uint32_t dos_a = smem_u32(dos), pl_a = smem_u32(pl);
  mbar_wait(&bar[0], 0);
  for (int i = threadIdx.x; i < R * DH / 8; i += 128) {  // q -> bf16(q scale2)
    uint4* p = reinterpret_cast<uint4*>(qs) + i;
    uint4 v = *p;
    v.x = scale_pair(v.x, scale2);
    v.y = scale_pair(v.y, scale2);
    v.z = scale_pair(v.z, scale2);
    v.w = scale_pair(v.w, scale2);
    *p = v;
  }
  fence_proxy_async();
  __syncthreads();

  if constexpr (RES) {
    const int n_k = R / 16;  // 16-query steps of the dV and dK products
    {  // dV = pbar^T dO, per key chunk
      float cs[DH / 8][2] = {};
      for (int c = 0; c < n_kc; ++c) {
        float acc[DH / 2] = {};
        wgmma_fence();
        issue_tile_t_rows<DH>(acc, pl_a + c * chunk, dos_a, n_k);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<DH / 2>(acc);
        const int k_lo = 64 * c + 16 * warp + g;
        store_rows<DH>(reinterpret_cast<float(*)[4]>(acc), 1.f, out_base, k_lo, k_lo + 8, L, row3,
                       2 * D, cs);
      }
      park_column_sums<DH>(cs, red, 2);
    }
    __syncthreads();  // every warp's dV products have read pbar: dS may replace it
    {  // per query tile: dP, dS over pbar, dQ
      float cs[DH / 8][2] = {};
      for (int q0 = 0; q0 < L; q0 += WG_T) {
        const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
        const bool live = q0 + 16 * warp < L;
        uint32_t da[DH / 16][4], oa[DH / 16][4];
        tile_frags<DH>(da, oa, dos, o_head, D, r_lo, L, t, live);
        float dp[NG][8];
        times_rows_t<DH, NG>(dp, da, vs_a);
        float d_lo, d_hi;
        row_terms<DH>(da, oa, d_lo, d_hi);
        uint32_t dsa[NG][4];
        tile_ds<NG>(dp, dsa, pl, pl, chunk, r_lo, 0, 0, L, d_lo, d_hi, t, live, false);
        float acc[DH / 2] = {};
        times_rows<DH, NG>(acc, dsa, ks_a);
        store_rows<DH>(reinterpret_cast<float(*)[4]>(acc), dq_scale, out_base, r_lo, r_hi, L,
                       row3, 0, cs);
      }
      park_column_sums<DH>(cs, red, 0);
    }
    fence_proxy_async();
    __syncthreads();  // dS is whole in the plane
    {  // dK = dS^T Qs, per key chunk
      float cs[DH / 8][2] = {};
      for (int c = 0; c < n_kc; ++c) {
        float acc[DH / 2] = {};
        wgmma_fence();
        issue_tile_t_rows<DH>(acc, pl_a + c * chunk, qs_a, n_k);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<DH / 2>(acc);
        const int k_lo = 64 * c + 16 * warp + g;
        store_rows<DH>(reinterpret_cast<float(*)[4]>(acc), dk_scale, out_base, k_lo, k_lo + 8, L,
                       row3, D, cs);
      }
      park_column_sums<DH>(cs, red, 1);
    }
  } else {
    unsigned char* pt = pl;                  // the pbar tile (i, c)
    unsigned char* dt = pl + PLANE_CHUNK;    // its dS
    const uint32_t pt_a = pl_a, dt_a = pl_a + PLANE_CHUNK;
    const int n_qt = (L + WG_T - 1) / WG_T;
    uint32_t phase = 0;
    // pbar of query tile i and key tile c into pt, once every thread is done
    // with what it held
    auto load_pbar = [&](int i, int c) {
      __syncthreads();
      if (threadIdx.x == 0) {
        mbar_expect_tx(&bar[1], PLANE_CHUNK);
        tma_load_3d(pt, &pbar_map, &bar[1], 64 * c, 64 * i, bh);
      }
      mbar_wait(&bar[1], phase);
      phase ^= 1;
    };
    {  // dQ, per query tile over the key tiles
      float cs[DH / 8][2] = {};
      for (int i = 0; i < n_qt; ++i) {
        const int r_lo = 64 * i + 16 * warp + g, r_hi = r_lo + 8;
        const bool live = 64 * i + 16 * warp < L;
        uint32_t da[DH / 16][4], oa[DH / 16][4];
        tile_frags<DH>(da, oa, dos, o_head, D, r_lo, L, t, live);
        float d_lo, d_hi;
        row_terms<DH>(da, oa, d_lo, d_hi);
        float acc[DH / 2] = {};
        for (int c = 0; c < n_kc; ++c) {
          load_pbar(i, c);
          float dp[NG][8];
          times_rows_t<DH, NG>(dp, da, vs_a + 64 * c * SPAN);
          uint32_t dsa[NG][4];
          tile_ds<NG>(dp, dsa, pt, nullptr, PLANE_CHUNK, 16 * warp + g, 0, 64 * c, L, d_lo, d_hi,
                      t, live, false);
          times_rows<DH, NG>(acc, dsa, ks_a + 64 * c * SPAN);
        }
        store_rows<DH>(reinterpret_cast<float(*)[4]>(acc), dq_scale, out_base, r_lo, r_hi, L,
                       row3, 0, cs);
      }
      park_column_sums<DH>(cs, red, 0);
    }
    {  // dK and dV, per key tile over the query tiles
      float cs_k[DH / 8][2] = {}, cs_v[DH / 8][2] = {};
      for (int c = 0; c < n_kc; ++c) {
        float dk[DH / 2] = {}, dv[DH / 2] = {};
        for (int i = 0; i < n_qt; ++i) {
          const int r_lo = 64 * i + 16 * warp + g;
          const bool live = 64 * i + 16 * warp < L;
          uint32_t da[DH / 16][4], oa[DH / 16][4];
          tile_frags<DH>(da, oa, dos, o_head, D, r_lo, L, t, live);
          float d_lo, d_hi;
          row_terms<DH>(da, oa, d_lo, d_hi);
          load_pbar(i, c);
          float dp[NG][8];
          times_rows_t<DH, NG>(dp, da, vs_a + 64 * c * SPAN);
          uint32_t dsa[NG][4];
          tile_ds<NG>(dp, dsa, pt, dt, PLANE_CHUNK, 16 * warp + g, 0, 64 * c, L, d_lo, d_hi, t,
                      live, true);
          fence_proxy_async();
          __syncthreads();  // the dS tile is whole
          wgmma_fence();
          issue_tile_t_rows<DH>(dv, pt_a, dos_a + 64 * i * SPAN, 4);
          issue_tile_t_rows<DH>(dk, dt_a, qs_a + 64 * i * SPAN, 4);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<DH / 2>(dk);
          fence_regs<DH / 2>(dv);
        }
        const int k_lo = 64 * c + 16 * warp + g;
        store_rows<DH>(reinterpret_cast<float(*)[4]>(dk), dk_scale, out_base, k_lo, k_lo + 8, L,
                       row3, D, cs_k);
        store_rows<DH>(reinterpret_cast<float(*)[4]>(dv), 1.f, out_base, k_lo, k_lo + 8, L, row3,
                       2 * D, cs_v);
      }
      park_column_sums<DH>(cs_k, red, 1);
      park_column_sums<DH>(cs_v, red, 2);
    }
  }
  store_column_sums<DH>(red, part + (long long)b * row3 + h * DH, D);
}

// ---------------------------------------------------------------------------
// K3's attention passes on wgmma: the forward that writes the row stats, the
// backward that forms pbar from them once (see the header)
// ---------------------------------------------------------------------------

constexpr int RECOMPUTE_ROWS = 144;  // the wgmma passes hold round16(L) <= 144 keys

// Whether K3's passes run on wgmma at L tokens (round16(L) <= 144; past it
// the mma.sync passes), and their 16-key groups: the least of 2, 4, 5 and 9
// that covers round16(L). A 64-query tile's scores over all 16 NG keys stay
// in registers; the backward holds q, k, v, dO and a pbar plane of 16 NG
// rows.
__host__ __device__ inline bool recompute_wgmma(int L) { return round16(L) <= RECOMPUTE_ROWS; }
__host__ __device__ inline int recompute_groups(int L) {
  const int r = round16(L);
  return r <= 32 ? 2 : r <= 64 ? 4 : r <= 80 ? 5 : 9;
}
// The forward takes the wgmma pass too, but at d_head 16 past 80 keys (NG
// 9: the ViT flagship's 129 tokens), where train_attention_fwd measured
// faster (0.5837-0.5881 against 0.6506-0.6524 ms at B = 4096, H = 8: the
// routing experiment of ops/cuda/variants.py, PERF.md): its many small
// blocks hide more latency than the wgmma pass's 3 an SM, which the NG 9
// score tile's 72 f32 registers a thread (138 in all) keep there.
__host__ __device__ constexpr bool rc_fwd_built(int dh, int ng) { return !(dh == 16 && ng == 9); }
__host__ __device__ inline bool recompute_fwd_wgmma(int L, int dh) {
  return recompute_wgmma(L) && rc_fwd_built(dh, recompute_groups(L));
}

// The backward's warpgroups a block: at NG 9 past d_head 16 three, each
// taking 3 of a query tile's 9 key groups (one warpgroup a block held
// vit_tpu_production's 133 KB block to 4 warps an SM, too few to hide the
// pass's latency), else one (at the ViT flagship's shape one warpgroup, 3
// blocks an SM, measured faster than three in 2: the warpgroups experiment
// of ops/cuda/variants.py, PERF.md).
__host__ __device__ constexpr int rc_bwd_warpgroups(int dh, int ng) {
  return ng == 9 && dh > 16 ? 3 : 1;
}
// ... and the blocks an SM its registers must allow, as many as its shared
// memory allows where the unbounded registers held fewer: at d_head 16
// three of one warpgroup at NG 9 (170 registers held 2) and six at NG up
// to 5 (79-87 held 5); two of three warpgroups at d_head 32 (registers then
// at most 84 a thread); else what the shared memory and registers give.
__host__ __device__ constexpr int rc_bwd_min_blocks(int dh, int ng) {
  return ng == 9 ? (dh == 16 ? 3 : dh == 32 ? 2 : 1) : dh == 16 ? 6 : 1;
}
// Shared memory, the 1 KB of alignment included. Forward: two buffers of q,
// k and v rows [16 NG][DH], each rounded up to 1 KB, two mbarriers.
// Backward: q (scaled in place), k, v and dO rows [16 NG][DH], the pbar
// plane of ceil(16 NG / 64) key chunks [16 NG][64] (overwritten by dS), the
// column-sum scratch [4 WGS warps][3][DH], the row terms [16 NG] and the dQ
// partials of warpgroups 1.. [WGS - 1][64][DH] (f32), and an mbarrier.
// fused_layer_train.recompute_attention_fwd_smem_bytes and
// recompute_attention_bwd_smem_bytes repeat these formulas.
__host__ __device__ inline size_t rc_fwd_smem_bytes(int L, int dh) {
  const int kr = 16 * recompute_groups(L);
  return 1024 + 2 * (((size_t)6 * kr * dh + 1023) / 1024 * 1024) + 16;
}
__host__ __device__ inline size_t rc_bwd_smem_bytes(int L, int dh) {
  const int ng = recompute_groups(L), r = 16 * ng, wgs = rc_bwd_warpgroups(dh, ng);
  return 1024 + (size_t)8 * r * dh + (size_t)(r + 63) / 64 * r * 128 +
         (size_t)4 * wgs * 3 * dh * 4 + (size_t)r * 4 + (size_t)(wgs - 1) * WG_T * dh * 4 + 16;
}

// K3's attention forward (K3-fwd's, and the recompute's in K3-bwd): the
// function of train_attention_fwd on wgmma. Persistent blocks of one
// warpgroup take the frame-heads (frame b, head h) = item b H + h, items
// blockIdx.x, blockIdx.x + gridDim.x, ... (n_items = B H); an item's q, k
// and v (qkv_map: boxes of DH columns and 16 NG rows; rows past L read as 0)
// arrive by TMA in one of two buffers, the next item's while this one is
// computed. Per 64-query tile: q's A fragments bf16(q scale2), the scores of
// all keys in registers (NG m64n16 groups), the row max m over the keys <
// L, p = bf16(exp2(s - m)) (MUFU.EX2) packed into the A fragments of P V,
// l = the f32 sum of the rounded p, attn = bf16(P V / l) (quant_div, no
// divide). Warps with no row < L skip the softmax work (they issue the
// wgmma). With `stats`, each row's (m, l) to stats[((b H + h) L + i) 2 + {0,
// 1}].
template <int DH, int NG>
__global__ void __launch_bounds__(128) wg_recompute_attention_fwd(
    const __grid_constant__ CUtensorMap qkv_map, bf16* __restrict__ out, float* __restrict__ stats,
    int L, int D, int H, int n_items, float scale2) {
  constexpr int SPAN = DH * 2;
  constexpr uint32_t SEC = 16 * NG * SPAN;         // one section's rows: q, k or v
  constexpr uint32_t BUF = (3 * SEC + 1023) & ~1023u;  // the swizzle's 1 KB repeat
  extern __shared__ unsigned char wa_raw[];
  unsigned char* smem = wa_raw + ((1024 - (smem_u32(wa_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * BUF);
  auto load = [&](int item, int buf) {  // one thread
    const int b = item / H, h = item % H;
    mbar_expect_tx(&full[buf], 3 * SEC);
    for (int sec = 0; sec < 3; ++sec)  // q, k, v
      tma_load_3d(smem + buf * BUF + sec * SEC, &qkv_map, &full[buf], sec * D + h * DH, 0, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init_fence();
    for (int u = 0; u < 2 && blockIdx.x + u * gridDim.x < n_items; ++u)
      load(blockIdx.x + u * gridDim.x, u);
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int u = 0;
  for (int bh = blockIdx.x; bh < n_items; bh += gridDim.x, ++u) {
    const int b = bh / H, h = bh % H;
    const unsigned char* qs = smem + (u & 1) * BUF;
    const uint32_t k_addr = smem_u32(qs + SEC), v_addr = smem_u32(qs + 2 * SEC);
    bf16* o_base = out + (long long)b * L * D + h * DH + 2 * t;
    float* st = stats ? stats + (long long)bh * L * 2 : nullptr;
    mbar_wait(&full[u & 1], (u >> 1) & 1);
    for (int q0 = 0; q0 < L; q0 += WG_T) {
      const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
      const bool live = q0 + 16 * warp < L;  // the warp holds a row < L (warp-uniform)
      uint32_t qa[DH / 16][4];
      if (live) {
        smem_frags<DH>(qa, qs, r_lo, t);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[kk][i] = scale_pair(qa[kk][i], scale2);
      } else {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[kk][i] = 0u;
      }
      float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
      float o[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      float s[NG][8];
      times_rows_t<DH, NG>(s, qa, k_addr);
      uint32_t pa[NG][4];
      if (live) {
        tile_max<NG>(s, 0, L, t, m_lo, m_hi);
        m_lo = quad_max(m_lo);
        m_hi = quad_max(m_hi);
        tile_probs<NG>(s, pa, 0, L, t, m_lo, m_hi, l_lo, l_hi);
      } else {
#pragma unroll
        for (int grp = 0; grp < NG; ++grp)
#pragma unroll
          for (int i = 0; i < 4; ++i) pa[grp][i] = 0u;
      }
      times_rows<DH, NG>(o, pa, v_addr);
      if (live) {
        l_lo = quad_sum(l_lo);
        l_hi = quad_sum(l_hi);
        const float y_lo = rcp_rn(l_lo), y_hi = rcp_rn(l_hi);
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          if (r_lo < L)
            *reinterpret_cast<uint32_t*>(o_base + (long long)r_lo * D + j * 8) =
                pack_bf16x2(quant_div(o[4 * j], l_lo, y_lo), quant_div(o[4 * j + 1], l_lo, y_lo));
          if (r_hi < L)
            *reinterpret_cast<uint32_t*>(o_base + (long long)r_hi * D + j * 8) =
                pack_bf16x2(quant_div(o[4 * j + 2], l_hi, y_hi),
                            quant_div(o[4 * j + 3], l_hi, y_hi));
        }
        if (st && t == 0) {
          if (r_lo < L) *reinterpret_cast<float2*>(st + 2 * r_lo) = make_float2(m_lo, l_lo);
          if (r_hi < L) *reinterpret_cast<float2*>(st + 2 * r_hi) = make_float2(m_hi, l_hi);
        }
      }
    }
    __syncthreads();  // every warp is done with the buffer, which takes the item after next
    if (threadIdx.x == 0 && bh + 2 * gridDim.x < n_items) load(bh + 2 * gridDim.x, u & 1);
  }
}

// The f32 dot product of eight bf16 pairs in two 16-byte units
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[i]));
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y[i]));
    d += u.x * v.x + u.y * v.y;
  }
  return d;
}

// pbar = bf16(bf16(exp2(s - m)) / l) of a warp's 16 query rows over NG
// groups of 16 keys from key0 on, from their scores (MUFU.EX2; the quotient IEEE's without
// a divide, div_pair: cheaper here than mul_pair's product and its midpoint
// test), 0 for keys >= L and rows >= L, written into the plane at its rows
// r_lo, r_lo + 8 (key chunks chunk_bytes apart).
template <int NG>
__device__ __forceinline__ void tile_pbar(const float (*s)[8], unsigned char* pl,
                                          uint32_t chunk_bytes, int r_lo, int key0, int L, int t,
                                          float m_lo, float m_hi, float l_lo, float l_hi) {
  const float y_lo = rcp_rn(l_lo), y_hi = rcp_rn(l_hi);
  const bool in_lo = r_lo < L, in_hi = r_lo + 8 < L;
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
    const int left = L - key0 - 16 * grp;  // keys of the group below L
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool hi = i & 1, row_in = hi ? in_hi : in_lo;
      const float m = hi ? m_hi : m_lo;
      const int e = 2 * i;  // accumulators e, e + 1: keys 16 grp + 8 (i / 2) + 2t, + 1
      const float p0 = row_in && (left >= 16 || key_in(e, t, left)) ? exp2_sfu(s[grp][e] - m) : 0.f;
      const float p1 =
          row_in && (left >= 16 || key_in(e + 1, t, left)) ? exp2_sfu(s[grp][e + 1] - m) : 0.f;
      *reinterpret_cast<uint32_t*>(
          pl + plane_off(r_lo + 8 * hi, key0 + 16 * grp + 8 * (i >> 1) + 2 * t, chunk_bytes)) =
          div_pair(pack_bf16x2(p0, p1), hi ? l_hi : l_lo, hi ? y_hi : y_lo);
    }
  }
}

// The rows (keys) of Plane^T Rows for key chunks c0, c0 + step, ... < n_kc of
// the plane (chunk_bytes apart from `plane`), one chunk at a time, read as
// the MN-major A over N_K 16-query steps, Rows [queries][DH] the MN-major B:
// dV (Rows dO) and dK (Rows Qs), scaled and stored at column offset `col` of
// dqkv with their column sums (k_lo the thread's lo row in a chunk).
template <int DH, int N_K>
__device__ __forceinline__ void tile_t_rows_chunks(uint32_t plane, uint32_t chunk_bytes, int c0,
                                                   int n_kc, int step, uint32_t rows,
                                                   bf16* out_base, int k_lo, int L,
                                                   long long row3, int col, float scale,
                                                   float cs[DH / 8][2]) {
  for (int c = c0; c < n_kc; c += step) {
    float acc[DH / 2] = {};
    wgmma_fence();
    issue_tile_t_rows<DH>(acc, plane + c * chunk_bytes, rows, N_K);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DH / 2>(acc);
    const int r = 64 * c + k_lo;
    store_rows<DH>(reinterpret_cast<float(*)[4]>(acc), scale, out_base, r, r + 8, L, row3, col,
                   cs);
  }
}

// K3-bwd's attention, one block of WGS warpgroups (rc_bwd_warpgroups) per
// (frame b, head h) = blockIdx.x: the outputs of train_attention_bwd, with
// pbar formed once in the kernel from the forward's row stats. q, k, v
// (qkv_map) and dO (do_map, over dattn [B, L, D]) arrive by TMA in boxes of
// DH columns and R = 16 NG rows (rows past L read as 0); q is scaled in
// place, and the row terms dO_i . O_i are formed once (O read from attn [B,
// L, D] in 16-byte units) and kept in shared memory. Then per 64-query tile
// S = Qs K^T (one wgmma a 16-key group) and pbar = bf16(bf16(exp2(s - m)) /
// l) into the plane [R queries][64-key chunks] (rows and keys >= L 0), and
// K4's resident sequence on it: dV = pbar^T dO per key chunk (the plane as
// an MN-major A); per query tile dP = dO V^T, dS = bf16(pbar (dP - row))
// over pbar in the plane, dQ = dS K; dK = dS^T Qs per key chunk. Warpgroup
// w takes key groups [w NG / WGS, (w + 1) NG / WGS) of every query tile, and
// key chunks w, w + WGS, ... of dV and dK; the dQ partials of warpgroups 1..
// meet warpgroup 0's through shared memory, added in that order. Writes the
// head's dq, dk, dv columns of dqkv [B, L, 3D] and the frame's column sums
// of the f32 gradients to part[b][3D].
template <int DH, int NG>
__global__ void __launch_bounds__(128 * rc_bwd_warpgroups(DH, NG), rc_bwd_min_blocks(DH, NG))
    wg_recompute_attention_bwd(const __grid_constant__ CUtensorMap qkv_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const bf16* __restrict__ attn, const float* __restrict__ stats,
                               bf16* __restrict__ dqkv, float* __restrict__ part, int L, int D,
                               int H, float scale2, float dq_scale, float dk_scale) {
  constexpr int SPAN = DH * 2;
  constexpr int R = 16 * NG;           // rows of q, k, v, dO and the plane
  constexpr int N_KC = (R + 63) / 64;  // key chunks of the plane
  constexpr uint32_t CHUNK = R * 128;  // a key chunk [R queries][64 keys]
  constexpr int WGS = rc_bwd_warpgroups(DH, NG), NGW = NG / WGS, THREADS_ = 128 * WGS;
  static_assert(NG % WGS == 0, "the key groups split evenly over the warpgroups");
  extern __shared__ unsigned char wa_raw[];
  unsigned char* smem = wa_raw + ((1024 - (smem_u32(wa_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* ks = qs + R * SPAN;
  unsigned char* vs = ks + R * SPAN;
  unsigned char* dos = vs + R * SPAN;
  unsigned char* pl = dos + R * SPAN;
  float* red = reinterpret_cast<float*>(pl + N_KC * CHUNK);  // [4 WGS warps][3][DH]
  float* row_s = red + 4 * WGS * 3 * DH;                     // dO_i . O_i
  float* dq_part = row_s + R;  // [WGS - 1][DH / 2][128]: a thread's accumulators, i-major
  uint64_t* bar = reinterpret_cast<uint64_t*>(dq_part + (WGS - 1) * WG_T * DH);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init_fence();
    mbar_expect_tx(&bar[0], 4 * R * SPAN);
    tma_load_3d(qs, &qkv_map, &bar[0], h * DH, 0, b);
    tma_load_3d(ks, &qkv_map, &bar[0], D + h * DH, 0, b);
    tma_load_3d(vs, &qkv_map, &bar[0], 2 * D + h * DH, 0, b);
    tma_load_3d(dos, &do_map, &bar[0], h * DH, 0, b);
  }
  __syncthreads();
  const int wid = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int wg = WGS > 1 ? wid >> 2 : 0, warp = wid & 3;  // the warpgroup, the warp in it
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x & 127;
  const int key0 = 16 * NGW * wg;  // the warpgroup's first key
  const long long row3 = 3LL * D;
  const bf16* o_head = attn + (long long)b * L * D + h * DH;
  const float* st = stats + (long long)bh * L * 2;
  bf16* out_base = dqkv + (long long)b * L * row3 + h * DH + 2 * t;
  const uint32_t qs_a = smem_u32(qs), ks_a = smem_u32(ks), vs_a = smem_u32(vs);
  const uint32_t dos_a = smem_u32(dos), pl_a = smem_u32(pl);
  mbar_wait(&bar[0], 0);
  for (int i = threadIdx.x; i < R * DH / 8; i += THREADS_) {  // q -> bf16(q scale2)
    uint4* p = reinterpret_cast<uint4*>(qs) + i;
    uint4 v = *p;
    v.x = scale_pair(v.x, scale2);
    v.y = scale_pair(v.y, scale2);
    v.z = scale_pair(v.z, scale2);
    v.w = scale_pair(v.w, scale2);
    *p = v;
  }
  for (int r = threadIdx.x; r < R; r += THREADS_) {  // the row terms, O in 16-byte units
    float d = 0.f;
    if (r < L)
#pragma unroll
      for (int u = 0; u < DH / 8; ++u) {
        uint32_t off = (uint32_t)(r * SPAN + 16 * u);
        off ^= ((off >> 7) & (SPAN / 16 - 1)) << 4;  // dO's unit, swizzled as TMA wrote it
        d += dot8(*reinterpret_cast<const uint4*>(dos + off),
                  *reinterpret_cast<const uint4*>(o_head + (long long)r * D + 8 * u));
      }
    row_s[r] = d;
  }
  fence_proxy_async();
  __syncthreads();

  // pbar into the plane, per query tile over the plane's R rows: warps with
  // a row < L from the scores of the warpgroup's keys, the plane's other rows
  // 0
  for (int q0 = 0; q0 < R; q0 += WG_T) {
    const int r_lo = q0 + 16 * warp + g;
    const bool live = q0 + 16 * warp < L;
    // the rows' (m, l), loaded while the scores are formed
    const float2 lo = live && r_lo < L ? *reinterpret_cast<const float2*>(st + 2 * r_lo)
                                       : make_float2(0.f, 1.f);
    const float2 hi = live && r_lo + 8 < L ? *reinterpret_cast<const float2*>(st + 2 * (r_lo + 8))
                                           : make_float2(0.f, 1.f);
    float s[NGW][8];
    if (q0 < L) {  // block-uniform
      uint32_t qa[DH / 16][4];
      if (live) {
        smem_frags<DH>(qa, qs, r_lo, t);
      } else {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[kk][i] = 0u;
      }
      times_rows_t_wide<DH, NGW>(s, qa, ks_a + key0 * SPAN);
    }
    if (live) {
      tile_pbar<NGW>(s, pl, CHUNK, r_lo, key0, L, t, lo.x, hi.x, lo.y, hi.y);
    } else if (q0 + 16 * warp < R) {
#pragma unroll
      for (int c = 0; c < 16 * NGW; c += 8)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(pl + plane_off(r_lo + 8 * i, key0 + c + 2 * t, CHUNK)) = 0u;
    }
  }
  fence_proxy_async();
  __syncthreads();  // the pbar plane is whole

  constexpr int N_K = R / 16;  // 16-query steps of the dV and dK products
  {  // dV = pbar^T dO
    float cs[DH / 8][2] = {};
    tile_t_rows_chunks<DH, N_K>(pl_a, CHUNK, wg, N_KC, WGS, dos_a, out_base, 16 * warp + g, L,
                                row3, 2 * D, 1.f, cs);
    park_column_sums<DH>(cs, red, 2);
  }
  __syncthreads();  // every warp's dV products have read pbar: dS may replace it
  {  // per query tile: dP, dS over pbar, dQ
    float cs[DH / 8][2] = {};
    for (int q0 = 0; q0 < L; q0 += WG_T) {
      const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
      const bool live = q0 + 16 * warp < L;
      uint32_t da[DH / 16][4];
      if (live) {
        smem_frags<DH>(da, dos, r_lo, t);
      } else {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) da[kk][i] = 0u;
      }
      const float d_lo = live ? row_s[r_lo] : 0.f, d_hi = live ? row_s[r_hi] : 0.f;
      float dp[NGW][8];
      times_rows_t_wide<DH, NGW>(dp, da, vs_a + key0 * SPAN);
      uint32_t dsa[NGW][4];
      tile_ds<NGW>(dp, dsa, pl, pl, CHUNK, r_lo, key0, key0, L, d_lo, d_hi, t, live, false);
      float acc[DH / 2] = {};
      times_rows<DH, NGW>(acc, dsa, ks_a + key0 * SPAN);
      if constexpr (WGS > 1) {  // the partials meet warpgroup 0's, added in order
        if (wg > 0)
#pragma unroll
          for (int i = 0; i < DH / 2; ++i) dq_part[((wg - 1) * (DH / 2) + i) * 128 + tid] = acc[i];
        named_bar_sync(1, THREADS_);
        if (wg == 0)
#pragma unroll
          for (int w = 0; w < WGS - 1; ++w)
#pragma unroll
            for (int i = 0; i < DH / 2; ++i) acc[i] += dq_part[(w * (DH / 2) + i) * 128 + tid];
        named_bar_sync(2, THREADS_);  // the partials are read: the next tile's may follow
      }
      if (wg == 0)
        store_rows<DH>(reinterpret_cast<float(*)[4]>(acc), dq_scale, out_base, r_lo, r_hi, L,
                       row3, 0, cs);
    }
    park_column_sums<DH>(cs, red, 0);
  }
  fence_proxy_async();
  __syncthreads();  // dS is whole in the plane
  {  // dK = dS^T Qs
    float cs[DH / 8][2] = {};
    tile_t_rows_chunks<DH, N_K>(pl_a, CHUNK, wg, N_KC, WGS, qs_a, out_base, 16 * warp + g, L,
                                row3, D, dk_scale, cs);
    park_column_sums<DH>(cs, red, 1);
  }
  store_column_sums<DH, 4 * WGS>(red, part + (long long)b * row3 + h * DH, D);
}

// ---------------------------------------------------------------------------
// LN2 backward and the fixed-order column reductions
// ---------------------------------------------------------------------------

// One warp per row (DW = D columns, DW / 32 per lane), 64 rows per block:
// dz = rstd * (dy*g - mean(dy*g) - xh * mean(dy*g*xh)), df = dz * mask.
// Writes df (bf16) and dz (f32, the gradient reaching x1 through the
// residual) and the block's column sums of dy*xh, dy and df to
// part[sum][block][D]. xh is f32 (K3's recompute) or bf16 (K4's stash).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <class XH, int DW>
__global__ void __launch_bounds__(THREADS) ln_bwd_rows(
    const bf16* __restrict__ dy, const XH* __restrict__ xh, const float* __restrict__ rstd,
    const float* __restrict__ gamma, Drop drop, long long M, bf16* __restrict__ df_out,
    float* __restrict__ dz_out, float* __restrict__ part) {
  constexpr int PER_LANE = DW / 32;
  __shared__ float red[THREADS / 32][3][DW];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long m0 = (long long)blockIdx.x * ROW_TILE, RT = gridDim.x;
  float cs[3][PER_LANE] = {};
  const uint32_t ss = drop.on ? seed_salt(drop) : 0u;
  for (int r = warp; r < ROW_TILE; r += THREADS / 32) {
    const long long gm = m0 + r;
    if (gm >= M) break;
    const long long row = gm * DW;
    float d[PER_LANE], x[PER_LANE], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int c = lane + 32 * t;
      d[t] = __bfloat162float(dy[row + c]);
      x[t] = to_f32(xh[row + c]);
      const float dyg = d[t] * gamma[c];
      s1 += dyg;
      s2 += dyg * x[t];
      cs[0][t] += d[t] * x[t];
      cs[1][t] += d[t];
    }
    const float m1 = warp_sum(s1) * (1.0f / DW), m2 = warp_sum(s2) * (1.0f / DW);
    const float rr = rstd[gm];
    const uint32_t mix = drop.on ? row_mix(drop, gm) : 0u;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int c = lane + 32 * t;
      const float dz = rr * (d[t] * gamma[c] - m1 - x[t] * m2);
      const float df = drop.on ? dz * keep_of(drop, ss, mix, c) : dz;
      cs[2][t] += df;
      dz_out[row + c] = dz;
      df_out[row + c] = __float2bfloat16(df);
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) red[warp][s][lane + 32 * t] = cs[s][t];
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * DW; i += THREADS) {
    const int s = i / DW, c = i % DW;
    float sum = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) sum += red[w][s][c];
    part[(s * RT + blockIdx.x) * DW + c] = sum;
  }
}

// K4-bwd's x1 = bf16(f32(xh1) * g1 + be1) from the stashed bf16 xh1 (rows of
// D columns), multiply and add rounded separately, as the plain version.
__global__ void __launch_bounds__(THREADS) rebuild_ln_out(const bf16* __restrict__ xh,
                                                         const float* __restrict__ gamma,
                                                         const float* __restrict__ beta,
                                                         long long n, int D,
                                                         bf16* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const int c = (int)(i % D);
    out[i] = __float2bfloat16(__fadd_rn(__fmul_rn(__bfloat162float(xh[i]), gamma[c]), beta[c]));
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

// f(std::integral_constant<int, W>{}) at d_model W = D (64, 128 or 256; what
// shapes_ok admits)
template <class F>
auto with_d(int D, F f) -> decltype(f(std::integral_constant<int, 256>{})) {
  if (D == 256) return f(std::integral_constant<int, 256>{});
  if (D == 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 64>{});
}

#define VITIQ_TRY(expr)                      \
  do {                                       \
    const cudaError_t err_ = (expr);         \
    if (err_ != cudaSuccess) return err_;    \
  } while (0)

// The stage instances the layers reach at the shapes shapes_ok admits: W
// resident where K <= 256 (K = D: QKV, FFN1, the out-projection and its
// input gradient, FFN2's input gradient; K = F or 3D at F <= 256 or D = 64),
// except the 256-wide LayerNorm stages; streamed where K > 256 (FFN2, FFN1's
// input gradient with LN1's backward, the QKV input gradient at D >= 128)
// and for every weight gradient; LN1's backward once for K3's f32 xh and
// once for K4's bf16 xh.
__host__ __device__ constexpr bool stage_built(int epi, int bn, bool resident) {
  if (epi == kPartial) return !resident;
  if (is_ln(epi)) return resident ? bn != 256 : true;
  if (epi == kResOut) return resident ? bn == 64 : bn != 64;
  return resident;
}

// One stage over n_cols columns in BN-wide slabs: TMA maps of A and B (128-
// byte swizzle, 64-element boxes; see gemm_wgmma.cuh) and up to one block an
// SM. Returns the error of a map cuTensorMapEncodeTiled refuses, of the
// shared-memory opt-in or of the launch.
template <int EPI, int BN, bool RESIDENT, bool XH16>
cudaError_t launch_stage(Stage p, long long n_cols, cudaStream_t st) {
  constexpr int extra = stage_extra(EPI, BN);
  p.n_tiles = (int)(n_cols / BN);
  const int ring = gemm_ring(RESIDENT, BN, p.k, extra);
  if (n_cols % BN || p.k % 64 || !ring) return cudaErrorInvalidValue;
  const uint32_t tm = RESIDENT ? 64 : 128;
  uint64_t a_dims[2], b_dims[2];
  uint32_t a_box[2] = {64, a_transposed(EPI) ? 64u : tm}, b_box[2];
  if (a_transposed(EPI)) {  // act [depth][m]
    a_dims[0] = (uint64_t)p.m;
    a_dims[1] = (uint64_t)p.depth;
  } else {  // A [m][k]
    a_dims[0] = (uint64_t)p.k;
    a_dims[1] = (uint64_t)p.m;
  }
  if (b_mn_major(EPI)) {  // W [k][n_cols] or the gradient [depth][n_cols]
    b_dims[0] = (uint64_t)n_cols;
    b_dims[1] = (uint64_t)(a_transposed(EPI) ? p.depth : p.k);
    b_box[0] = 64;
    b_box[1] = RESIDENT ? (uint32_t)p.k : 64u;
  } else {  // W [n_cols][k]
    b_dims[0] = (uint64_t)p.k;
    b_dims[1] = (uint64_t)n_cols;
    b_box[0] = 64;
    b_box[1] = BN;
  }
  const uint64_t a_str[1] = {(uint64_t)p.lda}, b_str[1] = {(uint64_t)p.ldb};
  CUtensorMap a_map, b_map;
  if (!make_map(&a_map, p.a, 2, a_dims, a_str, a_box, 128) ||
      !make_map(&b_map, p.b, 2, b_dims, b_str, b_box, 128))
    return cudaErrorInvalidValue;
  const int smem = gemm_smem_bytes(RESIDENT, BN, p.k, ring, extra);
  VITIQ_TRY(allow_smem(train_gemm_kernel<EPI, BN, RESIDENT, XH16>, smem));
  const long long n_work = (p.m + tm - 1) / tm * p.splits;
  train_gemm_kernel<EPI, BN, RESIDENT, XH16>
      <<<gw_blocks(n_work, p.n_tiles), GW_THREADS, smem, st>>>(a_map, b_map, p, ring);
  return cudaGetLastError();
}

template <int EPI, int BN, bool XH16>
cudaError_t launch_stage_xh(const Stage& p, long long n_cols, cudaStream_t st) {
  const bool resident = p.k <= 256 && stage_built(EPI, BN, true);
  if constexpr (stage_built(EPI, BN, true))
    if (resident) return launch_stage<EPI, BN, true, XH16>(p, n_cols, st);
  if constexpr (stage_built(EPI, BN, false))
    if (!resident) return launch_stage<EPI, BN, false, XH16>(p, n_cols, st);
  return cudaErrorInvalidValue;
}

template <int EPI, int BN>
cudaError_t launch_stage_bn(const Stage& p, long long n_cols, cudaStream_t st) {
  if constexpr (EPI == kLnBwd)
    if (p.xh16) return launch_stage_xh<EPI, BN, true>(p, n_cols, st);
  return launch_stage_xh<EPI, BN, false>(p, n_cols, st);
}

// A GEMM stage over n_cols columns: slabs of BN = D for the LayerNorm
// stages, else the widest of 256, 128 and 64 that divides n_cols.
template <int EPI>
cudaError_t stage(const Stage& p, long long n_cols, cudaStream_t st) {
  const long long bn = is_ln(EPI) ? n_cols : n_cols % 256 == 0 ? 256 : n_cols % 128 == 0 ? 128 : 64;
  switch (bn) {
    case 64: return launch_stage_bn<EPI, 64>(p, n_cols, st);
    case 128: return launch_stage_bn<EPI, 128>(p, n_cols, st);
    case 256: return launch_stage_bn<EPI, 256>(p, n_cols, st);
  }
  return cudaErrorInvalidValue;
}

Stage stage_args(const bf16* a, long long lda, const bf16* b, long long ldb, long long m, long long k,
                 long long ldo) {
  Stage g{};
  g.a = a;
  g.lda = lda;
  g.b = b;
  g.ldb = ldb;
  g.m = m;
  g.k = (int)k;
  g.depth = k;
  g.splits = 1;
  g.ldo = ldo;
  return g;
}

// f(std::integral_constant<int, DH>{}) at d_head DH = dh (16, 32 or 64; what
// shapes_ok admits)
template <class F>
auto with_dh(int dh, F f) -> decltype(f(std::integral_constant<int, 16>{})) {
  if (dh == 16) return f(std::integral_constant<int, 16>{});
  if (dh == 32) return f(std::integral_constant<int, 32>{});
  return f(std::integral_constant<int, 64>{});
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
  long long RT() const { return (M() + ROW_TILE - 1) / ROW_TILE; }
  int dh() const { return D / H; }
  // depth splits of the weight-gradient GEMMs: ~2K rows each, at most 64
  int splits() const { return (int)std::min<long long>(64, std::max<long long>(1, M() / 2048)); }
  // rows of one split, a multiple of the 64-deep step
  long long k_chunk() const {
    const long long c = (M() + splits() - 1) / splits();
    return (c + 63) / 64 * 64;
  }
};

// The shapes K3 takes (fused_layer_train.fused_train_supported is the same
// predicate): D 64, 128 or 256, d_head 16, 32 or 64, an FFN width that is a
// multiple of 64, and an L whose attention-backward block fits.
bool shapes_ok(const Shape& s) {
  if (s.B <= 0 || s.L <= 0 || s.H <= 0 || s.D % s.H) return false;
  if (s.D != 64 && s.D != 128 && s.D != 256) return false;
  const int dh = s.dh();
  if (!(dh == 16 || dh == 32 || dh == 64) || s.F <= 0 || s.F % FFN_MULTIPLE) return false;
  const size_t smem =
      with_dh(dh, [&](auto c) { return attention_bwd_smem_bytes<decltype(c)::value>(s.L); });
  return smem <= (size_t)MAX_SMEM;
}

// K4 also needs the stash gate of the Python wrapper (stash_supported: H *
// round16(L) <= 1280) and its attention passes' shared memory to fit (it
// always does where shapes_ok holds: the gate binds first).
bool stash_shapes_ok(const Shape& s) {
  if (!shapes_ok(s) || s.H * round16(s.L) > 1280) return false;
  return wg_fwd_smem_bytes(s.L, s.dh()) <= (size_t)MAX_SMEM &&
         wg_bwd_smem_bytes(s.L, s.dh()) <= (size_t)MAX_SMEM;
}

Drop make_drop(const Shape& s, uint32_t thresh, float scale, const int* seed, int layer,
               int site) {
  Drop d;
  d.seed = seed;
  d.salt = (uint32_t)(layer * 3 + site) * 0x9E3779B9u + 0x61C88647u;
  d.thresh = thresh;
  d.scale = scale;
  d.L = s.L;
  d.on = thresh != 0u || scale != 1.f;
  return d;
}

template <class K, class... Args>
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

// The 3-D TMA map of one head of a [B, L, W] bf16 activation (W = 3D: qkv;
// D: dattn): rows of W elements, frames L W apart, boxes of dh columns and
// `rows` rows, swizzled by the box's width.
bool head_map(CUtensorMap* map, const void* base, int W, int L, int B, int dh, int rows) {
  const uint64_t dims[3] = {(uint64_t)W, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)W, (uint64_t)W * L};
  const uint32_t box[3] = {(uint32_t)dh, (uint32_t)rows, 1};
  return make_map(map, base, 3, dims, strides, box, dh * 2);
}

// The TMA map of the stash's pbar [B H, L, stash_cols(L)] over its first
// `cols` columns (stash_cols(L) to store, the padding written; L to load,
// the padding never read), boxes [rows][64 columns], 128-byte swizzle.
bool pbar_map(CUtensorMap* map, const void* base, int cols, int L, int BH, int rows) {
  const uint64_t lc = (uint64_t)stash_cols(L);
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)L, (uint64_t)BH};
  const uint64_t strides[2] = {lc, lc * L};
  const uint32_t box[3] = {64, (uint32_t)rows, 1};
  return make_map(map, base, 3, dims, strides, box, 128);
}

template <int DH, int NG>
cudaError_t launch_wg_fwd(const Shape& s, const CUtensorMap& qm, const CUtensorMap& pm, bf16* out,
                          cudaStream_t st) {
  const size_t smem = wg_fwd_smem_bytes(s.L, DH);
  VITIQ_TRY(allow_smem(wg_attention_fwd<DH, NG>, smem));
  // The blocks an SM holds (the persistent grid), asked once for each count
  // of key rows, which sets the shared memory, as K1's core keeps its choice.
  static int per_sm_of_rows[64];
  const int slot = fwd_key_rows(s.L) / 16;
  int per_sm = slot < 64 ? per_sm_of_rows[slot] : 0;
  if (!per_sm) {
    VITIQ_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wg_attention_fwd<DH, NG>,
                                                            128, smem));
    if (slot < 64) per_sm_of_rows[slot] = per_sm;
  }
  const int n_items = s.B * s.H;
  const int grid = std::max(1, std::min(n_items, per_sm * sm_count()));
  wg_attention_fwd<DH, NG><<<grid, 128, smem, st>>>(qm, pm, out, s.L, s.D, s.H, n_items,
                                                    scale2_of(s));
  return cudaGetLastError();
}

// K4-fwd's attention pass (wg_attention_fwd): attn and pbar [B, H, L,
// stash_cols(L)].
cudaError_t wg_fwd(const Shape& s, const bf16* qkv, bf16* out, bf16* pbar, cudaStream_t st) {
  CUtensorMap qm, pm;
  if (!head_map(&qm, qkv, 3 * s.D, s.L, s.B, s.dh(), box_rows_of(fwd_key_rows(s.L))) ||
      !pbar_map(&pm, pbar, stash_cols(s.L), s.L, s.B * s.H,
                fwd_single(s.L) ? fwd_key_rows(s.L) : WG_T))
    return cudaErrorInvalidValue;
  return with_dh(s.dh(), [&](auto c) {
    constexpr int DH = decltype(c)::value;
    switch (fwd_groups(s.L)) {
      case 2: return launch_wg_fwd<DH, 2>(s, qm, pm, out, st);
      case 5: return launch_wg_fwd<DH, 5>(s, qm, pm, out, st);
      default: return launch_wg_fwd<DH, 4>(s, qm, pm, out, st);
    }
  });
}

template <int DH, int NG, bool RES>
cudaError_t launch_wg_bwd(const Shape& s, const CUtensorMap& qm, const CUtensorMap& dm,
                          const CUtensorMap& pm, const bf16* attn, bf16* dqkv, float* part,
                          cudaStream_t st) {
  const double scale2 = 1.4426950408889634 / sqrt((double)s.dh()), ln2 = 0.6931471805599453;
  const size_t smem = wg_bwd_smem_bytes(s.L, DH);
  VITIQ_TRY(allow_smem(wg_attention_bwd_stash<DH, NG, RES>, smem));
  wg_attention_bwd_stash<DH, NG, RES><<<(unsigned)(s.B * s.H), 128, smem, st>>>(
      qm, dm, pm, attn, dqkv, part, s.L, s.D, s.H, (float)scale2, (float)(ln2 * scale2),
      (float)ln2);
  return cudaGetLastError();
}

// K4-bwd's attention pass (wg_attention_bwd_stash): dqkv and the per-frame
// column sums part [B, 3D] from qkv, attn, dattn and the stashed pbar.
cudaError_t wg_bwd(const Shape& s, const bf16* qkv, const bf16* attn, const bf16* dattn,
                   const bf16* pbar, bf16* dqkv, float* part, cudaStream_t st) {
  const int rows = bwd_rows(s.L), box = box_rows_of(rows);
  CUtensorMap qm, dm, pm;
  if (!head_map(&qm, qkv, 3 * s.D, s.L, s.B, s.dh(), box) ||
      !head_map(&dm, dattn, s.D, s.L, s.B, s.dh(), box) ||
      !pbar_map(&pm, pbar, s.L, s.L, s.B * s.H, bwd_resident(s.L) ? rows : WG_T))
    return cudaErrorInvalidValue;
  return with_dh(s.dh(), [&](auto c) {
    constexpr int DH = decltype(c)::value;
    if (!bwd_resident(s.L))
      return launch_wg_bwd<DH, 4, false>(s, qm, dm, pm, attn, dqkv, part, st);
    switch (bwd_groups(s.L)) {
      case 2: return launch_wg_bwd<DH, 2, true>(s, qm, dm, pm, attn, dqkv, part, st);
      case 4: return launch_wg_bwd<DH, 4, true>(s, qm, dm, pm, attn, dqkv, part, st);
      default: return launch_wg_bwd<DH, 5, true>(s, qm, dm, pm, attn, dqkv, part, st);
    }
  });
}

// f(std::integral_constant<int, NG>{}) at K3's wgmma passes' groups for L
template <class F>
cudaError_t with_rc_groups(int L, F f) {
  switch (recompute_groups(L)) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    default: return f(std::integral_constant<int, 9>{});
  }
}

template <int DH, int NG>
cudaError_t launch_rc_fwd(const Shape& s, const CUtensorMap& qm, bf16* out, float* stats,
                          cudaStream_t st) {
  const size_t smem = rc_fwd_smem_bytes(s.L, DH);
  VITIQ_TRY(allow_smem(wg_recompute_attention_fwd<DH, NG>, smem));
  static int per_sm = 0;  // the blocks an SM holds (the persistent grid), asked once
  if (!per_sm)
    VITIQ_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wg_recompute_attention_fwd<DH, NG>, 128, smem));
  const int n_items = s.B * s.H;
  const int grid = std::max(1, std::min(n_items, per_sm * sm_count()));
  wg_recompute_attention_fwd<DH, NG><<<grid, 128, smem, st>>>(qm, out, stats, s.L, s.D, s.H,
                                                              n_items, scale2_of(s));
  return cudaGetLastError();
}

// K3's attention forward on wgmma (wg_recompute_attention_fwd): attn and,
// given `stats`, the row stats [B, H, L, 2].
cudaError_t rc_fwd(const Shape& s, const bf16* qkv, bf16* out, float* stats, cudaStream_t st) {
  CUtensorMap qm;
  if (!head_map(&qm, qkv, 3 * s.D, s.L, s.B, s.dh(), 16 * recompute_groups(s.L)))
    return cudaErrorInvalidValue;
  return with_dh(s.dh(), [&](auto c) {
    return with_rc_groups(s.L, [&](auto n) {
      constexpr int DH = decltype(c)::value, NG = decltype(n)::value;
      if constexpr (rc_fwd_built(DH, NG))
        return launch_rc_fwd<DH, NG>(s, qm, out, stats, st);
      else
        return cudaErrorInvalidValue;  // routed to train_attention_fwd
    });
  });
}

// K3's attention backward on wgmma (wg_recompute_attention_bwd): dqkv and
// the per-frame column sums part [B, 3D] from qkv, attn, dattn and the row
// stats.
cudaError_t rc_bwd(const Shape& s, const bf16* qkv, const bf16* attn, const bf16* dattn,
                   const float* stats, bf16* dqkv, float* part, cudaStream_t st) {
  const int rows = 16 * recompute_groups(s.L);
  CUtensorMap qm, dm;
  if (!head_map(&qm, qkv, 3 * s.D, s.L, s.B, s.dh(), rows) ||
      !head_map(&dm, dattn, s.D, s.L, s.B, s.dh(), rows))
    return cudaErrorInvalidValue;
  const double scale2 = 1.4426950408889634 / sqrt((double)s.dh()), ln2 = 0.6931471805599453;
  return with_dh(s.dh(), [&](auto c) {
    return with_rc_groups(s.L, [&](auto n) {
      constexpr int DH = decltype(c)::value, NG = decltype(n)::value;
      const size_t smem = rc_bwd_smem_bytes(s.L, DH);
      VITIQ_TRY(allow_smem(wg_recompute_attention_bwd<DH, NG>, smem));
      wg_recompute_attention_bwd<DH, NG>
          <<<(unsigned)(s.B * s.H), 128 * rc_bwd_warpgroups(DH, NG), smem, st>>>(
          qm, dm, attn, stats, dqkv, part, s.L, s.D, s.H, (float)scale2, (float)(ln2 * scale2),
          (float)ln2);
      return cudaGetLastError();
    });
  });
}

// The attention forward, routed by shape: K4's (given `pbar`); K3's on
// wgmma where recompute_fwd_wgmma holds; else K3's mma.sync pass
// (train_attention_fwd: round16(L) > 144, or d_head 16 past 80 keys).
cudaError_t attention_fwd(const Shape& s, const bf16* qkv, bf16* out, float* stats, bf16* pbar,
                          cudaStream_t st) {
  if (pbar) return wg_fwd(s, qkv, out, pbar, st);
  if (recompute_fwd_wgmma(s.L, s.dh())) return rc_fwd(s, qkv, out, stats, st);
  const float sc = scale2_of(s);
  return with_dh(s.dh(), [&](auto c) {
    constexpr int DH = decltype(c)::value;
    return launch_attention(train_attention_fwd<DH>, attention_fwd_smem_bytes<DH>(s.L), s, st,
                            qkv, out, stats, s.L, s.D, sc);
  });
}

// The attention backward, routed by shape: K4's, given `pbar` (the stashed
// probabilities); else K3's (row stats from the recompute), on wgmma where
// round16(L) <= 144, else the mma.sync pass (train_attention_bwd).
cudaError_t attention_bwd(const Shape& s, const bf16* qkv, const bf16* attn, const bf16* dattn,
                          const float* stats, const bf16* pbar, bf16* dqkv, float* part,
                          cudaStream_t st) {
  if (pbar) return wg_bwd(s, qkv, attn, dattn, pbar, dqkv, part, st);
  if (recompute_wgmma(s.L)) return rc_bwd(s, qkv, attn, dattn, stats, dqkv, part, st);
  const double scale2 = 1.4426950408889634 / sqrt((double)s.dh());
  const double ln2 = 0.6931471805599453;
  const float sc = (float)scale2, dq = (float)(ln2 * scale2), dk = (float)ln2;
  return with_dh(s.dh(), [&](auto c) {
    constexpr int DH = decltype(c)::value;
    return launch_attention(train_attention_bwd<DH>, attention_bwd_smem_bytes<DH>(s.L), s, st,
                            qkv, attn, dattn, stats, dqkv, part, s.L, s.D, sc, dq, dk);
  });
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

// Activations the forward stages produce. K3's backward recompute also keeps
// the row stats and LN's normalized inputs and 1/std (f32); K4-fwd writes
// attn, the normalized inputs (bf16), 1/std and pbar into the caller's stash.
struct Fwd {
  bf16 *qkv, *attn = nullptr, *x1, *hid;
  float *stats = nullptr, *xh1 = nullptr, *r1 = nullptr, *xh2 = nullptr, *r2 = nullptr;
  bf16 *xh1h = nullptr, *xh2h = nullptr, *pbar = nullptr;
};

// K4's stash, in the order of the entry points' arguments.
struct Stash {
  bf16 *attn, *xh1, *xh2;
  float *r1, *r2;
  bf16* pbar;
};

Stash stash_of(void* attn, void* xh1, void* xh2, void* r1, void* r2, void* pbar) {
  return Stash{static_cast<bf16*>(attn), static_cast<bf16*>(xh1), static_cast<bf16*>(xh2),
               static_cast<float*>(r1),  static_cast<float*>(r2),  static_cast<bf16*>(pbar)};
}

// Workspace of the forward stages. K3 owns attn (K4's lives in the stash);
// K3's recompute also keeps the f32 residuals.
Fwd carve_fwd(Carve& c, const Shape& s, bool own_attn, bool residuals) {
  const long long M = s.M();
  Fwd f;
  f.qkv = c.take<bf16>(M * 3 * s.D);
  if (own_attn) f.attn = c.take<bf16>(M * s.D);
  f.x1 = c.take<bf16>(M * s.D);
  f.hid = c.take<bf16>(M * s.F);
  if (residuals) {
    f.stats = c.take<float>((size_t)s.B * s.H * s.L * 2);
    f.xh1 = c.take<float>(M * s.D);
    f.r1 = c.take<float>(M);
    f.xh2 = c.take<float>(M * s.D);
    f.r2 = c.take<float>(M);
  }
  return f;
}

// qkv = bf16(x Wqkv + bqkv)
cudaError_t qkv_gemm(const Shape& s, const bf16* x, const Weights& w, bf16* qkv, cudaStream_t st) {
  const long long D = s.D;
  Stage g = stage_args(x, D, w.wqkv, 3 * D, s.M(), D, 3 * D);
  g.bias = w.bqkv;
  g.out = qkv;
  return stage<kBias>(g, 3 * D, st);
}

// h = bf16(relu(x1 W1 + b1) * m2)
cudaError_t ffn1_gemm(const Shape& s, const bf16* x1, const Weights& w, bf16* hid,
                      const Drop& drop, cudaStream_t st) {
  Stage g = stage_args(x1, s.D, w.w1, s.F, s.M(), s.D, s.F);
  g.bias = w.b1;
  g.out = hid;
  g.drop = drop;
  return stage<kReluDrop>(g, s.F, st);
}

// The forward's five stages; y may be null (the backward's recompute).
cudaError_t forward(const Shape& s, const bf16* x, bf16* y, const Weights& w, const Fwd& f,
                    const Drop* drop, cudaStream_t st) {
  const long long M = s.M(), D = s.D, F = s.F;
  VITIQ_TRY(qkv_gemm(s, x, w, f.qkv, st));
  VITIQ_TRY(attention_fwd(s, f.qkv, f.attn, f.stats, f.pbar, st));
  Stage g = stage_args(f.attn, D, w.wo, D, M, D, D);
  g.bias = w.bo;
  g.res = x;
  g.gamma = w.g1;
  g.beta = w.be1;
  g.out = f.x1;
  g.xh_out = f.xh1;
  g.xh_out16 = f.xh1h;
  g.rstd_out = f.r1;
  g.drop = drop[0];
  VITIQ_TRY(stage<kLnFwd>(g, D, st));
  VITIQ_TRY(ffn1_gemm(s, f.x1, w, f.hid, drop[1], st));
  g = stage_args(f.hid, F, w.w2, D, M, F, D);
  g.bias = w.b2;
  g.res = f.x1;
  g.gamma = w.g2;
  g.beta = w.be2;
  g.out = y;
  g.xh_out = f.xh2;
  g.xh_out16 = f.xh2h;
  g.rstd_out = f.r2;
  g.drop = drop[2];
  return stage<kLnFwd>(g, D, st);
}

struct Bwd {
  Fwd f;
  bf16 *dfb, *dpreb, *dab, *dattn, *dqkv;
  float *dz2, *dz1, *part_rows, *part_frames, *part_dw, *scratch;
};

// K3's backward recomputes the full forward; K4's rebuilds qkv, x1 and h.
Bwd carve_bwd(Carve& c, const Shape& s, bool stash) {
  const long long M = s.M(), D = s.D, F = s.F;
  Bwd b;
  b.f = carve_fwd(c, s, !stash, !stash);
  b.dfb = c.take<bf16>(M * D);
  b.dz2 = c.take<float>(M * D);
  b.dpreb = c.take<bf16>(M * F);
  b.dab = c.take<bf16>(M * D);
  b.dz1 = c.take<float>(M * D);
  b.dattn = c.take<bf16>(M * D);
  b.dqkv = c.take<bf16>(M * 3 * D);
  b.part_rows = c.take<float>(3 * sum_stride(s.M()) * std::max(D, F));
  b.part_frames = c.take<float>((size_t)s.B * 3 * D);
  b.part_dw = c.take<float>((size_t)s.splits() * D * std::max(3 * D, F));
  b.scratch = c.take<float>((size_t)REDUCE_CHUNKS * std::max(3 * D, F));
  return b;
}

// act^T grad over all rows into out [K1, N] (f32): split-K partials (A =
// act^T read from act [M, K1]), then their fixed-order sum.
cudaError_t weight_grad(const Shape& s, const Bwd& b, const bf16* act, long long k1,
                        const bf16* grad, long long n, float* out, cudaStream_t st) {
  Stage g = stage_args(act, k1, grad, n, k1, s.k_chunk(), n);
  g.depth = s.M();
  g.splits = (int)((s.M() + g.k - 1) / g.k);
  g.out32 = b.part_dw;
  VITIQ_TRY(stage<kPartial>(g, n, st));
  reduce(b.part_dw, g.splits, k1 * n, out, b.scratch, st);
  return cudaSuccess;
}

// LN2's backward rows (ln_bwd_rows at the row width D)
template <class XH>
void ln_bwd(const Shape& s, const bf16* dy, const XH* xh, const float* rstd, const float* gamma,
            const Drop& drop, const Bwd& b, cudaStream_t st) {
  const unsigned blocks = (unsigned)s.RT();
  with_d(s.D, [&](auto w) {
    ln_bwd_rows<XH, decltype(w)::value><<<blocks, THREADS, 0, st>>>(
        dy, xh, rstd, gamma, drop, s.M(), b.dfb, b.dz2, b.part_rows);
  });
}

// K3-bwd (stash null): recompute the forward from x, then the gradient
// stages. K4-bwd: rebuild qkv, x1 = bf16(f32(xh1) g1 + be1) and h, then the
// same stages on the stash (bf16 LN inputs, stashed attn and pbar).
cudaError_t backward(const Shape& s, const bf16* x, const bf16* dy, bf16* dx, float* grads,
                     const Weights& w, const Bwd& b, const Drop* drop, const Stash* stash,
                     cudaStream_t st) {
  const long long M = s.M(), D = s.D, F = s.F, RT = s.RT();
  const Fwd& f = b.f;
  if (stash) {
    VITIQ_TRY(qkv_gemm(s, x, w, f.qkv, st));
    const unsigned blocks = (unsigned)std::min<long long>((M * D + THREADS - 1) / THREADS, 4096);
    rebuild_ln_out<<<blocks, THREADS, 0, st>>>(stash->xh1, w.g1, w.be1, M * D, s.D, f.x1);
    VITIQ_TRY(ffn1_gemm(s, f.x1, w, f.hid, drop[1], st));
  } else {
    VITIQ_TRY(forward(s, x, nullptr, w, f, drop, st));
  }
  const bf16* attn = stash ? stash->attn : f.attn;
  const float* r1 = stash ? stash->r1 : f.r1;
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
  if (stash)
    ln_bwd(s, dy, stash->xh2, stash->r2, w.g2, drop[2], b, st);
  else
    ln_bwd(s, dy, f.xh2, f.r2, w.g2, drop[2], b, st);
  reduce(b.part_rows, RT, D, dg2, b.scratch, st);
  reduce(b.part_rows + RT * D, RT, D, dbe2, b.scratch, st);
  reduce(b.part_rows + 2 * RT * D, RT, D, db2, b.scratch, st);
  // FFN2: dW2 = h^T df; dpre = (h > 0) * (df W2^T) * m2; db1
  VITIQ_TRY(weight_grad(s, b, f.hid, F, b.dfb, D, dw2, st));
  Stage g = stage_args(b.dfb, D, w.w2, D, M, D, F);
  g.res = f.hid;
  g.drop = drop[1];
  g.out = b.dpreb;
  g.part = b.part_rows;
  VITIQ_TRY(stage<kDpre>(g, F, st));
  reduce(b.part_rows, RT, F, db1, b.scratch, st);
  // FFN1: dW1 = x1^T dpre; dx1 = dz2 + dpre W1^T; LN1 backward, dropout m1
  VITIQ_TRY(weight_grad(s, b, f.x1, D, b.dpreb, F, dw1, st));
  g = stage_args(b.dpreb, F, w.w1, F, M, F, D);
  g.res32 = b.dz2;
  g.xh = f.xh1;
  g.xh16 = stash ? stash->xh1 : nullptr;
  g.rstd = r1;
  g.gamma = w.g1;
  g.drop = drop[0];
  g.out = b.dab;
  g.out32 = b.dz1;
  g.part = b.part_rows;
  VITIQ_TRY(stage<kLnBwd>(g, D, st));
  const long long SS = sum_stride(M);
  reduce(b.part_rows, RT, D, dg1, b.scratch, st);
  reduce(b.part_rows + SS * D, RT, D, dbe1, b.scratch, st);
  reduce(b.part_rows + 2 * SS * D, RT, D, dbo, b.scratch, st);
  // out-projection: dWo = attn^T da; dattn = bf16(da Wo^T)
  VITIQ_TRY(weight_grad(s, b, attn, D, b.dab, D, dwo, st));
  g = stage_args(b.dab, D, w.wo, D, M, D, D);
  g.out = b.dattn;
  VITIQ_TRY(stage<kStore>(g, D, st));
  // attention backward: dqkv; dbqkv
  VITIQ_TRY(attention_bwd(s, f.qkv, attn, b.dattn, f.stats, stash ? stash->pbar : nullptr,
                          b.dqkv, b.part_frames, st));
  reduce(b.part_frames, s.B, 3 * D, dbqkv, b.scratch, st);
  // QKV projection: dWqkv = x^T dqkv; dx = bf16(dz1 + dqkv Wqkv^T)
  VITIQ_TRY(weight_grad(s, b, x, D, b.dqkv, 3 * D, dwqkv, st));
  g = stage_args(b.dqkv, 3 * D, w.wqkv, 3 * D, M, 3 * D, D);
  g.res32 = b.dz1;
  g.out = dx;
  return stage<kResOut>(g, D, st);
}

struct Drops {
  Drop site[3];  // attention output, FFN hidden, FFN output
};

Drops make_drops(const Shape& s, uint32_t thresh, float scale, const int* seed, int layer) {
  return Drops{{make_drop(s, thresh, scale, seed, layer, 0),
                make_drop(s, thresh, scale, seed, layer, 1),
                make_drop(s, thresh, scale, seed, layer, 2)}};
}

}  // namespace

// Bytes of workspace K3-fwd / K3-bwd / K4-fwd / K4-bwd need at this shape (0
// if unsupported).
extern "C" size_t vitiq_train_layer_fwd_workspace(int B, int L, int D, int H, int F) {
  const Shape s{B, L, D, H, F};
  if (!shapes_ok(s)) return 0;
  Carve c{nullptr};
  carve_fwd(c, s, true, false);
  return c.off;
}

extern "C" size_t vitiq_train_layer_bwd_workspace(int B, int L, int D, int H, int F) {
  const Shape s{B, L, D, H, F};
  if (!shapes_ok(s)) return 0;
  Carve c{nullptr};
  carve_bwd(c, s, false);
  return c.off;
}

extern "C" size_t vitiq_train_layer_fwd_stash_workspace(int B, int L, int D, int H, int F) {
  const Shape s{B, L, D, H, F};
  if (!stash_shapes_ok(s)) return 0;
  Carve c{nullptr};
  carve_fwd(c, s, false, false);
  return c.off;
}

extern "C" size_t vitiq_train_layer_bwd_stash_workspace(int B, int L, int D, int H, int F) {
  const Shape s{B, L, D, H, F};
  if (!stash_shapes_ok(s)) return 0;
  Carve c{nullptr};
  carve_bwd(c, s, true);
  return c.off;
}

// K3-fwd: y = the training layer of x (see the header). x, y: [B, L, D] bf16;
// w0..w11: Wqkv [D, 3D] (unscaled), bqkv, Wo [D, D], bo, g1, be1, W1 [D, F],
// b1, W2 [F, D], b2, g2, be2 (matrices bf16, vectors f32); workspace of
// vitiq_train_layer_fwd_workspace bytes. Dropout: drop iff the position
// hash's low 31 bits < thresh, keep scaled by `scale` (thresh 0 and scale 1:
// no dropout); `seed` points to the step's int32 seed in device memory.
// Returns cudaGetLastError().
extern "C" int vitiq_train_layer_fwd(
    const void* x, void* y, const void* w0, const void* w1, const void* w2, const void* w3,
    const void* w4, const void* w5, const void* w6, const void* w7, const void* w8,
    const void* w9, const void* w10, const void* w11, void* workspace, int B, int L, int D,
    int H, int F, uint32_t thresh, float scale, const int* seed, int layer, void* stream_ptr) {
  const Shape s{B, L, D, H, F};
  if (!shapes_ok(s)) return (int)cudaErrorInvalidValue;
  const void* wp[12] = {w0, w1, w2, w3, w4, w5, w6, w7, w8, w9, w10, w11};
  Carve c{static_cast<char*>(workspace)};
  const Fwd f = carve_fwd(c, s, true, false);
  const Drops drop = make_drops(s, thresh, scale, seed, layer);
  const cudaError_t err = forward(s, static_cast<const bf16*>(x), static_cast<bf16*>(y),
                                  weights(wp), f, drop.site, static_cast<cudaStream_t>(stream_ptr));
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
    void* workspace, int B, int L, int D, int H, int F, uint32_t thresh, float scale,
    const int* seed, int layer, void* stream_ptr) {
  const Shape s{B, L, D, H, F};
  if (!shapes_ok(s)) return (int)cudaErrorInvalidValue;
  const void* wp[12] = {w0, w1, w2, w3, w4, w5, w6, w7, w8, w9, w10, w11};
  Carve c{static_cast<char*>(workspace)};
  const Bwd b = carve_bwd(c, s, false);
  const Drops drop = make_drops(s, thresh, scale, seed, layer);
  const cudaError_t err =
      backward(s, static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
               static_cast<bf16*>(dx), static_cast<float*>(grads), weights(wp), b, drop.site,
               nullptr, static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K4-fwd: K3-fwd's y, plus the stash: attn [B, L, D] bf16, xh1 and xh2 [B, L,
// D] bf16, r1 and r2 [B, L] f32, pbar [B, H, L, L] bf16. Workspace of
// vitiq_train_layer_fwd_stash_workspace bytes. Returns cudaGetLastError().
extern "C" int vitiq_train_layer_fwd_stash(
    const void* x, void* y, void* attn, void* xh1, void* xh2, void* r1, void* r2, void* pbar,
    const void* w0, const void* w1, const void* w2, const void* w3, const void* w4,
    const void* w5, const void* w6, const void* w7, const void* w8, const void* w9,
    const void* w10, const void* w11, void* workspace, int B, int L, int D, int H, int F,
    uint32_t thresh, float scale, const int* seed, int layer, void* stream_ptr) {
  const Shape s{B, L, D, H, F};
  if (!stash_shapes_ok(s)) return (int)cudaErrorInvalidValue;
  const void* wp[12] = {w0, w1, w2, w3, w4, w5, w6, w7, w8, w9, w10, w11};
  Carve c{static_cast<char*>(workspace)};
  Fwd f = carve_fwd(c, s, false, false);
  const Stash sh = stash_of(attn, xh1, xh2, r1, r2, pbar);
  f.attn = sh.attn;
  f.xh1h = sh.xh1;
  f.xh2h = sh.xh2;
  f.r1 = sh.r1;
  f.r2 = sh.r2;
  f.pbar = sh.pbar;
  const Drops drop = make_drops(s, thresh, scale, seed, layer);
  const cudaError_t err = forward(s, static_cast<const bf16*>(x), static_cast<bf16*>(y),
                                  weights(wp), f, drop.site, static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K4-bwd: dx and the 12 gradients (as K3-bwd) from x, dy and K4-fwd's stash
// (the same six tensors, read only). Workspace of
// vitiq_train_layer_bwd_stash_workspace bytes. Returns cudaGetLastError().
extern "C" int vitiq_train_layer_bwd_stash(
    const void* x, const void* dy, void* dx, void* grads, void* attn, void* xh1, void* xh2,
    void* r1, void* r2, void* pbar, const void* w0, const void* w1, const void* w2,
    const void* w3, const void* w4, const void* w5, const void* w6, const void* w7,
    const void* w8, const void* w9, const void* w10, const void* w11, void* workspace, int B,
    int L, int D, int H, int F, uint32_t thresh, float scale, const int* seed, int layer,
    void* stream_ptr) {
  const Shape s{B, L, D, H, F};
  if (!stash_shapes_ok(s)) return (int)cudaErrorInvalidValue;
  const void* wp[12] = {w0, w1, w2, w3, w4, w5, w6, w7, w8, w9, w10, w11};
  Carve c{static_cast<char*>(workspace)};
  const Bwd b = carve_bwd(c, s, true);
  const Stash sh = stash_of(attn, xh1, xh2, r1, r2, pbar);
  const Drops drop = make_drops(s, thresh, scale, seed, layer);
  const cudaError_t err =
      backward(s, static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
               static_cast<bf16*>(dx), static_cast<float*>(grads), weights(wp), b, drop.site,
               &sh, static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K4-fwd's attention pass alone (wg_attention_fwd): qkv [B, L, 3D] bf16 (q
// unscaled) -> attn [B, L, D] bf16 and pbar [B, H, L, stash_cols(L)] bf16
// (its padding columns 0), as K4-fwd writes them. Returns the launch's error,
// or cudaErrorInvalidValue at a shape K4 does not take.
extern "C" int vitiq_train_attention_fwd_stash(const void* qkv, void* attn, void* pbar, int B,
                                               int L, int D, int H, void* stream_ptr) {
  const Shape s{B, L, D, H, FFN_MULTIPLE};
  if (!stash_shapes_ok(s)) return (int)cudaErrorInvalidValue;
  return (int)wg_fwd(s, static_cast<const bf16*>(qkv), static_cast<bf16*>(attn),
                     static_cast<bf16*>(pbar), static_cast<cudaStream_t>(stream_ptr));
}

// K4-bwd's attention pass alone (wg_attention_bwd_stash): from qkv, attn,
// dattn [B, L, D] bf16 and pbar as K4-fwd stashes it, dqkv [B, L, 3D] bf16
// and part [B, 3D] f32, each frame's column sums of the f32 dq, dk, dv.
extern "C" int vitiq_train_attention_bwd_stash(const void* qkv, const void* attn,
                                               const void* dattn, const void* pbar, void* dqkv,
                                               void* part, int B, int L, int D, int H,
                                               void* stream_ptr) {
  const Shape s{B, L, D, H, FFN_MULTIPLE};
  if (!stash_shapes_ok(s)) return (int)cudaErrorInvalidValue;
  return (int)wg_bwd(s, static_cast<const bf16*>(qkv), static_cast<const bf16*>(attn),
                     static_cast<const bf16*>(dattn), static_cast<const bf16*>(pbar),
                     static_cast<bf16*>(dqkv), static_cast<float*>(part),
                     static_cast<cudaStream_t>(stream_ptr));
}

// K3's attention forward pass alone, routed by shape as K3-fwd routes it
// (wg_recompute_attention_fwd where round16(L) <= 144, else
// train_attention_fwd): qkv [B, L, 3D] bf16 (q unscaled) -> attn [B, L, D]
// bf16 and stats [B, H, L, 2] f32, each query row's max score (log2 units)
// and sum of its bf16 probabilities. Returns the launch's error, or
// cudaErrorInvalidValue at a shape K3 does not take.
extern "C" int vitiq_train_attention_fwd_recompute(const void* qkv, void* attn, void* stats, int B,
                                                   int L, int D, int H, void* stream_ptr) {
  const Shape s{B, L, D, H, FFN_MULTIPLE};
  if (!shapes_ok(s)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = attention_fwd(s, static_cast<const bf16*>(qkv), static_cast<bf16*>(attn),
                                        static_cast<float*>(stats), nullptr,
                                        static_cast<cudaStream_t>(stream_ptr));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// K3's attention backward pass alone, routed as K3-bwd routes it
// (wg_recompute_attention_bwd, else train_attention_bwd): from qkv, attn,
// dattn [B, L, D] bf16 and the forward's stats, dqkv [B, L, 3D] bf16 and
// part [B, 3D] f32, each frame's column sums of the f32 dq, dk, dv.
extern "C" int vitiq_train_attention_bwd_recompute(const void* qkv, const void* attn,
                                                   const void* dattn, const void* stats,
                                                   void* dqkv, void* part, int B, int L, int D,
                                                   int H, void* stream_ptr) {
  const Shape s{B, L, D, H, FFN_MULTIPLE};
  if (!shapes_ok(s)) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      attention_bwd(s, static_cast<const bf16*>(qkv), static_cast<const bf16*>(attn),
                    static_cast<const bf16*>(dattn), static_cast<const float*>(stats), nullptr,
                    static_cast<bf16*>(dqkv), static_cast<float*>(part),
                    static_cast<cudaStream_t>(stream_ptr));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Blocks an SM of K3's wgmma attention passes at this shape (the occupancy
// calculator, with their shared memory): blocks[0] the forward's, blocks[1]
// the backward's; 0 for a pass the shape routes to mma.sync.
extern "C" int vitiq_train_attention_recompute_blocks(int L, int D, int H, int* blocks) {
  const Shape s{1, L, D, H, FFN_MULTIPLE};
  if (!shapes_ok(s)) return (int)cudaErrorInvalidValue;
  blocks[0] = blocks[1] = 0;
  if (!recompute_wgmma(L)) return (int)cudaSuccess;
  return (int)with_dh(s.dh(), [&](auto c) {
    return with_rc_groups(L, [&](auto n) {
      constexpr int DH = decltype(c)::value, NG = decltype(n)::value;
      if constexpr (rc_fwd_built(DH, NG)) {
        const size_t fs = rc_fwd_smem_bytes(L, DH);
        VITIQ_TRY(allow_smem(wg_recompute_attention_fwd<DH, NG>, fs));
        VITIQ_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks[0], wg_recompute_attention_fwd<DH, NG>, 128, fs));
      }
      const size_t bs = rc_bwd_smem_bytes(L, DH);
      VITIQ_TRY(allow_smem(wg_recompute_attention_bwd<DH, NG>, bs));
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks[1], wg_recompute_attention_bwd<DH, NG>, 128 * rc_bwd_warpgroups(DH, NG), bs);
    });
  });
}

// One GEMM stage of K3/K4 alone (train_gemm_kernel), to hold it to its plain
// version (fused_layer_train.train_gemm_plain). epi as Epi. a: A rows [M, K],
// or (kPartial) act [K, M] with the depth K split into chunks of
// ceil(ceil(K / splits) / 64) 64-row steps; b: W [K, N] (kBias, kReluDrop,
// kLnFwd), W [N, K] (kStore, kDpre, kLnBwd, kResOut) or the gradient [K, N]
// (kPartial). The epilogue's operands as the Stage fields (null where
// unused; rows of N, f32 vectors of N); LayerNorm stages take N = 64, 128
// or 256. Dropout (kReluDrop, kLnFwd, kDpre, kLnBwd) at site `site` of layer
// `layer` and the int32 seed at `seed` (device memory), row r being token r % L of frame r / L (thresh 0 and
// scale 1: none). kPartial writes out32 [chunks, M, N]; kDpre and kLnBwd
// their column sums to part [sums][sum_stride(M)][N], of which the first
// ceil(M / 64) tiles are the sums'. Returns the error of the launch or of
// its tensor maps.
extern "C" int vitiq_train_gemm_bf16(
    const void* a, const void* b, const void* bias, const void* res, const void* res32,
    const void* xh, const void* xh16, const void* rstd, const void* gamma, const void* beta,
    void* out, void* out32, void* xh_out, void* xh_out16, void* rstd_out, void* part, int M,
    int K, int N, int epi, int splits, int L, uint32_t thresh, float scale, const int* seed,
    int layer, int site, void* stream_ptr) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 64 || epi < kBias || epi > kPartial || splits <= 0 ||
      L <= 0 || (epi != kPartial && K % 64) || (is_ln(epi) && N != 64 && N != 128 && N != 256))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  Stage g;
  if (epi == kPartial) {
    const long long chunk = ((K + splits - 1) / splits + 63) / 64 * 64;
    g = stage_args(static_cast<const bf16*>(a), M, static_cast<const bf16*>(b), N, M, chunk, N);
    g.depth = K;
    g.splits = (int)((K + chunk - 1) / chunk);
  } else {
    g = stage_args(static_cast<const bf16*>(a), K, static_cast<const bf16*>(b),
                   b_mn_major(epi) ? N : K, M, K, N);
  }
  g.bias = static_cast<const float*>(bias);
  g.res = static_cast<const bf16*>(res);
  g.res32 = static_cast<const float*>(res32);
  g.xh = static_cast<const float*>(xh);
  g.xh16 = static_cast<const bf16*>(xh16);
  g.rstd = static_cast<const float*>(rstd);
  g.gamma = static_cast<const float*>(gamma);
  g.beta = static_cast<const float*>(beta);
  g.out = static_cast<bf16*>(out);
  g.out32 = static_cast<float*>(out32);
  g.xh_out = static_cast<float*>(xh_out);
  g.xh_out16 = static_cast<bf16*>(xh_out16);
  g.rstd_out = static_cast<float*>(rstd_out);
  g.part = static_cast<float*>(part);
  g.drop = make_drop(Shape{1, L, 64, 1, 64}, thresh, scale, seed, layer, site);
  cudaError_t err = cudaErrorInvalidValue;
  switch (epi) {
    case kBias: err = stage<kBias>(g, N, st); break;
    case kReluDrop: err = stage<kReluDrop>(g, N, st); break;
    case kLnFwd: err = stage<kLnFwd>(g, N, st); break;
    case kStore: err = stage<kStore>(g, N, st); break;
    case kDpre: err = stage<kDpre>(g, N, st); break;
    case kLnBwd: err = stage<kLnBwd>(g, N, st); break;
    case kResOut: err = stage<kResOut>(g, N, st); break;
    case kPartial: err = stage<kPartial>(g, N, st); break;
  }
  return (int)err;
}

// ---------------------------------------------------------------------------
// the plain dropout sites (the embedding's, and the plain layers' three)
// ---------------------------------------------------------------------------

// out = x * keep_of(...) over x [rows, W]: row r is frame r / L, token r % L,
// so a site drops what K3/K4 drop at the same (frame, token, lane), seed and
// salt. A dropped position is +0 (a select, not x * 0). Each thread loads the
// seed once and moves VEC elements of one row a step (16 bytes where W and
// the pointers allow); the backward is this function of the gradient.
__device__ __forceinline__ float drop_in(float v) { return v; }
__device__ __forceinline__ float drop_in(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void drop_out(float& o, float f) { o = f; }
__device__ __forceinline__ void drop_out(bf16& o, float f) { o = __float2bfloat16(f); }

template <class T, int VEC>
__global__ void __launch_bounds__(THREADS) hash_dropout_kernel(const T* __restrict__ x,
                                                               T* __restrict__ out, Drop d,
                                                               long long rows, int W,
                                                               int lane0) {
  const uint32_t ss = seed_salt(d);
  const int per_row = W / VEC;
  const long long n = rows * per_row;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / per_row;
    const int c0 = (int)(i - row * per_row) * VEC;
    const uint32_t mix = row_mix(d, row);
    const long long base = row * W + c0;
    T v[VEC];
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(x + base));
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = x[base + j];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float k = keep_of(d, ss, mix, lane0 + c0 + j);
      drop_out(v[j], k != 0.f ? drop_in(v[j]) * k : 0.f);
    }
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(out + base) = *reinterpret_cast<const uint4*>(v);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[base + j] = v[j];
    }
  }
}

template <class T, int VEC>
cudaError_t launch_hash_dropout(const void* x, void* out, const Drop& d, long long rows, int W,
                                int lane0, cudaStream_t stream) {
  const long long n = rows * (W / VEC);
  const long long blocks = std::min<long long>((n + THREADS - 1) / THREADS, 132LL * 16);
  hash_dropout_kernel<T, VEC><<<(int)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), d, rows, W, lane0);
  return cudaGetLastError();
}

// The plain sites' dropout: out [rows, W] = x [rows, W] * scale where the
// position hash of (frame r / L, token r % L, lane w) + seed + salt keeps it
// (its low 31 bits >= thresh), else +0; dtype 0 bf16, 1 f32. `seed` points to
// the step's int32 seed in device memory; `salt` is the site's; the lanes are
// numbered from `lane0` (a column shard's first lane in the whole activation).
// Returns the launch's error, or cudaErrorInvalidValue at an empty or ragged
// shape.
extern "C" int vitiq_hash_dropout(const void* x, void* out, long long rows, int L, int W,
                                  int dtype, uint32_t thresh, float scale, const int* seed,
                                  uint32_t salt, int lane0, void* stream_ptr) {
  if (rows <= 0 || L <= 0 || W <= 0 || lane0 < 0 || rows % L != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Drop d;
  d.seed = seed;
  d.salt = salt;
  d.thresh = thresh;
  d.scale = scale;
  d.L = L;
  d.on = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (dtype == 0)
    return (int)(aligned && W % 8 == 0
                     ? launch_hash_dropout<bf16, 8>(x, out, d, rows, W, lane0, st)
                     : launch_hash_dropout<bf16, 1>(x, out, d, rows, W, lane0, st));
  return (int)(aligned && W % 4 == 0
                   ? launch_hash_dropout<float, 4>(x, out, d, rows, W, lane0, st)
                   : launch_hash_dropout<float, 1>(x, out, d, rows, W, lane0, st));
}
