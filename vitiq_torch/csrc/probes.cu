// Diagnostic probes on Hopper (sm_90a): the counterparts of the JAX package's
// TPU lowering and cost probes. Their Python side is vitiq_torch/probes/.
//
// Replaces (TPU Pallas kernels outside the package, under scripts/):
//   P1  tpu_probe_mask_ops.py: main (:78, the seven elementwise kernels of KS,
//       :60-68) and main2 (:129, the four mm_* kernels, :97-114)
//         -> mask_op_kernel<OP> and mm_mask_kernel<OP>, one template per
//            family, the variant a template argument
//   P2  tpu_probe_refcost.py: make_call (:53), out = in + 1 over NR operands
//       per side on a grid of batch / G steps
//         -> refcost_kernel, one block per grid step, the operand pointers
//            passed by value in a struct
// (P3, the fused layer without its softmax exp, tpu_probe_exp.py:
// kernel_noexp, is K1's attention_kernel<DH, true> in fused_encoder_layer.cu.)
//
// P1 asked which mask idiom Mosaic could lower on K1's attention tile at the
// ViT flagship, f32 [G = 8, LP = 144, T = 16] (SEQ 129 valid keys, the tile's
// first key C0 = 128). On Hopper each variant is one kernel instance, and the
// question becomes: does it build for sm_90a (its ptxas -v line), launch, and
// match its plain version. A thread computes its element's column from its
// index, so the TPU's narrow / full-width / sliced iotas are one integer op
// here. Every rounding is an explicit IEEE intrinsic (no contraction into an
// FMA), so each elementwise variant equals its plain version bit for bit;
// exp2 is exp2f (2 ulp). The mm_* variants contract bf16 [8, 144, 32] with
// [8, 16, 32] over the last dimension into f32 [8, 144, 16] on the tensor
// cores (mma.sync m16n8k16, one warp per 16 rows, fragments read from
// device memory) and add the mask to the accumulators. Each launch moves
// ~150 KB: launch latency bounds it, not bytes or operations.
//
// P2 prices an operand per grid step: three arms move the same bytes through
// NR, NR / 4 or 1 bf16 operands of [batch, 16, W] per side. A block takes one
// grid step's [G, 16, W] slice of every operand (a contiguous run of G * 16 *
// W elements) and streams it in 16-byte chunks, four in flight a thread,
// converting each bf16 to f32, adding 1 and rounding back (the plain
// version's arithmetic). Device memory
// bounds it: 2 * 16 * batch * 16 * 128 * 2 bytes a call whatever the arm
// (1.07 GB at the probe's 8200 / 40 / 16, 0.32 ms at 3.35 TB/s); the arms'
// difference is what each extra operand costs a block.
#include "common.cuh"

namespace {

// P1's tile (tpu_probe_mask_ops.py:22-24) and the mm_* contraction depth.
constexpr int P1_G = 8, P1_LP = 144, P1_T = 16, P1_SEQ = 129, P1_C0 = 128, P1_K = 32;
constexpr float P1_NEG = -1e30f;

// The variants, in the order of the Python side's VARIANTS and MM_VARIANTS.
enum MaskOp : int {
  kSplat, kIotaNarrow, kIotaFullSlice, kClipChain, kSelectNarrow, kBcastAdd, kExp2,
};
enum MmMask : int { kMmPlain, kMmAddSplat, kMmAddSelect, kMmAddClip };

// (clip(SEQ - (col + C0), 0, 1) - 1) * 1e30: 0 for the valid key, -1e30 past it
__device__ __forceinline__ float clip_mask(int col) {
  const float valid = fminf(fmaxf(static_cast<float>(P1_SEQ - (col + P1_C0)), 0.f), 1.f);
  return __fmul_rn(__fsub_rn(valid, 1.f), 1e30f);
}

__device__ __forceinline__ float select_mask(int col) {
  return col + P1_C0 < P1_SEQ ? 0.f : P1_NEG;
}

template <int OP>
__device__ __forceinline__ float mask_op(float x, int col) {
  static_assert(OP >= kSplat && OP <= kExp2, "unknown mask op");
  if constexpr (OP == kSplat) return __fadd_rn(x, 1.f);
  else if constexpr (OP == kIotaNarrow || OP == kIotaFullSlice)
    return __fadd_rn(x, static_cast<float>(col));
  else if constexpr (OP == kClipChain) return __fadd_rn(x, clip_mask(col));
  else if constexpr (OP == kSelectNarrow) return __fadd_rn(x, select_mask(col));
  else if constexpr (OP == kBcastAdd) return __fadd_rn(x, __fsub_rn(0.f, 1.f));
  else return exp2f(x);
}

// One thread per element of the f32 [n / T, T] tile.
template <int OP>
__global__ void __launch_bounds__(256) mask_op_kernel(const float* __restrict__ x,
                                                      float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = mask_op<OP>(x[i], i % P1_T);
}

template <int OP>
__device__ __forceinline__ float mm_mask(float acc, int col) {
  static_assert(OP >= kMmPlain && OP <= kMmAddClip, "unknown mm mask");
  if constexpr (OP == kMmPlain) return acc;
  else if constexpr (OP == kMmAddSplat) return __fadd_rn(acc, 1.f);
  else if constexpr (OP == kMmAddSelect) return __fadd_rn(acc, select_mask(col));
  else return __fadd_rn(acc, clip_mask(col));
}

// One block per g, one warp per 16 of its LP rows: out[g] = x[g] w[g]^T + mask,
// x [LP, K] and w [T, K] bf16, f32 accumulators. A fragments are x's rows, B
// fragments w's rows (the contraction runs along both operands' last
// dimension, so w[n][2t..] is B[2t..][n] as the tile wants it).
template <int OP>
__global__ void __launch_bounds__(P1_LP / 16 * 32) mm_mask_kernel(const bf16* __restrict__ x,
                                                                 const bf16* __restrict__ w,
                                                                 float* __restrict__ out) {
  const int gi = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  const bf16* xg = x + (size_t)gi * P1_LP * P1_K;
  const bf16* wg = w + (size_t)gi * P1_T * P1_K;
  float c[P1_T / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < P1_K / 16; ++kk) {
    const int k0 = kk * 16 + 2 * t;
    const uint32_t a[4] = {ld_b32(xg + r_lo * P1_K + k0), ld_b32(xg + r_hi * P1_K + k0),
                           ld_b32(xg + r_lo * P1_K + k0 + 8), ld_b32(xg + r_hi * P1_K + k0 + 8)};
#pragma unroll
    for (int nb = 0; nb < P1_T / 8; ++nb) {
      const bf16* wrow = wg + (nb * 8 + g) * P1_K + k0;
      mma_bf16_16816(c[nb], a, ld_b32(wrow), ld_b32(wrow + 8));
    }
  }
  float* og = out + (size_t)gi * P1_LP * P1_T;
#pragma unroll
  for (int nb = 0; nb < P1_T / 8; ++nb) {
    const int col = nb * 8 + 2 * t;
    og[r_lo * P1_T + col] = mm_mask<OP>(c[nb][0], col);
    og[r_lo * P1_T + col + 1] = mm_mask<OP>(c[nb][1], col + 1);
    og[r_hi * P1_T + col] = mm_mask<OP>(c[nb][2], col);
    og[r_hi * P1_T + col + 1] = mm_mask<OP>(c[nb][3], col + 1);
  }
}

// P2: at most this many operands per side (the struct is passed by value in
// the kernel's parameter space: 2 * 64 pointers, 1 KB).
constexpr int REFCOST_MAX_OPERANDS = 64;
constexpr int REFCOST_THREADS = 256;

struct RefcostOperands {
  const bf16* in[REFCOST_MAX_OPERANDS];
  bf16* out[REFCOST_MAX_OPERANDS];
};

__device__ __forceinline__ uint32_t add_one(uint32_t packed) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
  return pack_bf16x2(__fadd_rn(f.x, 1.f), __fadd_rn(f.y, 1.f));
}

// Block b: out[r][b * block_elems + i] = in[r][...] + 1 for every operand r
// and i < block_elems (a multiple of 8: 16-byte chunks). Each thread has
// REFCOST_UNROLL chunks in flight, so that the loop streams at the memory's
// rate and does not wait out one load's latency per chunk.
constexpr int REFCOST_UNROLL = 4;

__global__ void __launch_bounds__(REFCOST_THREADS) refcost_kernel(RefcostOperands ops,
                                                                   int n_ops,
                                                                   long long block_elems) {
  const long long base = (long long)blockIdx.x * block_elems;
  const long long chunks = block_elems / 8;
  for (int r = 0; r < n_ops; ++r) {
    const uint4* src = reinterpret_cast<const uint4*>(ops.in[r] + base);
    uint4* dst = reinterpret_cast<uint4*>(ops.out[r] + base);
    for (long long i0 = threadIdx.x; i0 < chunks; i0 += REFCOST_UNROLL * REFCOST_THREADS) {
      uint4 v[REFCOST_UNROLL];
#pragma unroll
      for (int u = 0; u < REFCOST_UNROLL; ++u) {
        const long long i = i0 + u * REFCOST_THREADS;
        if (i < chunks) v[u] = src[i];
      }
#pragma unroll
      for (int u = 0; u < REFCOST_UNROLL; ++u) {
        const long long i = i0 + u * REFCOST_THREADS;
        if (i < chunks)
          dst[i] = make_uint4(add_one(v[u].x), add_one(v[u].y), add_one(v[u].z), add_one(v[u].w));
      }
    }
  }
}

template <int OP>
cudaError_t launch_mask_op(const float* x, float* out, int n, cudaStream_t s) {
  mask_op_kernel<OP><<<(n + 255) / 256, 256, 0, s>>>(x, out, n);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_mm_mask(const bf16* x, const bf16* w, float* out, cudaStream_t s) {
  mm_mask_kernel<OP><<<P1_G, P1_LP / 16 * 32, 0, s>>>(x, w, out);
  return cudaGetLastError();
}

}  // namespace

// P1, an elementwise variant (MaskOp) on x f32 [n / 16, 16] -> out; the
// Python side passes the probe's [8, 144, 16].
extern "C" int vitiq_probe_mask_op(int op, const void* x, void* out, int n, void* stream_ptr) {
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || n % P1_T) return (int)cudaErrorInvalidValue;
  switch (op) {
    case kSplat: return (int)launch_mask_op<kSplat>(xf, of, n, s);
    case kIotaNarrow: return (int)launch_mask_op<kIotaNarrow>(xf, of, n, s);
    case kIotaFullSlice: return (int)launch_mask_op<kIotaFullSlice>(xf, of, n, s);
    case kClipChain: return (int)launch_mask_op<kClipChain>(xf, of, n, s);
    case kSelectNarrow: return (int)launch_mask_op<kSelectNarrow>(xf, of, n, s);
    case kBcastAdd: return (int)launch_mask_op<kBcastAdd>(xf, of, n, s);
    case kExp2: return (int)launch_mask_op<kExp2>(xf, of, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

// P1, an mm_* variant (MmMask): x bf16 [8, 144, 32], w bf16 [8, 16, 32] ->
// out f32 [8, 144, 16].
extern "C" int vitiq_probe_mm_mask(int op, const void* x, const void* w, void* out,
                                   void* stream_ptr) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (op) {
    case kMmPlain: return (int)launch_mm_mask<kMmPlain>(xb, wb, of, s);
    case kMmAddSplat: return (int)launch_mm_mask<kMmAddSplat>(xb, wb, of, s);
    case kMmAddSelect: return (int)launch_mm_mask<kMmAddSelect>(xb, wb, of, s);
    case kMmAddClip: return (int)launch_mm_mask<kMmAddClip>(xb, wb, of, s);
  }
  return (int)cudaErrorInvalidValue;
}

// P2: outs[r] = ins[r] + 1 (bf16) for n_ops operands of grid * block_elems
// elements each, one block per grid step of block_elems (a multiple of 8).
extern "C" int vitiq_probe_refcost(const void* const* ins, void* const* outs, int n_ops,
                                   long long block_elems, int grid, void* stream_ptr) {
  if (n_ops <= 0 || n_ops > REFCOST_MAX_OPERANDS || block_elems <= 0 || block_elems % 8 ||
      grid <= 0)
    return (int)cudaErrorInvalidValue;
  RefcostOperands ops{};
  for (int r = 0; r < n_ops; ++r) {
    ops.in[r] = static_cast<const bf16*>(ins[r]);
    ops.out[r] = static_cast<bf16*>(outs[r]);
  }
  refcost_kernel<<<grid, REFCOST_THREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      ops, n_ops, block_elems);
  return (int)cudaGetLastError();
}
