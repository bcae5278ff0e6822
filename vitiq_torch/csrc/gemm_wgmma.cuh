// The persistent wgmma GEMM main loop shared by the port's bf16 GEMM stages:
// K1/K2/K7's (fused_encoder_layer.cu: gemm_wgmma_kernel) and K3/K4's
// (fused_layer_train.cu: train_gemm_kernel). Each kernel lays out its shared
// memory with gw_layout, loads what its epilogue reads, and calls
// gemm_wgmma_loop with two callbacks: `init(acc, row0)` starts a warpgroup's
// m64 x BN accumulators (bias, residual, or zeros) and `store(acc, row0,
// split)` is the epilogue of a finished tile, in registers.
//
// The products are a policy (Op): MmaBf16, bf16 x bf16 -> f32 (every stage
// above); MmaS8, int8 levels x int8 W -> s32, and MmaS8QuantA, bf16 A rows
// quantized to int8 levels in registers x int8 W -> s32 (K6's four stages,
// fused_encoder_layer.cu: gemm_s8_kernel). The loop's depth unit is a chunk:
// one 128-byte swizzled row of B, 64 bf16 or 128 int8 deep, four 32-byte
// k-steps (k16 for bf16, k32 for s8); a bf16 A under an s8 B takes two
// 128-byte A boxes a chunk.
//
// C[:, n0 .. n0 + BN) over 64-row tiles, one BN-wide column slab a block;
// two warpgroups, one block an SM (256 threads: 9 or 12 warps would leave a
// thread 168 registers, and the m64n256 LayerNorm epilogues spill there).
// Operands arrive by TMA, swizzled by 128 bytes, in 64-element chunks:
//   A K-major (TA = 0): rows [row][k] of the activation, a [64, 64] chunk
//     per 64-row tile and 64-deep step (K1's, and every K3 stage but the
//     weight gradients);
//   A MN-major (TA = 1): the transposed activation act^T of the weight
//     gradients, read from act [depth][K1] as [64 depth][64 rows] chunks;
//   B MN-major (TB = 1): W [K, N] rows, [64 depth][64 columns] chunks (K1's,
//     K3's forward; the gradient rows of the weight gradients);
//   B K-major (TB = 0): B = W^T read from W [N, K], [BN rows][64 depth]
//     chunks (K3's input-gradient stages).
//   RESIDENT (K <= 256, TA = 0): W's slab [K, BN] is loaded once and kept;
//     the warpgroups take the block's row tiles in ping-pong (warpgroup w its
//     tiles w, w + 2, ...), each from its own ring of A tiles [64, K] that
//     its first thread refills once every warp of the warpgroup is past the
//     tile's products (a named barrier: wgmma.wait_group waits only for the
//     calling thread's wgmma), so one tile's epilogue runs beside the other
//     warpgroup's products and the next tile's load.
//   streamed: both warpgroups share 128-row tiles (64 rows each) and a ring
//     of 64-deep steps, each [128, 64] of A and [64, BN] of B, so each B step
//     serves 128 rows; warp 0 refills a step's slot once all 8 warps have
//     released it (an `empty` mbarrier). With SPLIT, the block's work items
//     are (row tile, depth split) pairs: item j is tile j % n_rt over depth
//     [(j / n_rt) K, (j / n_rt + 1) K) (the split-K weight gradients).
//   8-bit operands (MmaS8, MmaS8QuantA) are K-major only (TA = TB = 0): A
//     [rows][K], B = W [N, K]; the depth past K of a last chunk (K = 64 at
//     d_model 64) arrives as TMA's zeros, which add nothing to an s32 sum.
//     MmaS8QuantA reads each warp's A fragments from the bf16 boxes in
//     shared memory and quantizes them with its two rows' scales (RowQuant,
//     which the caller passes): resident, from the whole rows in the A tile
//     (its absmax, tile_row_absmax); streamed, as `init` sets them.
// Rows past the operands' ends arrive as zeros (TMA's out-of-bounds fill).
// Accumulator e of a warpgroup's tile is row row0 + 16 warp + g (+ 8 where
// (e >> 1) & 1), column 8 (e / 4) + 2t + (e & 1) (g = lane / 4, t = lane %
// 4): each row lies in one quad.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int GW_THREADS = 256;  // two warpgroups
constexpr int GW_MAX_RING = 6;
constexpr int GW_MAX_SMEM = 232448;  // shared memory a block may use on Hopper

// Chunks over depth k: 128-byte rows of B (b_bytes a B element), the last
// one padded with zeros.
__host__ __device__ inline int gemm_chunks(int k, int b_bytes) { return (k * b_bytes + 127) / 128; }

// Bytes of one ring entry: an A tile [64, K] (resident), or a one-chunk step
// of A [128 rows] and B [BN rows] (bf16: [128, 64] and [64, BN]); a_bytes
// and b_bytes are the bytes of an A and a B element (A boxes a chunk:
// a_bytes / b_bytes).
__host__ __device__ inline int gemm_entry_bytes(bool resident, int bn, int k, int a_bytes = 2,
                                                int b_bytes = 2) {
  const int a_boxes = a_bytes / b_bytes;
  return resident ? gemm_chunks(k, b_bytes) * a_boxes * 8192 : a_boxes * 16384 + bn * 128;
}

// Shared memory of a stage with `ring` ring entries: 1 KB of alignment, W's
// slab (resident), the entries, the kernel's own `extra` bytes (a multiple
// of 8: its epilogue's vectors and scratch), then the mbarriers.
__host__ __device__ inline int gemm_smem_bytes(bool resident, int bn, int k, int ring, int extra,
                                               int a_bytes = 2, int b_bytes = 2) {
  return 1024 + extra + 8 * (1 + 2 * GW_MAX_RING) +
         (resident ? bn * gemm_chunks(k, b_bytes) * 128 : 0) +
         ring * gemm_entry_bytes(resident, bn, k, a_bytes, b_bytes);
}
// the ring's depth in what is left; 0 where two entries do not fit
__host__ __device__ inline int gemm_ring(bool resident, int bn, int k, int extra, int a_bytes = 2,
                                         int b_bytes = 2) {
  const int fixed = gemm_smem_bytes(resident, bn, k, 0, extra, a_bytes, b_bytes);
  const int ring = (GW_MAX_SMEM - fixed) / gemm_entry_bytes(resident, bn, k, a_bytes, b_bytes);
  return ring < 2 ? 0 : ring > GW_MAX_RING ? GW_MAX_RING : ring;
}

struct GwLayout {
  unsigned char *wslab, *ring, *extra;
  uint64_t *wbar, *full, *empty;
};

// The stage's shared memory, aligned to 1024 by an offset (not through an
// integer, which would leave the kernel's pointers into `extra` generic: its
// reads would be generic loads, hoisted en masse).
template <int BN, bool RESIDENT, int A_BYTES = 2, int B_BYTES = 2>
__device__ __forceinline__ GwLayout gw_layout(unsigned char* raw, int K, int ring, int extra) {
  unsigned char* smem = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  GwLayout s;
  s.wslab = smem;
  s.ring = smem + (RESIDENT ? BN * gemm_chunks(K, B_BYTES) * 128 : 0);
  s.extra = s.ring + ring * gemm_entry_bytes(RESIDENT, BN, K, A_BYTES, B_BYTES);
  s.wbar = reinterpret_cast<uint64_t*>(s.extra + extra);
  s.full = s.wbar + 1;
  s.empty = s.full + GW_MAX_RING;
  return s;
}

// A thread's place: warpgroup, warp in it, lane, and the lane's row group g
// and column pair t. Warpgroup and warp come from lane 0 (warp-uniform to
// ptxas, which serializes wgmma under control flow it takes for divergent).
struct GwThread {
  int wg, warp, lane, g, t;
};

__device__ __forceinline__ GwThread gw_thread() {
  GwThread th;
  th.wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  th.warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  th.lane = threadIdx.x & 31;
  th.g = th.lane >> 2;
  th.t = th.lane & 3;
  return th;
}

// ---- the products ------------------------------------------------------------
// Each names its accumulator type, the bytes of an A and a B element,
// whether A is quantized in registers, and ZERO_FIRST: a tile's first k-step
// starts the accumulators from its product, so `init` leaves them undefined
// and nothing but the wgmma defines them; else `init` starts them and every
// k-step adds.
// K1, K2, K7, K3, K4: bf16 x bf16 -> f32
struct MmaBf16 {
  using Acc = float;
  static constexpr int A_BYTES = 2, B_BYTES = 2;
  static constexpr bool QUANT_A = false, ZERO_FIRST = false;
  template <int BN, int TB, int TA>
  static __device__ __forceinline__ void ss(float* acc, uint64_t da, uint64_t db, int) {
    Wgmma<BN>::template ss<TB, TA>(acc, da, db, 1);
  }
};
// K6's QKV and FFN1: int8 levels x int8 W -> s32
struct MmaS8 {
  using Acc = int;
  static constexpr int A_BYTES = 1, B_BYTES = 1;
  static constexpr bool QUANT_A = false, ZERO_FIRST = true;
  template <int BN, int TB, int TA>
  static __device__ __forceinline__ void ss(int* acc, uint64_t da, uint64_t db, int scale_d) {
    WgmmaS8<BN>::ss(acc, da, db, scale_d);
  }
};
// K6's out-projection and FFN2: bf16 A rows quantized in registers (the
// register-A form) x int8 W -> s32. `init` zeroes the accumulators: left to
// the first k-step, the 256-wide instances spilled.
struct MmaS8QuantA {
  using Acc = int;
  static constexpr int A_BYTES = 2, B_BYTES = 1;
  static constexpr bool QUANT_A = true, ZERO_FIRST = false;
};

// ---- K6's row quantization in registers ----------------------------------
// A row's scale s = max(absmax, 1e-8) / 127 and level rint(v / s), round
// half to even, as the TPU kernel's _row_quant, with IEEE quotients. Every
// quotient is __fdiv_rn's, but without its divide: with y = RN(1 / s), q =
// RN(v y) lies within 1.5 ulp of v / s, one correction q + (v - s q) y
// (fused, so its remainder is exact) makes it faithful, and a second one
// makes it the correctly rounded quotient (Markstein); |v| <= absmax keeps
// every step clear of overflow, and a quotient near a half-integer clear of
// underflow. Nothing here calls rcp.rn's or div.rn's outlined slow path,
// whose calls spilled the 256-wide stages beside their 128 accumulators.
constexpr float ROW_SCALE_FLOOR = 1e-8f;
constexpr float INV127 = 0x1.020408p-7f;  // RN(1 / 127)

struct RowQuant {  // a thread's two rows (16 warp + g and + 8 of its tile)
  float s[2], y[2];
};

__device__ __forceinline__ float quant_div(float v, float s, float y) {
  float q = __fmul_rn(v, y);
  q = __fmaf_rn(__fmaf_rn(-s, q, v), y, q);
  return __fmaf_rn(__fmaf_rn(-s, q, v), y, q);
}

// RN(1 / s) for a normal s: a double reciprocal within ~2^-51 of 1 / s (the
// approximation and two Newton steps) rounds to the float nearest 1 / s,
// which lies at least 2^-48 of itself from a float midpoint.
__device__ __forceinline__ float rcp_rn(float s) {
  const double d = s;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  r = fma(r, fma(-d, r, 1.0), r);
  r = fma(r, fma(-d, r, 1.0), r);
  return __double2float_rn(r);
}

__device__ __forceinline__ float row_scale_of(float amax) {
  return quant_div(fmaxf(amax, ROW_SCALE_FLOOR), 127.0f, INV127);
}

__device__ __forceinline__ void set_row_quant(RowQuant& rq, int hh, float amax) {
  rq.s[hh] = row_scale_of(amax);
  rq.y[hh] = rcp_rn(rq.s[hh]);
}

// The level of v as the low byte of a word: adding 1.5 * 2^23 rounds the
// quotient to an integer, half to even, into the low mantissa bits. Since s
// >= absmax / 127 before its rounding, |v / s| < 127.0001 and the clip to
// [-127, 127] never bites.
__device__ __forceinline__ uint32_t level_bits(float v, float s, float y) {
  return __float_as_uint(__fadd_rn(quant_div(v, s, y), 12582912.0f));
}

// four levels' low bytes in one word, the first in the lowest byte
__device__ __forceinline__ uint32_t pack_levels(uint32_t b0, uint32_t b1, uint32_t b2,
                                                uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// four bf16 (two words) -> their four levels in one word
__device__ __forceinline__ uint32_t quant4(uint2 v, float s, float y) {
  return pack_levels(level_bits(__uint_as_float(v.x << 16), s, y),
                     level_bits(__uint_as_float(v.x & 0xffff0000u), s, y),
                     level_bits(__uint_as_float(v.y << 16), s, y),
                     level_bits(__uint_as_float(v.y & 0xffff0000u), s, y));
}

// The absmax of the thread's two rows over the n_boxes [64 rows][64] bf16
// boxes of a resident A tile (8192 bytes apart): the quad reads each row's
// eight 16-byte units (their order under the swizzle does not matter; row g
// starts at unit g, so a warp's eight rows fall on distinct banks), the
// bf16 magnitudes compared as integers.
__device__ __forceinline__ void tile_row_absmax(float amax[2], const unsigned char* tile,
                                                int n_boxes, const GwThread& th) {
  uint32_t m[2] = {0u, 0u};
  for (int j = 0; j < n_boxes; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const unsigned char* row = tile + j * 8192 + (16 * th.warp + th.g + 8 * hh) * 128;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + ((th.t + 4 * u + th.g) & 7) * 16);
        m[hh] = __vmaxu2(m[hh], __vmaxu2(__vmaxu2(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu),
                                         __vmaxu2(v.z & 0x7fff7fffu, v.w & 0x7fff7fffu)));
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    amax[hh] = quad_max(__uint_as_float(max(m[hh] & 0xffffu, m[hh] >> 16) << 16));
}

// The s8 A fragments of one chunk (four k32 steps) of a warp's 16 rows,
// quantized from two [rows][64] bf16 boxes box_stride apart (128-byte
// swizzled, the warpgroup's rows from `base`); boxes from n_boxes on are
// past the depth and give zeros. Step kk: box kk / 2, its bytes (kk % 2) 64
// + 8t (levels 4t..) and + 32 (levels 16 + 4t..) of rows g and g + 8.
__device__ __forceinline__ void quant_chunk(uint32_t af[4][4], const unsigned char* base,
                                            int box_stride, int n_boxes, const RowQuant& rq,
                                            const GwThread& th) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if ((kk >> 1) < n_boxes) {
      const unsigned char* r0 = base + (kk >> 1) * box_stride + (16 * th.warp + th.g) * 128;
      const int c0 = (kk & 1) * 64 + 8 * th.t, c1 = c0 + 32;
      const int o0 = (((c0 >> 4) ^ th.g) << 4) + (c0 & 15);
      const int o1 = (((c1 >> 4) ^ th.g) << 4) + (c1 & 15);
      af[kk][0] = quant4(*reinterpret_cast<const uint2*>(r0 + o0), rq.s[0], rq.y[0]);
      af[kk][1] = quant4(*reinterpret_cast<const uint2*>(r0 + 1024 + o0), rq.s[1], rq.y[1]);
      af[kk][2] = quant4(*reinterpret_cast<const uint2*>(r0 + o1), rq.s[0], rq.y[0]);
      af[kk][3] = quant4(*reinterpret_cast<const uint2*>(r0 + 1024 + o1), rq.s[1], rq.y[1]);
    } else {
      af[kk][0] = af[kk][1] = af[kk][2] = af[kk][3] = 0u;
    }
  }
}

// The main loop over the block's work: row tiles first, first + stride, ...
// of n_rt (SPLIT: items of n_items) at depth K (bf16: a multiple of 64) each,
// in the slab from column n0. init(acc, row0) and store(acc, row0, split) as
// in the header; the caller's threads have filled `extra` and nothing has
// touched the mbarriers yet. rq: MmaS8QuantA's row scales (else unused).
// Under ZERO_FIRST, init leaves acc to the tile's first k-step.
template <int BN, bool RESIDENT, int TA, int TB, bool SPLIT, class Op = MmaBf16, class Init,
          class Store>
__device__ __forceinline__ void gemm_wgmma_loop(const CUtensorMap& a_map, const CUtensorMap& b_map,
                                                const GwLayout& s, int K, int n0, int first,
                                                int stride, int n_rt, int n_items, int ring,
                                                const GwThread& th, Init init, Store store,
                                                RowQuant* rq = nullptr) {
  static_assert(!(RESIDENT && (TA || SPLIT)), "resident stages read K-major A over one depth");
  static_assert(Op::B_BYTES == 2 || !(TA || TB || SPLIT), "8-bit operands are K-major");
  constexpr int NCH = BN / 64;            // 64-column chunks of the slab (TB = 1)
  constexpr int KCH = 128 / Op::B_BYTES;  // depth of a chunk
  constexpr int ABOX = 128 / Op::A_BYTES;  // depth of a 128-byte A box
  constexpr int A_BOXES = KCH / ABOX;      // A boxes a chunk
  const int nk = Op::B_BYTES == 2 ? K / KCH : (K + KCH - 1) / KCH;
  const int n_abox = Op::A_BYTES == 2 ? K / ABOX : nk;  // A boxes over the depth
  const int w_bytes = RESIDENT ? BN * nk * 128 : 0;
  const int entry = gemm_entry_bytes(RESIDENT, BN, K, Op::A_BYTES, Op::B_BYTES);
  const int wg = th.wg, lane = th.lane;
  if (threadIdx.x == 0) {
    mbar_init(s.wbar, 1);
    for (int i = 0; i < ring; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 8);  // lane 0 of each warp (streamed)
    }
    mbar_init_fence();
  }
  __syncthreads();

  typename Op::Acc acc[BN / 2];
  const uint32_t ring_addr = smem_u32(s.ring);

  if constexpr (RESIDENT) {
    // warpgroup w's tiles: first + (w + 2u) * stride, u = 0, 1, ...; its own
    // ring slots w * r .. w * r + r - 1, refilled by its first thread once the
    // tile's products are done in all four of its warps: after a named
    // barrier over the warpgroup's 128 threads (id 1 + w)
    const int r = ring / 2;
    const bool leader = (threadIdx.x & 127) == 0;
    auto load_tile = [&](int u) {
      const int tile = first + (wg + 2 * u) * stride;
      if (tile >= n_rt) return;
      const int slot = wg * r + u % r;
      unsigned char* dst = s.ring + slot * entry;
      mbar_expect_tx(&s.full[slot], n_abox * 8192);
      for (int c = 0; c < n_abox; ++c)
        tma_load_2d(dst + c * 8192, &a_map, &s.full[slot], c * ABOX, tile * 64);
    };
    if (threadIdx.x == 0) {
      mbar_expect_tx(s.wbar, w_bytes);
      if constexpr (TB) {  // W [K, N]: NCH chunks [K][64 columns]
        for (int c = 0; c < NCH; ++c)
          tma_load_2d(s.wslab + c * K * 128, &b_map, s.wbar, n0 + c * 64, 0);
      } else {  // W [N, K]: nk chunks [BN rows][one 128-byte row of depth]
        for (int c = 0; c < nk; ++c)
          tma_load_2d(s.wslab + c * BN * 128, &b_map, s.wbar, c * KCH, n0);
      }
    }
    if (leader)
      for (int u = 0; u < r; ++u) load_tile(u);
    const uint32_t w_addr = smem_u32(s.wslab);
    mbar_wait(s.wbar, 0);
    int u = 0;
    for (int tile = first + wg * stride; tile < n_rt; tile += 2 * stride, ++u) {
      const int slot = wg * r + u % r;
      init(acc, (long long)tile * 64);
      mbar_wait(&s.full[slot], (u / r) & 1);
      const uint32_t a_addr = ring_addr + slot * entry;
      if constexpr (Op::QUANT_A) {
        // the whole rows are in the tile: their scales, then each chunk's
        // fragments, quantized once the previous chunk's products have read
        // the registers
        const unsigned char* a_tile = s.ring + slot * entry;
        float amax[2];
        tile_row_absmax(amax, a_tile, n_abox, th);
        set_row_quant(*rq, 0, amax[0]);
        set_row_quant(*rq, 1, amax[1]);
        for (int c = 0; c < nk; ++c) {
          uint32_t af[4][4];
          if (c) wgmma_wait<0>();
          quant_chunk(af, a_tile + c * A_BOXES * 8192, 8192, n_abox - A_BOXES * c, *rq, th);
          wgmma_fence();
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4)
            WgmmaS8<BN>::rs(acc, af[k4],
                            smem_desc(w_addr + c * BN * 128 + k4 * 32, 128, 1024, 1024), 1);
          wgmma_commit();
        }
      } else {
        wgmma_fence();
        for (int c = 0; c < nk; ++c) {  // chunks of A, four k-steps each
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const uint64_t db =
                TB ? smem_desc(w_addr + (4 * c + k4) * 2048, 128, K * 128, 1024)
                   : smem_desc(w_addr + c * BN * 128 + k4 * 32, 128, 1024, 1024);
            Op::template ss<BN, TB, 0>(
                acc, smem_desc(a_addr + c * 8192 + k4 * 32, 128, 1024, 1024), db,
                !Op::ZERO_FIRST || (c | k4) != 0);
          }
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      named_bar_sync(1 + wg, 128);
      if (leader) load_tile(u + r);
      store(acc, (long long)tile * 64, 0);
    }
  } else {
    // both warpgroups share each one-chunk step of a 128-row tile; warp 0
    // refills a step's slot once both warpgroups have released it
    const int n_work = SPLIT ? n_items : n_rt;
    const int n_my = n_work > first ? (n_work - first + stride - 1) / stride : 0;
    const int total = n_my * nk;  // steps of this block
    // step n: item first + (n / nk) * stride, chunk n % nk of it
    auto load_step = [&](int n) {
      const int slot = n % ring, item = first + (n / nk) * stride, kc = n % nk;
      const int tile = SPLIT ? item % n_rt : item;
      const int kq = (SPLIT ? item / n_rt * K : 0) + kc * KCH;
      unsigned char* dst = s.ring + slot * entry;
      mbar_expect_tx(&s.full[slot], entry);
      if constexpr (TA) {  // act [depth][rows]: the tile's two 64-row halves
        tma_load_2d(dst, &a_map, &s.full[slot], tile * 128, kq);
        tma_load_2d(dst + 8192, &a_map, &s.full[slot], tile * 128 + 64, kq);
      } else {
#pragma unroll
        for (int j = 0; j < A_BOXES; ++j)
          tma_load_2d(dst + j * 16384, &a_map, &s.full[slot], kq + j * ABOX, tile * 128);
      }
      if constexpr (TB) {
        for (int c = 0; c < NCH; ++c)
          tma_load_2d(dst + 16384 + c * 8192, &b_map, &s.full[slot], n0 + c * 64, kq);
      } else {
        tma_load_2d(dst + A_BOXES * 16384, &b_map, &s.full[slot], kq, n0);
      }
    };
    if (threadIdx.x == 0)
      for (int n = 0; n < ring && n < total; ++n) load_step(n);
    uint32_t af[4][4];  // MmaS8QuantA: the step's A fragments
    int n = 0;
    for (int item = first; item < n_work; item += stride) {
      const int tile = SPLIT ? item % n_rt : item;
      init(acc, (long long)tile * 128 + wg * 64);
      for (int kc = 0; kc < nk; ++kc, ++n) {
        const int slot = n % ring;
        mbar_wait(&s.full[slot], (n / ring) & 1);
        const uint32_t a_addr = ring_addr + slot * entry + wg * 8192,
                       b_addr = ring_addr + slot * entry + A_BOXES * 16384;
        if constexpr (Op::QUANT_A) {
          wgmma_wait<0>();  // the previous step's products have read af
          quant_chunk(af, s.ring + slot * entry + wg * 8192, 16384, A_BOXES, *rq, th);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = TB ? smem_desc(b_addr + kk * 2048, 128, 8192, 1024)
                                 : smem_desc(b_addr + kk * 32, 128, 1024, 1024);
          if constexpr (Op::QUANT_A) {
            WgmmaS8<BN>::rs(acc, af[kk], db, 1);
          } else {
            const uint64_t da = TA ? smem_desc(a_addr + kk * 2048, 128, 8192, 1024)
                                   : smem_desc(a_addr + kk * 32, 128, 1024, 1024);
            Op::template ss<BN, TB, TA>(acc, da, db, !Op::ZERO_FIRST || (kc | kk) != 0);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (n > 0) {  // step n - 1 is done: release it, and refill its slot with step n - 1 + ring
          if (lane == 0) mbar_arrive(&s.empty[(n - 1) % ring]);
          if (threadIdx.x < 32 && n - 1 + ring < total) {
            mbar_wait(&s.empty[(n - 1) % ring], ((n - 1) / ring) & 1);
            if (lane == 0) load_step(n - 1 + ring);
          }
        }
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      store(acc, (long long)tile * 128 + wg * 64, SPLIT ? item / n_rt : 0);
    }
  }
}

// The four 32-bit words a thread holds at one row for four 8-column blocks
// (columns 2t, 2t + 1 of each) -> the four words of block t (16 bytes).
__device__ __forceinline__ uint4 quad_transpose(const uint32_t w[4], int t) {
  auto pick = [&](int k) { return k == 0 ? w[0] : k == 1 ? w[1] : k == 2 ? w[2] : w[3]; };
  const uint32_t self = pick(t);
  const uint32_t y1 = __shfl_xor_sync(0xffffffffu, pick(t ^ 1), 1);
  const uint32_t y2 = __shfl_xor_sync(0xffffffffu, pick(t ^ 2), 2);
  const uint32_t y3 = __shfl_xor_sync(0xffffffffu, pick(t ^ 3), 3);
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = i ^ t;
    o[i] = k == 0 ? self : k == 1 ? y1 : k == 2 ? y2 : y3;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// A warpgroup's tile as bf16 from word(e), the packed bf16 pair of its
// accumulators e and e + 1 (e even): each quad transposes its words so that
// every thread stores 16 contiguous bytes of one row; rows[2] are the
// thread's two rows, those >= m are not stored.
template <int BN, class Word>
__device__ __forceinline__ void store_words_bf16(Word word, bf16* c, long long ldc,
                                                 const long long rows[2], long long m, int n0,
                                                 int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = word((4 * q + i) * 4 + 2 * hh);
      const uint4 chunk = quad_transpose(w, t);
      if (rows[hh] < m) *reinterpret_cast<uint4*>(c + rows[hh] * ldc + n0 + (4 * q + t) * 8) = chunk;
    }
  }
}

// the same from val(e), the value of accumulator e
template <int BN, class Val>
__device__ __forceinline__ void store_rows_bf16(Val val, bf16* c, long long ldc,
                                                const long long rows[2], long long m, int n0,
                                                int t) {
  store_words_bf16<BN>([&](int e) { return pack_bf16x2(val(e), val(e + 1)); }, c, ldc, rows, m,
                       n0, t);
}

// the same from f32 accumulators
template <int BN>
__device__ __forceinline__ void store_tile_bf16(const float* acc, bf16* c, long long ldc,
                                                const long long rows[2], long long m, int n0,
                                                int t) {
  store_rows_bf16<BN>([&](int e) { return acc[e]; }, c, ldc, rows, m, n0, t);
}

// SMs of the current device (the persistent stages' grid)
inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Blocks of a persistent stage of n_tiles slabs and n_work row tiles (or
// items) each: up to one block per SM, the SMs split evenly between the
// slabs.
inline unsigned gw_blocks(long long n_work, int n_tiles) {
  long long per_slab = sm_count() / n_tiles;
  per_slab = per_slab < 1 ? 1 : per_slab > n_work ? n_work : per_slab;
  return (unsigned)(per_slab * n_tiles);
}

}  // namespace
