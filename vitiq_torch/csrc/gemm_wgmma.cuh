// The persistent wgmma GEMM main loop shared by the port's bf16 GEMM stages:
// K1/K2/K7's (fused_encoder_layer.cu: gemm_wgmma_kernel) and K3/K4's
// (fused_layer_train.cu: train_gemm_kernel). Each kernel lays out its shared
// memory with gw_layout, loads what its epilogue reads, and calls
// gemm_wgmma_loop with two callbacks: `init(acc, row0)` starts a warpgroup's
// m64 x BN accumulators (bias, residual, or zeros) and `store(acc, row0,
// split)` is the epilogue of a finished tile, in registers.
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

// Bytes of one ring entry: an A tile [64, K] (resident), or a 64-deep step
// of A [128, 64] and B [64, BN].
__host__ __device__ inline int gemm_entry_bytes(bool resident, int bn, int k) {
  return resident ? 64 * k * 2 : 128 * 128 + bn * 128;
}

// Shared memory of a stage with `ring` ring entries: 1 KB of alignment, W's
// slab (resident), the entries, the kernel's own `extra` bytes (a multiple
// of 8: its epilogue's vectors and scratch), then the mbarriers.
__host__ __device__ inline int gemm_smem_bytes(bool resident, int bn, int k, int ring, int extra) {
  return 1024 + extra + 8 * (1 + 2 * GW_MAX_RING) + (resident ? bn * k * 2 : 0) +
         ring * gemm_entry_bytes(resident, bn, k);
}
// the ring's depth in what is left; 0 where two entries do not fit
__host__ __device__ inline int gemm_ring(bool resident, int bn, int k, int extra) {
  const int fixed = gemm_smem_bytes(resident, bn, k, 0, extra);
  const int ring = (GW_MAX_SMEM - fixed) / gemm_entry_bytes(resident, bn, k);
  return ring < 2 ? 0 : ring > GW_MAX_RING ? GW_MAX_RING : ring;
}

struct GwLayout {
  unsigned char *wslab, *ring, *extra;
  uint64_t *wbar, *full, *empty;
};

// The stage's shared memory, aligned to 1024 by an offset (not through an
// integer, which would leave the kernel's pointers into `extra` generic: its
// reads would be generic loads, hoisted en masse).
template <int BN, bool RESIDENT>
__device__ __forceinline__ GwLayout gw_layout(unsigned char* raw, int K, int ring, int extra) {
  unsigned char* smem = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  GwLayout s;
  s.wslab = smem;
  s.ring = smem + (RESIDENT ? BN * K * 2 : 0);
  s.extra = s.ring + ring * gemm_entry_bytes(RESIDENT, BN, K);
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

// The main loop over the block's work: row tiles first, first + stride, ...
// of n_rt (SPLIT: items of n_items) at depth K (a multiple of 64) each, in
// the slab from column n0. init(acc, row0) and store(acc, row0, split) as
// in the header; the caller's threads have filled `extra` and nothing has
// touched the mbarriers yet.
template <int BN, bool RESIDENT, int TA, int TB, bool SPLIT, class Init, class Store>
__device__ __forceinline__ void gemm_wgmma_loop(const CUtensorMap& a_map, const CUtensorMap& b_map,
                                                const GwLayout& s, int K, int n0, int first,
                                                int stride, int n_rt, int n_items, int ring,
                                                const GwThread& th, Init init, Store store) {
  static_assert(!(RESIDENT && (TA || SPLIT)), "resident stages read K-major A over one depth");
  constexpr int NCH = BN / 64;  // 64-column chunks of the slab
  const int nk = K / 64;
  const int w_bytes = RESIDENT ? BN * K * 2 : 0;
  const int entry = gemm_entry_bytes(RESIDENT, BN, K);
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

  float acc[BN / 2];
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
      mbar_expect_tx(&s.full[slot], entry);
      for (int c = 0; c < nk; ++c)
        tma_load_2d(dst + c * 8192, &a_map, &s.full[slot], c * 64, tile * 64);
    };
    if (threadIdx.x == 0) {
      mbar_expect_tx(s.wbar, w_bytes);
      if constexpr (TB) {  // W [K, N]: NCH chunks [K][64 columns]
        for (int c = 0; c < NCH; ++c)
          tma_load_2d(s.wslab + c * K * 128, &b_map, s.wbar, n0 + c * 64, 0);
      } else {  // W [N, K]: nk chunks [BN rows][64 depth]
        for (int c = 0; c < nk; ++c)
          tma_load_2d(s.wslab + c * BN * 128, &b_map, s.wbar, c * 64, n0);
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
      wgmma_fence();
      for (int c = 0; c < nk; ++c) {  // 64-deep chunks of A, four k-steps each
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const uint64_t db =
              TB ? smem_desc(w_addr + (4 * c + k4) * 2048, 128, K * 128, 1024)
                 : smem_desc(w_addr + c * BN * 128 + k4 * 32, 128, 1024, 1024);
          Wgmma<BN>::template ss<TB>(acc, smem_desc(a_addr + c * 8192 + k4 * 32, 128, 1024, 1024),
                                     db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      named_bar_sync(1 + wg, 128);
      if (leader) load_tile(u + r);
      store(acc, (long long)tile * 64, 0);
    }
  } else {
    // both warpgroups share each 64-deep step of a 128-row tile; warp 0
    // refills a step's slot once both warpgroups have released it
    const int n_work = SPLIT ? n_items : n_rt;
    const int n_my = n_work > first ? (n_work - first + stride - 1) / stride : 0;
    const int total = n_my * nk;  // steps of this block
    // step n: item first + (n / nk) * stride, depth (n % nk) * 64 of it
    auto load_step = [&](int n) {
      const int slot = n % ring, item = first + (n / nk) * stride, kc = n % nk;
      const int tile = SPLIT ? item % n_rt : item;
      const int kq = (SPLIT ? item / n_rt * K : 0) + kc * 64;
      unsigned char* dst = s.ring + slot * entry;
      mbar_expect_tx(&s.full[slot], entry);
      if constexpr (TA) {  // act [depth][rows]: the tile's two 64-row halves
        tma_load_2d(dst, &a_map, &s.full[slot], tile * 128, kq);
        tma_load_2d(dst + 8192, &a_map, &s.full[slot], tile * 128 + 64, kq);
      } else {
        tma_load_2d(dst, &a_map, &s.full[slot], kq, tile * 128);
      }
      if constexpr (TB) {
        for (int c = 0; c < NCH; ++c)
          tma_load_2d(dst + 16384 + c * 8192, &b_map, &s.full[slot], n0 + c * 64, kq);
      } else {
        tma_load_2d(dst + 16384, &b_map, &s.full[slot], kq, n0);
      }
    };
    if (threadIdx.x == 0)
      for (int n = 0; n < ring && n < total; ++n) load_step(n);
    int n = 0;
    for (int item = first; item < n_work; item += stride) {
      const int tile = SPLIT ? item % n_rt : item;
      init(acc, (long long)tile * 128 + wg * 64);
      for (int kc = 0; kc < nk; ++kc, ++n) {
        const int slot = n % ring;
        mbar_wait(&s.full[slot], (n / ring) & 1);
        const uint32_t a_addr = ring_addr + slot * entry + wg * 8192,
                       b_addr = ring_addr + slot * entry + 16384;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = TA ? smem_desc(a_addr + kk * 2048, 128, 8192, 1024)
                                 : smem_desc(a_addr + kk * 32, 128, 1024, 1024);
          const uint64_t db = TB ? smem_desc(b_addr + kk * 2048, 128, 8192, 1024)
                                 : smem_desc(b_addr + kk * 32, 128, 1024, 1024);
          Wgmma<BN>::template ss<TB, TA>(acc, da, db, 1);
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

// A warpgroup's tile as bf16 from its accumulators: each quad transposes its
// words so that every thread stores 16 contiguous bytes of one row; rows[2]
// are the thread's two rows, those >= m are not stored.
template <int BN>
__device__ __forceinline__ void store_tile_bf16(const float* acc, bf16* c, long long ldc,
                                                const long long rows[2], long long m, int n0,
                                                int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = (4 * q + i) * 4 + 2 * hh;
        w[i] = pack_bf16x2(acc[e], acc[e + 1]);
      }
      const uint4 chunk = quad_transpose(w, t);
      if (rows[hh] < m) *reinterpret_cast<uint4*>(c + rows[hh] * ldc + n0 + (4 * q + t) * 8) = chunk;
    }
  }
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
