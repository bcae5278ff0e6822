// Symbol timing recovery on the card (sm_90a): timing_recovery_kernel<METHOD,
// MODE, GROUP>, METHOD 0 the Gardner loop, 1 Mueller-Mueller; MODE 0 writes
// the loop's positions, MODE 1 the symbols; GROUP lanes a frame.
//
// It replaces no TPU kernel. The JAX package runs timing recovery as XLA
// code: the loops are `lax.scan`s (vitiq/dsp/timing.py:76-137,
// `_gardner_scan` and `_mueller_muller_scan`, vmapped over frames), the
// hybrid's coarse phase and circular mean vector reductions
// (`hybrid_timing_positions`, :157-207), the strobes a `take_along_axis`
// (vitiq/dsp/frontend.py:190-200). In PyTorch the recurrence as a loop of
// tensor operations launches some 45 small kernels a step from the host, and
// the reductions and the gather around it some 30 more a call; here all of
// it is one launch.
//
// What it computes, for frame b of x [B, n] (float2: I, Q), n_sym = n / sps:
//   y(t)  = x[lo] (1 - f) + x[hi] f   at t clipped to [0, n-1], lo = floor(t),
//           hi = min(lo + 1, n - 1), f = t - lo (linear interpolation)
//   Gardner: e = (yI(pos) - yI(pos - sps)) yI(pos - sps/2) + the same in Q,
//            next = pos + sps - clip(gain e, -sps/2, sps/2)
//   M&M:     e = sign(yI(pos - sps)) yI(pos) - sign(yI(pos)) yI(pos - sps)
//                + the same in Q,
//            next = pos + sps + clip(gain e, -sps/2, sps/2)
// Positions mode: `steps` steps from p0[b] (or sps); positions[b, k] = pos,
// valid[b, k] = pos <= n - 1.
// Symbols mode, full loop (window 0): n_sym steps from sps, symbol k =
// x[clamp(rint(pos_k), 0, n - 1)].
// Symbols mode, hybrid (window w): the coarse phase p = the first argmax over
// phases of the mean of |x[m sps + p]|^2 over m < n_sym; w steps from p + sps;
// the circular mean (period sps) of the positions of steps w/2 .. w-1:
// phase = remainder(atan2(sum sin, sum cos) sps / 2pi, sps); symbol k =
// x[rint(clamp(phase + sps k, 0, n - 1))]; phase[b] written where asked.
// Every product and sum of the loop is rounded on its own (__fmul_rn,
// __fadd_rn), in the plain loop's order: the compiler would otherwise
// contract a product and a sum into one FMA, and the loop feeds each rounding
// into the next step. So the positions equal the plain loop's
// (`ops/cuda/timing.py`, `timing_scan_plain`) bit for bit, and so do the full
// loop's symbols. The hybrid's coarse energies and its sums of sin and cos
// are taken in another order than PyTorch's, with CUDA's sinf, cosf and
// atan2f: its phase agrees with the plain version's to a few float32 ulps,
// and a symbol can differ only where a strobe sits within that of a
// half-integer.
//
// Design. A group of GROUP lanes takes a frame, 32 / GROUP frames a warp, 16
// frames a block. All lanes of a group run the recurrence on the same values
// (a warp issues one instruction for its lanes either way), so each holds
// every position; lane k % GROUP keeps step k's result, and every GROUP steps
// the group writes GROUP results as one coalesced store. The samples the loop
// reads are staged in shared memory: each group owns a ring of 2H samples,
// [base, base + 2H) of its frame, loaded by cp.async (the group's lanes on
// consecutive samples). The strobe moves by sps +- sps/2 a step, so it only
// goes forward: once every kUpkeep steps (off the steps' chain) the group
// checks its ring, and when the lowest sample a step reads has passed
// base + H, the lower half is refilled with the next H samples while the loop
// runs on in the upper half; the loop waits for the copy only when the next
// kUpkeep steps could reach it. The hybrid's window mostly stays within the
// first fill. The coarse phase is one pass over the frame in 16-byte loads,
// kUnroll in flight a lane (for sps dividing 8 each lane's two samples of a
// load keep their phases, so a lane sums two phases; other sps go phase by
// phase), the energies summed over the group by shuffles. The sines and
// cosines are taken by the lane that kept each position, every GROUP steps,
// then summed over the group. The strobes are gathered from device memory
// (the coarse pass has just brought the frame into L2), GROUP symbols a store.
//
// What bounds it: at B=4096 frames of 2,048 samples the hybrid's bytes (the
// frame read once, the symbols written: ~0.03 ms at the HBM rate); the full
// loop's chain of dependent steps (~70 instructions a step, whose shared-
// memory loads take their addresses from the previous step's arithmetic).
// The lanes a frame were chosen on the card (`ops/cuda/timing_variants.py`,
// which times text edits of this file in turns; PERF.md has its numbers): a
// step of the loop takes longer the more frames a warp carries, down to 4
// frames a warp (GROUP 8), past which the warps' redundant issue grows; the
// hybrid, a memory pass more than a loop, gains from more lanes a frame
// (more loads in flight). Rings shifted by 4 banks, one group from the
// next, changed no time: they are not padded.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 16;          // frames a block
// lanes a frame: 8 where the loop's steps dominate (positions, full loop),
// 16 for the hybrid, whose coarse pass and gather are memory phases
constexpr int kLoopGroup = 8;
constexpr int kHybridGroup = 16;
// steps between two upkeeps of the ring; the full loop's symbols are read
// from the ring when its group writes them, so its group is one upkeep span
constexpr int kUpkeep = kLoopGroup;
constexpr int kUnroll = 32;          // loads in flight a lane in the coarse pass and the gather
constexpr int kMinHalf = 128;        // ring half, samples (a power of 2)
constexpr int kMaxHalf = 512;        // 16 frames x 2 x 512 x 8 bytes = 128 KB of shared memory
constexpr double kPi = 3.14159265358979323846;  // Python's math.pi

unsigned long long timing_recovery_launches = 0;

struct Params {
  const float2* x;
  const float* p0;   // positions mode: start positions [B] (nullptr: sps)
  float* positions;  // positions mode: [B, steps]
  uint8_t* valid;    // positions mode: [B, steps]
  float2* symbols;   // symbols mode: [B, n / sps]
  float* phase;      // symbols mode, hybrid: [B] (nullptr: not written)
  int B, n, sps, steps, window, half;
  float gain, to_angle, to_samples;  // f32(2 pi / sps), f32(sps / 2 pi)
};

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

template <int GROUP>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int d = 1; d < GROUP; d <<= 1) v = __fadd_rn(v, __shfl_xor_sync(mask, v, d, GROUP));
  return v;
}

// |v|^2 rounded as the plain version's square().sum(-1)
__device__ __forceinline__ float energy(float i, float q) {
  return __fadd_rn(__fmul_rn(i, i), __fmul_rn(q, q));
}

// The lowest sample index a step at `pos` reads (its earliest point, clipped).
__device__ __forceinline__ int lowest_sample(float pos, float s, float last) {
  return static_cast<int>(fminf(fmaxf(__fsub_rn(pos, s), 0.0f), last));
}

// Linear interpolation at t from the ring that holds the frame's samples
// [base, base + 2H) at slots index & mask.
__device__ __forceinline__ float2 lin_interp(const float2* ring, int mask, int n, float t) {
  const float p = fminf(fmaxf(t, 0.0f), static_cast<float>(n - 1));
  const float fl = floorf(p);
  const int lo = static_cast<int>(fl);
  const int hi = min(lo + 1, n - 1);
  const float frac = __fsub_rn(p, fl);
  const float w = __fsub_rn(1.0f, frac);
  const float2 a = ring[lo & mask];
  const float2 c = ring[hi & mask];
  return make_float2(__fadd_rn(__fmul_rn(a.x, w), __fmul_rn(c.x, frac)),
                     __fadd_rn(__fmul_rn(a.y, w), __fmul_rn(c.y, frac)));
}

// The group's lanes copy samples [start, start + H) of frame f (those below
// n) into the ring, consecutive lanes on consecutive samples.
template <int GROUP>
__device__ __forceinline__ void fill(float2* ring, int mask, const float2* f, int n, int start,
                                     int H, int lane) {
  const int end = min(start + H, n);
  for (int j = start + lane; j < end; j += GROUP) cp_async8(ring + (j & mask), f + j);
  cp_async_commit();
}

// The first phase of the largest mean symbol energy (torch.argmax's tie rule).
template <int GROUP>
__device__ int coarse_phase(const float2* f, int n, int sps, int lane, unsigned mask) {
  const int n_sym = n / sps;
  const float count = static_cast<float>(n_sym);
  int best = 0;
  float best_e = 0.0f;
  if (8 % sps == 0 && n % 2 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0) {
    // 16-byte loads of samples (2c, 2c + 1), c = lane + GROUP t: for sps
    // dividing 8 (and so 2 GROUP) the two samples' phases are the same every t
    const float4* f4 = reinterpret_cast<const float4*>(f);
    const int nc = n_sym * sps / 2;
    float ea = 0.0f, eb = 0.0f;
    int c = lane;
    for (; c + (kUnroll - 1) * GROUP < nc; c += kUnroll * GROUP) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(f4 + c + u * GROUP);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        ea = __fadd_rn(ea, energy(v[u].x, v[u].y));
        eb = __fadd_rn(eb, energy(v[u].z, v[u].w));
      }
    }
    for (; c < nc; c += GROUP) {
      const float4 v = __ldg(f4 + c);
      ea = __fadd_rn(ea, energy(v.x, v.y));
      eb = __fadd_rn(eb, energy(v.z, v.w));
    }
    const int pa = (2 * lane) % sps, pb = (2 * lane + 1) % sps;
    for (int p = 0; p < sps; ++p) {
      const float e = group_sum<GROUP>(__fadd_rn(pa == p ? ea : 0.0f, pb == p ? eb : 0.0f), mask);
      const float mean = __fdiv_rn(e, count);
      if (p == 0 || mean > best_e) best_e = mean, best = p;
    }
    return best;
  }
  for (int p = 0; p < sps; ++p) {
    float e = 0.0f;
#pragma unroll 8
    for (int m = lane; m < n_sym; m += GROUP) {
      const float2 v = __ldg(f + static_cast<long long>(m) * sps + p);
      e = __fadd_rn(e, energy(v.x, v.y));
    }
    const float mean = __fdiv_rn(group_sum<GROUP>(e, mask), count);
    if (p == 0 || mean > best_e) best_e = mean, best = p;
  }
  return best;
}

// One step of the loop from `pos`: the next position.
template <int METHOD>
__device__ __forceinline__ float advance(const float2* ring, int rmask, int n, float pos, float s,
                                         float half_s, float gain) {
  const float2 y = lin_interp(ring, rmask, n, pos);
  const float2 yp = lin_interp(ring, rmask, n, __fsub_rn(pos, s));
  float err;
  if (METHOD == 0) {
    const float2 ym = lin_interp(ring, rmask, n, __fsub_rn(pos, half_s));
    err = __fadd_rn(__fmul_rn(__fsub_rn(y.x, yp.x), ym.x), __fmul_rn(__fsub_rn(y.y, yp.y), ym.y));
  } else {
    const float ei = __fsub_rn(__fmul_rn(sign_of(yp.x), y.x), __fmul_rn(sign_of(y.x), yp.x));
    const float eq = __fsub_rn(__fmul_rn(sign_of(yp.y), y.y), __fmul_rn(sign_of(y.y), yp.y));
    err = __fadd_rn(ei, eq);
  }
  const float step = fminf(fmaxf(__fmul_rn(gain, err), -half_s), half_s);
  return METHOD == 0 ? __fsub_rn(__fadd_rn(pos, s), step) : __fadd_rn(__fadd_rn(pos, s), step);
}

template <int METHOD, int MODE, int GROUP>
__global__ void __launch_bounds__(GROUP * kFrames) timing_recovery_kernel(const Params a) {
  extern __shared__ float2 smem[];
  const int group = threadIdx.x / GROUP;
  const int lane = threadIdx.x % GROUP;
  const int b = blockIdx.x * kFrames + group;
  if (b >= a.B) return;  // the whole group leaves together
  const unsigned mask = ((1u << GROUP) - 1) << ((threadIdx.x % 32) / GROUP * GROUP);
  const int n = a.n, H = a.half, rmask = 2 * a.half - 1;
  float2* ring = smem + group * 2 * H;
  const float2* f = a.x + static_cast<long long>(b) * n;
  const float s = static_cast<float>(a.sps);
  const float half_s = 0.5f * s;
  const float last = static_cast<float>(n - 1);
  const bool hybrid = MODE == 1 && a.window > 0;
  const int steps = MODE == 0 ? a.steps : (hybrid ? a.window : n / a.sps);

  // the first fill: for the symbols modes the loop starts below 2 sps
  float pos = MODE == 0 && a.p0 != nullptr ? a.p0[b] : s;
  int base = MODE == 0 ? lowest_sample(pos, s, last) / H * H : 0;
  fill<GROUP>(ring, rmask, f, n, base, H, lane);
  fill<GROUP>(ring, rmask, f, n, base + H, H, lane);
  if (hybrid) pos = static_cast<float>(coarse_phase<GROUP>(f, n, a.sps, lane, mask) + a.sps);
  cp_async_wait_all();
  __syncwarp(mask);
  bool pending = false;

  float kept = 0.0f;  // the position of step k0 + lane
  float sin_sum = 0.0f, cos_sum = 0.0f;
  const int from = a.window / 2;  // the hybrid's second half-window
  // a step moves the strobe by at most 1.5 sps, so the next kUpkeep steps read
  // no sample past floor(pos + 1.5 (kUpkeep - 1) sps) + 1 (one more for rounding)
  const float ahead = 1.5f * (kUpkeep - 1) * s;
  for (int k0 = 0; k0 < steps; k0 += GROUP) {
#pragma unroll
    for (int h = 0; h < GROUP; h += kUpkeep) {
      if (k0 + h >= steps) break;  // uniform over the warp
      // the ring's upkeep for the next kUpkeep steps, off their chain
      if (lowest_sample(pos, s, last) >= base + H) {  // the lower half is behind the loop
        if (pending) cp_async_wait_all();
        __syncwarp(mask);
        fill<GROUP>(ring, rmask, f, n, base + 2 * H, H, lane);
        base += H;
        pending = true;
      }
      if (pending && static_cast<int>(fminf(fmaxf(pos + ahead, 0.0f), last)) + 2 >= base + H) {
        cp_async_wait_all();
        __syncwarp(mask);
        pending = false;
      }
      const int count = min(kUpkeep, steps - k0 - h);
#pragma unroll
      for (int u = 0; u < kUpkeep; ++u) {
        if (u < count) {
          if (h + u == lane) kept = pos;
          pos = advance<METHOD>(ring, rmask, n, pos, s, half_s, a.gain);
        }
      }
    }
    const int count = min(GROUP, steps - k0);  // uniform over the warp
    if (lane < count) {
      const int j = k0 + lane;
      if (MODE == 0) {
        const long long o = static_cast<long long>(b) * steps + j;
        a.positions[o] = kept;
        a.valid[o] = kept <= last ? 1 : 0;
      } else if (!hybrid) {  // GROUP == kUpkeep: the ring still holds these steps' samples
        a.symbols[static_cast<long long>(b) * steps + j] =
            ring[static_cast<int>(fminf(fmaxf(rintf(kept), 0.0f), last)) & rmask];
      } else if (j >= from) {
        const float theta = __fmul_rn(kept, a.to_angle);
        sin_sum = __fadd_rn(sin_sum, sinf(theta));
        cos_sum = __fadd_rn(cos_sum, cosf(theta));
      }
    }
  }
  if (pending) cp_async_wait_all();  // nothing left in flight at exit
  if (!hybrid) return;

  // the steady-state phase, then the uniform strobes
  float phase = __fmul_rn(atan2f(group_sum<GROUP>(sin_sum, mask), group_sum<GROUP>(cos_sum, mask)),
                          a.to_samples);
  float m = fmodf(phase, s);  // torch.remainder: the sign of the divisor
  if (m < 0.0f) m = __fadd_rn(m, s);
  phase = m;
  if (a.phase != nullptr && lane == 0) a.phase[b] = phase;
  const int n_sym = n / a.sps;
  float2* out = a.symbols + static_cast<long long>(b) * n_sym;
  int k = lane;
  for (; k + (kUnroll - 1) * GROUP < n_sym; k += kUnroll * GROUP) {
    float2 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float t = __fadd_rn(phase, static_cast<float>(a.sps * (k + u * GROUP)));
      v[u] = __ldg(f + static_cast<int>(rintf(fminf(fmaxf(t, 0.0f), last))));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) out[k + u * GROUP] = v[u];
  }
  for (; k < n_sym; k += GROUP) {
    const float t = __fadd_rn(phase, static_cast<float>(a.sps * k));
    out[k] = __ldg(f + static_cast<int>(rintf(fminf(fmaxf(t, 0.0f), last))));
  }
}

// The ring's half for sps. Between two upkeeps the strobe moves at most
// 1.5 kUpkeep sps, which must not pass a whole half (one refill an upkeep),
// and the steps read from a symbol behind the strobe to a sample past it:
// H >= 1.5 kUpkeep sps + 2, twice over where it fits, so that a refill lands
// well before the loop reads it; 0 where even that exceeds kMaxHalf.
int ring_half(int sps) {
  const int need = 3 * kUpkeep * sps / 2 + 2;
  if (need > kMaxHalf) return 0;
  int h = kMinHalf;
  while (h < 2 * need && h < kMaxHalf) h *= 2;
  return h;
}

template <int METHOD, int MODE, int GROUP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kFrames) * 2 * p.half * sizeof(float2);
  static size_t allowed = 48 * 1024;  // raised once an instance (sps above 16)
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(timing_recovery_kernel<METHOD, MODE, GROUP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid((p.B + kFrames - 1) / kFrames);
  timing_recovery_kernel<METHOD, MODE, GROUP><<<grid, GROUP * kFrames, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int METHOD>
cudaError_t launch_method(const Params& p, int mode, cudaStream_t stream) {
  if (mode == 0) return launch<METHOD, 0, kLoopGroup>(p, stream);
  return p.window > 0 ? launch<METHOD, 1, kHybridGroup>(p, stream)
                      : launch<METHOD, 1, kLoopGroup>(p, stream);
}

int run(const Params& p, int method, int mode, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = method == 0 ? launch_method<0>(p, mode, stream)
                                      : launch_method<1>(p, mode, stream);
  if (err == cudaSuccess) ++timing_recovery_launches;
  return static_cast<int>(err);
}

Params params(const void* x, int B, int n, int sps, float gain) {
  Params p = {};
  p.x = static_cast<const float2*>(x);
  p.B = B;
  p.n = n;
  p.sps = sps;
  p.gain = gain;
  p.half = ring_half(sps);
  p.to_angle = static_cast<float>(2.0 * kPi / sps);
  p.to_samples = static_cast<float>(sps / (2.0 * kPi));
  return p;
}

}  // namespace

// Positions mode: positions [B, steps] f32 and valid [B, steps] u8 of frames
// x [B, n, 2] f32 from start positions p0 [B] f32 (nullptr: sps); method 0
// Gardner, 1 Mueller-Mueller.
extern "C" int vitiq_timing_scan(const void* x, const void* p0, void* positions, void* valid,
                                 int B, int n, int sps, int steps, int method, float gain,
                                 void* stream_ptr) {
  if (B < 1 || n < 1 || sps < 1 || steps < 1 || method < 0 || method > 1 ||
      ring_half(sps) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = params(x, B, n, sps, gain);
  p.p0 = static_cast<const float*>(p0);
  p.positions = static_cast<float*>(positions);
  p.valid = static_cast<uint8_t*>(valid);
  p.steps = steps;
  return run(p, method, 0, stream_ptr);
}

// Symbols mode: symbols [B, n / sps, 2] f32 of frames x [B, n, 2] f32; window
// 0 the full loop (n / sps steps from sps), else the hybrid's `window` steps
// (window < n / sps), its phase [B] f32 into `phase` unless nullptr.
extern "C" int vitiq_timing_symbols(const void* x, void* symbols, void* phase, int B, int n,
                                    int sps, int window, int method, float gain,
                                    void* stream_ptr) {
  if (B < 1 || sps < 2 || n < sps || window < 0 || window >= n / sps || method < 0 ||
      method > 1 || ring_half(sps) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = params(x, B, n, sps, gain);
  p.symbols = static_cast<float2*>(symbols);
  p.phase = static_cast<float*>(phase);
  p.window = window;
  return run(p, method, 1, stream_ptr);
}

// The launches of timing_recovery_kernel since the last reset, into out[1];
// with `reset`, the count then starts again from 0.
extern "C" int vitiq_timing_recovery_launches(unsigned long long* out, int reset) {
  if (out) out[0] = timing_recovery_launches;
  if (reset) timing_recovery_launches = 0;
  return 0;
}
