// Symbol timing recovery's error-feedback loops on the card (sm_90a):
// timing_scan_kernel<METHOD>, METHOD 0 the Gardner loop, 1 Mueller-Mueller.
//
// It replaces no TPU kernel. The JAX package runs these loops as
// `lax.scan`s (vitiq/dsp/timing.py:76-137, `_gardner_scan` and
// `_mueller_muller_scan`, vmapped over frames), which XLA compiles into one
// loop on the device. In PyTorch the same recurrence written as a loop of
// tensor operations launches some 60 small kernels from the host for every
// step (six linear interpolations, the error, the update); at 64 to 1,024
// steps a batch the card would wait on the host far longer than the
// classifier runs. So the recurrence is one kernel: one thread a frame
// carries the strobe position in a register through every step, reading the
// frame's samples where the position lands.
//
// What it computes, for frame b of x [B, n] (float2: I, Q), from pos = p0[b]
// (or sps) and for k < steps:
//   y(t)  = x[lo] (1 - f) + x[hi] f   at t clipped to [0, n-1], lo = floor(t),
//           hi = min(lo + 1, n - 1), f = t - lo (linear interpolation)
//   Gardner: e = (yI(pos) - yI(pos - sps)) yI(pos - sps/2) + the same in Q,
//            next = pos + sps - clip(gain e, -sps/2, sps/2)
//   M&M:     e = sign(yI(pos - sps)) yI(pos) - sign(yI(pos)) yI(pos - sps)
//                + the same in Q,
//            next = pos + sps + clip(gain e, -sps/2, sps/2)
//   positions[b, k] = pos, valid[b, k] = pos <= n - 1.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn): the
// compiler would otherwise contract a product and a sum into one FMA, one
// rounding where the plain PyTorch loop (`ops/cuda/timing.py`,
// `timing_scan_plain`) rounds twice, and the loop feeds each rounding back
// into the next step. So the kernel gives the plain loop's bits on the same
// input. The JAX package's loop is compiled by XLA, which may contract and
// sums in its own order: the port is held to it by position tolerance.
//
// What bounds it: the chain of dependent steps, each a load whose address
// depends on the previous step's arithmetic (a load from L1 or L2, then some
// 30 dependent float operations). Bytes are few (each frame read once,
// 5 bytes a step written) and so are operations. One thread a frame keeps the
// chain in registers; blocks of 32 threads spread a batch of a few thousand
// frames over every SM. Faster versions (a warp a frame staging the frame in
// shared memory, several frames a thread to overlap their chains) are later
// work.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // threads (frames) a block

unsigned long long timing_scan_launches = 0;

__device__ __forceinline__ float2 lin_interp(const float2* __restrict__ f, int n, float t) {
  const float p = fminf(fmaxf(t, 0.0f), static_cast<float>(n - 1));
  const int lo = static_cast<int>(floorf(p));
  const int hi = min(lo + 1, n - 1);
  const float frac = __fsub_rn(p, static_cast<float>(lo));
  const float w = __fsub_rn(1.0f, frac);
  const float2 a = __ldg(f + lo);
  const float2 c = __ldg(f + hi);
  return make_float2(__fadd_rn(__fmul_rn(a.x, w), __fmul_rn(c.x, frac)),
                     __fadd_rn(__fmul_rn(a.y, w), __fmul_rn(c.y, frac)));
}

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

template <int METHOD>
__global__ void __launch_bounds__(kThreads)
    timing_scan_kernel(const float2* __restrict__ x, const float* __restrict__ p0, int B, int n,
                       int sps, int steps, float gain, float* __restrict__ positions,
                       uint8_t* __restrict__ valid) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float2* f = x + static_cast<long long>(b) * n;
  float* out = positions + static_cast<long long>(b) * steps;
  uint8_t* ok = valid + static_cast<long long>(b) * steps;
  const float s = static_cast<float>(sps);
  const float half = 0.5f * s;
  const float last = static_cast<float>(n - 1);
  float pos = p0 != nullptr ? p0[b] : s;
  for (int k = 0; k < steps; ++k) {
    const float2 y = lin_interp(f, n, pos);
    const float2 yp = lin_interp(f, n, __fsub_rn(pos, s));
    float err;
    if (METHOD == 0) {
      const float2 ym = lin_interp(f, n, __fsub_rn(pos, half));
      err = __fadd_rn(__fmul_rn(__fsub_rn(y.x, yp.x), ym.x),
                      __fmul_rn(__fsub_rn(y.y, yp.y), ym.y));
    } else {
      const float ei = __fsub_rn(__fmul_rn(sign_of(yp.x), y.x), __fmul_rn(sign_of(y.x), yp.x));
      const float eq = __fsub_rn(__fmul_rn(sign_of(yp.y), y.y), __fmul_rn(sign_of(y.y), yp.y));
      err = __fadd_rn(ei, eq);
    }
    const float step = fminf(fmaxf(__fmul_rn(gain, err), -half), half);
    out[k] = pos;
    ok[k] = pos <= last ? 1 : 0;
    pos = METHOD == 0 ? __fsub_rn(__fadd_rn(pos, s), step) : __fadd_rn(__fadd_rn(pos, s), step);
  }
}

}  // namespace

// positions [B, steps] f32 and valid [B, steps] u8 of frames x [B, n, 2] f32
// from start positions p0 [B] f32 (nullptr: sps); method 0 Gardner, 1
// Mueller-Mueller.
extern "C" int vitiq_timing_scan(const void* x, const void* p0, void* positions, void* valid,
                                 int B, int n, int sps, int steps, int method, float gain,
                                 void* stream_ptr) {
  if (B < 1 || n < 1 || sps < 1 || steps < 1 || method < 0 || method > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((B + kThreads - 1) / kThreads);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float2* xf = static_cast<const float2*>(x);
  const float* start = static_cast<const float*>(p0);
  float* pos = static_cast<float*>(positions);
  uint8_t* ok = static_cast<uint8_t*>(valid);
  if (method == 0) {
    timing_scan_kernel<0><<<grid, kThreads, 0, stream>>>(xf, start, B, n, sps, steps, gain, pos,
                                                         ok);
  } else {
    timing_scan_kernel<1><<<grid, kThreads, 0, stream>>>(xf, start, B, n, sps, steps, gain, pos,
                                                         ok);
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++timing_scan_launches;
  return static_cast<int>(err);
}

// The launches of timing_scan_kernel since the last reset, into out[1];
// with `reset`, the count then starts again from 0.
extern "C" int vitiq_timing_scan_launches(unsigned long long* out, int reset) {
  if (out) out[0] = timing_scan_launches;
  if (reset) timing_scan_launches = 0;
  return 0;
}
