// Stochastic-rounding quantize / dequantize of the int8 reducer, sm_90a:
//   quantize    q = clip(floor(x * (b / (s + 1e-30)) + noise), -b, b) as int8
//   dequantize  y = q * (s / b) as f32
//
// Replaces src/repro/kernels/quantize/kernel.py: quantize (_quantize_kernel)
// and dequantize (_dequantize_kernel).
//
// Bound: bytes. One elementwise pass each: quantize reads x and noise and
// writes q (9 bytes per element), dequantize reads q and writes y (5 bytes).
// The power method's vectors are short (d = 480,189 or m = 17,770 at the
// Netflix shapes), so at 3.35 TB/s the bound is about a microsecond and a
// launch costs more: the pair is launch-bound.
//
// Design: quantize takes one element a thread in a grid-stride loop. The
// shared scale s is a device scalar read by pointer (it is a pmax computed
// on the device, so the host never waits for it). The plain PyTorch version computes
// inv = b / (s + 1e-30) once in f32, then rounds x * inv and + noise
// separately; nvcc would contract that multiply and add into one FMA, which
// moves the floor at integer boundaries, so both steps are spelled with
// round-to-nearest intrinsics and the kernel gives the plain version's bits.
//
// dequantize takes four elements a thread where n gives every SM a block
// that way (n >= 4 * 256 * 132): one 4-byte load of int8 and one 16-byte
// float4 store (a warp's load moves 128 bytes of q, where one element a
// thread moved 32), on a grid of at most one wave (at n = 480,189: 469 blocks
// of 256 threads), grid-stride beyond. Below that size, past the last four,
// and for a q not 4-byte or a y not 16-byte aligned, one element a thread.
// At the int8 reducer's sizes the time is the launch and one memory round
// trip, and what shortens it is threads in flight, not wider ones
// (tools/torch_dequantize_gather_probe.py times the widths: sixteen a thread
// on one wave of 118 blocks ran slower than one a thread on 1,876 blocks at
// u, and far slower at v). step = s / b is formed once per thread with a
// round-to-nearest division and every product with a round-to-nearest
// multiply, q converted exactly: the plain version's bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ noise,
                const float* __restrict__ scale, int8_t* __restrict__ q, int64_t n,
                int budget) {
  const float b = static_cast<float>(budget);
  const float inv = __fdiv_rn(b, __fadd_rn(scale[0], 1e-30f));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    float v = floorf(__fadd_rn(__fmul_rn(x[i], inv), noise[i]));
    v = fminf(fmaxf(v, -b), b);
    q[i] = static_cast<int8_t>(v);
  }
}

// Elements a thread on dequantize's vector path (one V-byte load of int8:
// 4, 8 or 16), the least n that takes it (a block of 256 such threads for
// each of the 132 SMs) and the cap on its grid: blocks that fill the card
// once at 8 blocks of 256 threads an SM, grid-stride beyond.
constexpr int kDequantVec = 4;
constexpr int64_t kVecMinElements = int64_t(kDequantVec) * kThreads * 132;
constexpr int64_t kWaveBlocks = 132 * 8;

template <int V>
struct Bytes;
template <>
struct Bytes<4> { using type = int; };
template <>
struct Bytes<8> { using type = int2; };
template <>
struct Bytes<16> { using type = int4; };

template <int V>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                  float* __restrict__ y, int64_t n, int budget, int vec) {
  using Load = typename Bytes<V>::type;
  const float step = __fdiv_rn(scale[0], static_cast<float>(budget));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t groups = n / V;
    for (int64_t g = tid; g < groups; g += stride) {
      const Load raw = __ldcs(reinterpret_cast<const Load*>(q) + g);
      const int32_t* words = reinterpret_cast<const int32_t*>(&raw);
      float4* out = reinterpret_cast<float4*>(y + g * V);
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        const int32_t w = words[j];
        __stcs(out + j, make_float4(
            __fmul_rn(static_cast<float>(static_cast<int8_t>(w)), step),
            __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> 8)), step),
            __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> 16)), step),
            __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> 24)), step)));
      }
    }
    done = groups * V;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    y[i] = __fmul_rn(static_cast<float>(q[i]), step);
  }
}

unsigned blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

const char* qz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (n,) int8 = quantize(x (n,), noise (n,), *scale); 1 <= budget <= 127, n >= 1.
int qz_quantize_f32(const float* x, const float* noise, const float* scale, int8_t* q,
                    int64_t n, int budget, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, noise, scale, q, n, budget);
  return static_cast<int>(cudaGetLastError());
}

// y (n,) f32 = q (n,) * (*scale / budget); 1 <= budget <= 127, n >= 1.
int qz_dequantize_f32(const int8_t* q, const float* scale, float* y, int64_t n, int budget,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = n >= kVecMinElements && reinterpret_cast<uintptr_t>(q) % kDequantVec == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0;
  int64_t blocks = vec ? (n / kDequantVec + kThreads - 1) / kThreads : blocks_for(n);
  if (vec && blocks > kWaveBlocks) blocks = kWaveBlocks;
  dequantize_kernel<kDequantVec><<<static_cast<unsigned>(blocks), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(q, scale, y, n, budget,
                                                                        vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
