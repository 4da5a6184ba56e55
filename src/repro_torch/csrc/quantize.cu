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
// launch costs more.
//
// Both kernels take four elements a thread where n gives every SM a block
// that way (n >= 4 * 256 * 132 = 135,168), on a grid of at most one wave
// (132 SMs x 8 blocks of 256 threads), grid-stride beyond. quantize then
// makes one 16-byte streaming load (__ldcs) each of x and noise and one
// 4-byte store of four int8; dequantize one 4-byte load of int8 and one
// 16-byte float4 store. A warp's store of q (or load, for dequantize) then
// moves 128 bytes, where one element a thread moved 32. Below that size,
// past the last four, and for a pointer off its alignment (x or noise not 16
// bytes, q not 4, y not 16), one element a thread. At the int8 reducer's
// sizes the time is the launch and one memory round trip, and what shortens
// it is threads in flight, not wider ones
// (tools/torch_dequantize_gather_probe.py times the widths: sixteen a thread
// on one wave of 118 blocks ran slower than one a thread on 1,876 blocks at
// u, and far slower at v).
//
// Rounding: the shared scale s is a device scalar read by pointer (it is a
// pmax computed on the device, so the host never waits for it). The plain
// PyTorch version computes inv = b / (s + 1e-30) once in f32, then rounds
// x * inv and + noise separately; nvcc would contract that multiply and add
// into one FMA, which moves the floor at integer boundaries, so both steps
// are spelled with round-to-nearest intrinsics. dequantize forms step = s / b
// once per thread with a round-to-nearest division and every product with a
// round-to-nearest multiply, q converted exactly. Both give the plain
// version's bits at every width.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

// Elements a thread on each kernel's vector path (quantize: V/4 float4 loads
// each of x and noise and one V-byte store, 4 or 8; dequantize: one V-byte
// load of int8, 4, 8 or 16), the least n that takes it (a block of 256 such
// threads for each of the 132 SMs) and the cap on its grid: blocks that
// fill the card once at 8 blocks of 256 threads an SM, grid-stride beyond.
constexpr int kQuantVec = 4;
constexpr int64_t kQuantVecMinElements = int64_t(kQuantVec) * kThreads * 132;
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

__device__ __forceinline__ uint32_t quantize_one(float x, float noise, float inv, float b) {
  float v = floorf(__fadd_rn(__fmul_rn(x, inv), noise));
  v = fminf(fmaxf(v, -b), b);
  return static_cast<uint8_t>(static_cast<int8_t>(v));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ noise,
                const float* __restrict__ scale, int8_t* __restrict__ q, int64_t n,
                int budget, int vec) {
  using Store = typename Bytes<V>::type;
  const float b = static_cast<float>(budget);
  const float inv = __fdiv_rn(b, __fadd_rn(scale[0], 1e-30f));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t groups = n / V;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* n4 = reinterpret_cast<const float4*>(noise);
    for (int64_t g = tid; g < groups; g += stride) {
      Store packed;
      uint32_t* words = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        const float4 xv = __ldcs(x4 + g * (V / 4) + j);
        const float4 nv = __ldcs(n4 + g * (V / 4) + j);
        words[j] = quantize_one(xv.x, nv.x, inv, b) |
                   (quantize_one(xv.y, nv.y, inv, b) << 8) |
                   (quantize_one(xv.z, nv.z, inv, b) << 16) |
                   (quantize_one(xv.w, nv.w, inv, b) << 24);
      }
      reinterpret_cast<Store*>(q)[g] = packed;
    }
    done = groups * V;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    q[i] = static_cast<int8_t>(quantize_one(x[i], noise[i], inv, b));
  }
}

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
  const int vec = n >= kQuantVecMinElements && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(noise) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % kQuantVec == 0;
  int64_t blocks = vec ? (n / kQuantVec + kThreads - 1) / kThreads : blocks_for(n);
  if (vec && blocks > kWaveBlocks) blocks = kWaveBlocks;
  quantize_kernel<kQuantVec><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(x, noise, scale, q, n,
                                                                    budget, vec);
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
