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
// Design: one thread per element, a grid-stride loop. The shared scale s is
// a device scalar read by pointer (it is a pmax computed on the device, so
// the host never waits for it). The plain PyTorch version computes
// inv = b / (s + 1e-30) once in f32, then rounds x * inv and + noise
// separately; nvcc would contract that multiply and add into one FMA, which
// moves the floor at integer boundaries, so both steps are spelled with
// round-to-nearest intrinsics and the kernel gives the plain version's bits.
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

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                  float* __restrict__ y, int64_t n, int budget) {
  const float step = __fdiv_rn(scale[0], static_cast<float>(budget));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
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
  dequantize_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, scale, y, n, budget);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
