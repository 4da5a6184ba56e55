// The card's rate of random row gathers from a table in L2 (or past it), for
// the gather floors of the port's COO kernels (tools/torch_gather_probe.py).
//
// A grid of 8 blocks of 256 threads an SM walks `count` row reads; read i
// takes row hash(i) of the table (a multiplicative hash, no index array, so
// nothing but the gathers moves), LPR lanes a row, each lane W / LPR floats
// of it (16-byte loads where that is a multiple of 4, else 4-byte), four rows
// a lane in flight. Each thread writes its sum once, so nothing is dropped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t row_of(int64_t i, uint32_t rows) {
  uint32_t h = static_cast<uint32_t>(i) * 2654435761u;
  h ^= h >> 15;
  h *= 2246822519u;
  h ^= h >> 13;
  return __umulhi(h, rows);
}

template <int W, int LPR>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table, uint32_t rows, int64_t count,
                   float* __restrict__ sink) {
  constexpr int kPer = W / LPR;
  constexpr int kVec = kPer % 4 == 0;
  constexpr int kInFlight = 4;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t cells = static_cast<int64_t>(gridDim.x) * kThreads / LPR;
  const int sub = threadIdx.x % LPR;
  float acc = 0.f;
  for (int64_t i0 = tid / LPR; i0 < count; i0 += cells * kInFlight) {
    float got[kInFlight][kPer];
#pragma unroll
    for (int f = 0; f < kInFlight; ++f) {
      const int64_t i = i0 + f * cells;
      const float* src = table + static_cast<int64_t>(row_of(i, rows)) * W + sub * kPer;
      if (i < count) {
        if (kVec) {
#pragma unroll
          for (int j = 0; j < kPer; j += 4) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(src + j));
            got[f][j] = t.x, got[f][j + 1] = t.y, got[f][j + 2] = t.z, got[f][j + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kPer; ++j) got[f][j] = __ldg(src + j);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) got[f][j] = 0.f;
      }
    }
#pragma unroll
    for (int f = 0; f < kInFlight; ++f)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc += got[f][j];
  }
  sink[tid] = acc;
}

}  // namespace

extern "C" {

// Rows of w = 8 or 32 floats read lpr lanes a row (1, 2 or 8 at w = 8; 1, 8
// or 32 at w = 32); sink holds blocks * 256 floats. 0 or a CUDA error code.
int gather_probe(int w, int lpr, const float* table, uint32_t rows, int64_t count, float* sink,
                 int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = static_cast<unsigned>(blocks);
#define PROBE(W, L) gather_rows_kernel<W, L><<<b, kThreads, 0, s>>>(table, rows, count, sink)
  if (w == 8 && lpr == 1) PROBE(8, 1);
  else if (w == 8 && lpr == 2) PROBE(8, 2);
  else if (w == 8 && lpr == 8) PROBE(8, 8);
  else if (w == 32 && lpr == 1) PROBE(32, 1);
  else if (w == 32 && lpr == 8) PROBE(32, 8);
  else if (w == 32 && lpr == 32) PROBE(32, 32);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef PROBE
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
