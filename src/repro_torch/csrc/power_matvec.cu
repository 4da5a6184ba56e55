// Streaming matvec / rmatvec for the DFW-Trace power method, f32, sm_90a.
//
// Replaces src/repro/kernels/power_matvec/kernel.py: matvec (_matvec_kernel)
// and rmatvec (_rmatvec_kernel).
//
// Bound: bytes. Each call reads the (n, m) f32 matrix A once and does 2 flops
// per element (0.5 flop/byte), far below the card's flop/byte balance, so the
// least time is 4*n*m bytes over the memory rate (R: 1,281,167 x 1000 is
// 5.12 GB; X: 1,281,167 x 2048 is 10.50 GB).
//
// Design:
// - matvec: one warp per row, 16-byte loads along the row (float4 when m % 4
//   == 0 and the pointers are 16-byte aligned, else 4-byte loads), four
//   independent f32 accumulators, a shuffle reduction. The ragged row tail is
//   masked in the loop bound: nothing is padded or copied.
// - rmatvec: the TPU kernel carries the column sum across a sequential grid.
//   Hopper blocks run in no order, so the sum is split in two fixed-order
//   stages instead of float atomics: blocks of (32 x 8) threads own a column
//   tile and a slab of rows and write per-slab partial sums (slabs, m); a
//   second small kernel sums the slabs in a fixed order. Repeated calls on
//   the same inputs give identical bits.
// - A is streamed with evict-first loads (__ldcs): it is far larger than L2
//   and is not reused within a call; the vector stays in cache.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerMatvecBlock = 8;  // warps (rows) per matvec block
constexpr int kRowLanes = 8;            // row lanes (threadIdx.y) in rmatvec

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int VEC>
__global__ void __launch_bounds__(kWarp * kRowsPerMatvecBlock)
matvec_kernel(const float* __restrict__ a, const float* __restrict__ v,
              float* __restrict__ out, int64_t n, int64_t m) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerMatvecBlock + threadIdx.x / kWarp;
  if (row >= n) return;  // whole warp leaves together: row is per warp
  const float* arow = a + row * m;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  if constexpr (VEC == 4) {
    const float4* a4 = reinterpret_cast<const float4*>(arow);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const int64_t m4 = m / 4;
#pragma unroll 4
    for (int64_t j = lane; j < m4; j += kWarp) {
      const float4 x = __ldcs(a4 + j);
      const float4 w = __ldg(v4 + j);
      acc0 = fmaf(x.x, w.x, acc0);
      acc1 = fmaf(x.y, w.y, acc1);
      acc2 = fmaf(x.z, w.z, acc2);
      acc3 = fmaf(x.w, w.w, acc3);
    }
  } else {
#pragma unroll 4
    for (int64_t j = lane; j < m; j += kWarp) {
      acc0 = fmaf(__ldcs(arow + j), __ldg(v + j), acc0);
    }
  }
  const float acc = warp_sum((acc0 + acc1) + (acc2 + acc3));
  if (lane == 0) out[row] = acc;
}

// Stage 1: partial[slab, col] = sum over the slab's rows of u[r] * A[r, col].
template <int VEC>
__global__ void __launch_bounds__(kWarp * kRowLanes)
rmatvec_partial_kernel(const float* __restrict__ a, const float* __restrict__ u,
                       float* __restrict__ partial, int64_t n, int64_t m,
                       int64_t rows_per_slab) {
  __shared__ float sh[kRowLanes][kWarp * VEC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kWarp + tx) * VEC;
  const int64_t slab = blockIdx.y;
  const int64_t r0 = slab * rows_per_slab;
  const int64_t r1 = (r0 + rows_per_slab < n) ? r0 + rows_per_slab : n;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  if (col < m) {  // m % VEC == 0, so a vector is all in or all out
#pragma unroll 4
    for (int64_t r = r0 + ty; r < r1; r += kRowLanes) {
      const float ur = __ldg(u + r);
      if constexpr (VEC == 4) {
        const float4 x = __ldcs(reinterpret_cast<const float4*>(a + r * m + col));
        acc[0] = fmaf(ur, x.x, acc[0]);
        acc[1] = fmaf(ur, x.y, acc[1]);
        acc[2] = fmaf(ur, x.z, acc[2]);
        acc[3] = fmaf(ur, x.w, acc[3]);
      } else {
        acc[0] = fmaf(ur, __ldcs(a + r * m + col), acc[0]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) sh[ty][tx * VEC + k] = acc[k];
  __syncthreads();
  if (ty == 0 && col < m) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < kRowLanes; ++y) s += sh[y][tx * VEC + k];
      partial[slab * m + col + k] = s;
    }
  }
}

// Stage 2: out[col] = sum over slabs of partial[slab, col], in a fixed order.
__global__ void __launch_bounds__(kWarp * kRowLanes)
rmatvec_finish_kernel(const float* __restrict__ partial, float* __restrict__ out,
                      int64_t slabs, int64_t m) {
  __shared__ float sh[kRowLanes][kWarp];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kWarp + tx;
  float acc = 0.f;
  if (col < m) {
    for (int64_t s = ty; s < slabs; s += kRowLanes) acc += partial[s * m + col];
  }
  sh[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < m) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < kRowLanes; ++y) s += sh[y][tx];
    out[col] = s;
  }
}

}  // namespace

extern "C" {

const char* pm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (n,) = A (n, m) @ v (m,). vec is 4 (aligned float4 path) or 1.
int pm_matvec_f32(const float* a, const float* v, float* out, int64_t n, int64_t m,
                  int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kWarp * kRowsPerMatvecBlock);
  const dim3 grid(static_cast<unsigned>((n + kRowsPerMatvecBlock - 1) / kRowsPerMatvecBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    matvec_kernel<4><<<grid, block, 0, s>>>(a, v, out, n, m);
  } else {
    matvec_kernel<1><<<grid, block, 0, s>>>(a, v, out, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (m,) = A (n, m)^T @ u (n,), through partial (ceil(n / rows_per_slab), m).
int pm_rmatvec_f32(const float* a, const float* u, float* partial, float* out,
                   int64_t n, int64_t m, int64_t rows_per_slab, int vec,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t slabs = (n + rows_per_slab - 1) / rows_per_slab;
  const dim3 block(kWarp, kRowLanes);
  const dim3 grid(static_cast<unsigned>((m + kWarp * vec - 1) / (kWarp * vec)),
                  static_cast<unsigned>(slabs));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    rmatvec_partial_kernel<4><<<grid, block, 0, s>>>(a, u, partial, n, m, rows_per_slab);
  } else {
    rmatvec_partial_kernel<1><<<grid, block, 0, s>>>(a, u, partial, n, m, rows_per_slab);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2(static_cast<unsigned>((m + kWarp - 1) / kWarp));
  rmatvec_finish_kernel<<<grid2, block, 0, s>>>(partial, out, slabs, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
