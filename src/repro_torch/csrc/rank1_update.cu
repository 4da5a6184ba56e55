// Fused Frank-Wolfe rank-1 state update, f32, sm_90a:
//   rank1_update       Z' = a*Z + b*x y^T
//   rank1_update_axpy  Z' = a*Z + b*x y^T + c*Y0
//
// Replaces src/repro/kernels/rank1_update/kernel.py: rank1_update
// (_rank1_kernel) and rank1_update_axpy (_rank1_axpy_kernel).
//
// Bound: bytes. One elementwise pass over (n, m): rank1_update reads Z and
// writes Z' (8 bytes per element), the axpy form also reads Y0 (12 bytes per
// element); x and y are O(n + m). At 1,281,167 x 1000 that is 10.25 GB and
// 15.37 GB.
//
// Design: one templated kernel, two instantiations (AXPY false/true). Each
// block walks a few whole rows with 16-byte vectors along the row (float4
// when m % 4 == 0 and every (n, m) pointer is 16-byte aligned, else scalar),
// reads x[row] once per row, and masks the ragged tail in the loop bound. The
// scalars a, b, c stay on the device (read from `scal`), so a step size that
// was computed on the device never makes the host wait. The caller may pass
// out == z: each element is read and then written by the same thread, so the
// update can run in place (the port updates the MTLS residual and the
// logistic logits in place, which saves one (n, m) buffer per epoch). The
// arithmetic is spelled with round-to-nearest intrinsics in the plain
// version's order, a*z + b*(x*y) + c*y0, so no multiply-add is contracted and
// the kernel gives the plain PyTorch version's bits.
//
// Rank-k forms for the block:k solver (new behaviour, as the rank-1 kernel is:
// the reference's tasks.update forms the block atom with XLA, never a kernel):
//   rankk_update       Z' = a*Z + b*P Q^T
//   rankk_update_axpy  Z' = a*Z + b*P Q^T + c*Y0
// with P (n, k) (X U with the blend folded in) and Q (m, k) (V), row-major.
//
// Bound: bytes, as the rank-1 forms (8 or 12 bytes an element; P and Q are
// O((n + m) k)); at 1,281,167 x 1000 and k = 32 the 2 n m k = 82 GFLOP of the
// products take 1.22 ms at 67 TFLOP/s against 4.59 ms of bytes (axpy form).
//
// Design: a block of 256 threads (32 across the columns, 8 down the rows)
// owns 128 columns and a chunk of 128 rows, walked in tiles of 32 rows. The
// 128 columns' Q rows sit transposed in shared memory (qs[j][c]) for the
// whole chunk, each tile's 32 P rows beside them (ps[j][r]); k > 32 goes
// through both in slices of 32. A thread forms the 4 x 4 dots of rows
// ty + 8 i and columns tx + 32 j from registers (8 shared loads for 16
// multiply-adds), each dot one fmaf chain in ascending j, then reads z (and
// y0) for those 16 elements with the warp on 32 consecutive columns, forms
// a*z + b*dot (+ c*y0) with round-to-nearest intrinsics in the plain
// version's order and writes it back: each element is read and written by
// one thread, so out may be z. The scalars stay on the device.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float combine(float a, float z, float b, float xr, float yj,
                                         float c, float y0, bool axpy) {
  float o = __fadd_rn(__fmul_rn(a, z), __fmul_rn(b, __fmul_rn(xr, yj)));
  if (axpy) o = __fadd_rn(o, __fmul_rn(c, y0));
  return o;
}

template <int VEC, bool AXPY>
__global__ void __launch_bounds__(kThreads)
rank1_kernel(float* out, const float* z, const float* __restrict__ y0,
             const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ scal, int64_t n, int64_t m) {
  const float a = scal[0];
  const float b = scal[1];
  const float c = AXPY ? scal[2] : 0.f;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int64_t row1 = (row0 + kRowsPerBlock < n) ? row0 + kRowsPerBlock : n;
  for (int64_t r = row0; r < row1; ++r) {
    const float xr = __ldg(x + r);
    const int64_t base = r * m;
    if constexpr (VEC == 4) {
      const int64_t m4 = m / 4;
      for (int64_t j = threadIdx.x; j < m4; j += kThreads) {
        const float4 zz = reinterpret_cast<const float4*>(z + base)[j];
        const float4 yy = __ldg(reinterpret_cast<const float4*>(y) + j);
        float4 cc = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (AXPY) cc = __ldcs(reinterpret_cast<const float4*>(y0 + base) + j);
        float4 o;
        o.x = combine(a, zz.x, b, xr, yy.x, c, cc.x, AXPY);
        o.y = combine(a, zz.y, b, xr, yy.y, c, cc.y, AXPY);
        o.z = combine(a, zz.z, b, xr, yy.z, c, cc.z, AXPY);
        o.w = combine(a, zz.w, b, xr, yy.w, c, cc.w, AXPY);
        reinterpret_cast<float4*>(out + base)[j] = o;
      }
    } else {
      for (int64_t j = threadIdx.x; j < m; j += kThreads) {
        const float cc = AXPY ? __ldcs(y0 + base + j) : 0.f;
        out[base + j] = combine(a, z[base + j], b, xr, __ldg(y + j), c, cc, AXPY);
      }
    }
  }
}

template <bool AXPY>
void launch(float* out, const float* z, const float* y0, const float* x, const float* y,
            const float* scal, int64_t n, int64_t m, int vec, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock));
  if (vec == 4) {
    rank1_kernel<4, AXPY><<<grid, kThreads, 0, s>>>(out, z, y0, x, y, scal, n, m);
  } else {
    rank1_kernel<1, AXPY><<<grid, kThreads, 0, s>>>(out, z, y0, x, y, scal, n, m);
  }
}

// ---------------------------------------------------------------------------
// Rank-k forms
// ---------------------------------------------------------------------------

constexpr int kRKCols = 128;    // columns of Z per block
constexpr int kRKRows = 128;    // rows of Z per block, in tiles of kRKTile
constexpr int kRKTile = 32;
constexpr int kRKSlice = 32;    // k per shared-memory slice

template <bool AXPY>
__global__ void __launch_bounds__(kThreads)
rankk_kernel(float* out, const float* z, const float* __restrict__ y0,
             const float* __restrict__ p, const float* __restrict__ q,
             const float* __restrict__ scal, int64_t n, int64_t m, int64_t k) {
  // padded by one: the loads write down a column (consecutive j)
  __shared__ float qs[kRKSlice][kRKCols + 1];
  __shared__ float ps[kRKSlice][kRKTile + 1];
  const float a = scal[0];
  const float b = scal[1];
  const float c = AXPY ? scal[2] : 0.f;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kRKCols;
  const int64_t rows0 = static_cast<int64_t>(blockIdx.x) * kRKRows;
  const int64_t rows1 = (rows0 + kRKRows < n) ? rows0 + kRKRows : n;
  const bool one_slice = k <= kRKSlice;
  for (int64_t r0 = rows0; r0 < rows1; r0 += kRKTile) {
    float dot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dot[i][j] = 0.f;
    for (int64_t j0 = 0; j0 < k; j0 += kRKSlice) {
      const int width = static_cast<int>(k - j0 < kRKSlice ? k - j0 : kRKSlice);
      if (!one_slice || r0 == rows0) {
        for (int i = threadIdx.x; i < kRKSlice * kRKCols; i += kThreads) {
          const int cc = i / kRKSlice, jj = i % kRKSlice;
          const int64_t gc = c0 + cc;
          qs[jj][cc] = (gc < m && jj < width) ? __ldg(q + gc * k + j0 + jj) : 0.f;
        }
      }
      for (int i = threadIdx.x; i < kRKSlice * kRKTile; i += kThreads) {
        const int rr = i / kRKSlice, jj = i % kRKSlice;
        const int64_t gr = r0 + rr;
        ps[jj][rr] = (gr < rows1 && jj < width) ? __ldg(p + gr * k + j0 + jj) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < width; ++jj) {
        float pv[4], qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[jj][ty + 8 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) qv[j] = qs[jj][tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dot[i][j] = fmaf(pv[i], qv[j], dot[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = r0 + ty + 8 * i;
      if (r >= rows1) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = c0 + tx + 32 * j;
        if (col >= m) continue;
        const int64_t e = r * m + col;
        float o = __fadd_rn(__fmul_rn(a, z[e]), __fmul_rn(b, dot[i][j]));
        if (AXPY) o = __fadd_rn(o, __fmul_rn(c, __ldcs(y0 + e)));
        out[e] = o;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* r1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (n, m) = a*z + b*x y^T [+ c*y0]; scal = [a, b] or [a, b, c] on the device.
// y0 is ignored (may be null) unless axpy != 0. out may equal z.
int r1_update_f32(float* out, const float* z, const float* y0, const float* x,
                  const float* y, const float* scal, int64_t n, int64_t m, int axpy,
                  int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axpy) {
    launch<true>(out, z, y0, x, y, scal, n, m, vec, s);
  } else {
    launch<false>(out, z, y0, x, y, scal, n, m, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (n, m) = a*z + b*p q^T [+ c*y0] for p (n, k), q (m, k); scal on the
// device as for r1_update_f32. out may equal z. k >= 1.
int rk_update_f32(float* out, const float* z, const float* y0, const float* p, const float* q,
                  const float* scal, int64_t n, int64_t m, int64_t k, int axpy, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t col_tiles = (m + kRKCols - 1) / kRKCols;
  if (col_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kRKRows - 1) / kRKRows),
                  static_cast<unsigned>(col_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axpy) {
    rankk_kernel<true><<<grid, kThreads, 0, s>>>(out, z, y0, p, q, scal, n, m, k);
  } else {
    rankk_kernel<false><<<grid, kThreads, 0, s>>>(out, z, y0, p, q, scal, n, m, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
