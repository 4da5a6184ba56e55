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

}  // extern "C"
