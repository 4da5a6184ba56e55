// Fused factor-form scoring for the serving path, f32, sm_90a:
//     out (b, n_out) = ((X (b, n_in) @ A (r, n_in)^T) * s (r,)) @ B (r, n_out)
//
// Replaces src/repro/kernels/factor_matvec/kernel.py: factor_matvec
// (_factor_matvec_kernel). The factored iterate W = A^T diag(s) B is never
// formed; the rank-r intermediate T = (X A^T) * s stays in shared memory.
//
// Bound: at serving batches (b <= 64, r <= 64) the kernel reads A and B once
// (about 0.8 MB at 2048 -> 1000, r = 64) and does 25 MFLOP, under a
// microsecond of the card's time either way: it is bound by its launch and
// by the host around it. At b = 1024, r = 256 it is bound by f32 operations
// (1.6 GFLOP at the 67 TFLOP/s non-tensor-core peak, 24 us). This first
// version stays on the CUDA cores in f32 (no TF32: it would fail the serving
// engine's 1e-4 start-up check); tensor cores are later work.
//
// Design:
// - The TPU kernel carries T across its sequential out-axis grid in VMEM.
//   Hopper blocks run in no order, so a block owns ROWS batch rows and does
//   both stages itself: stage 1 writes their T rows into shared memory,
//   stage 2 loops over all n_out columns (the TPU's out grid becomes that
//   loop, spread over the block's threads). Nothing passes between blocks.
// - Stage 1: a warp per rank index k (k = warp, warp + 8, ...). Each lane
//   reads A[k, :] once for all ROWS rows, 4 consecutive elements of every
//   128 (a float4 when the rows are 16-byte aligned, else 4 scalar loads: the
//   same arithmetic either way), into 4 accumulators per row; the lanes'
//   partial sums meet in a fixed shuffle tree; T[row][k] = dot * s[k].
// - Stage 2: thread t owns columns j = t, t + 256, ...; for each column it
//   sums T[row][k] * B[k, j] over k in ascending order for its ROWS rows
//   (B read once per block, coalesced; T broadcast from shared memory).
// - Long ranks go through shared memory in chunks of KC = 4096 / ROWS rank
//   indices; the running sum of out[row, j] passes from one chunk to the next
//   through out itself, written and read back by the same thread, so the sum
//   is the same ascending sequence as in one chunk. Every rank launches with
//   16 KB of static shared memory.
// - The sums do not depend on r, ROWS or the chunking: stage 1 splits n_in
//   the same way for every r, stage 2 adds k in ascending order. Rank
//   padding with s = 0 rows adds exact zeros, so a padded rank bucket gives
//   the live rank's bits. No atomics: repeated calls give identical bits.
// - Ragged b, n_in and n_out are masked in the loops; nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kTile = 4 * kWarp;      // n_in elements per lane-sweep (4 per lane)
constexpr int kSmemFloats = 4096;     // T chunk: ROWS * KC floats, 16 KB

template <int ROWS, bool VEC4>
__global__ void __launch_bounds__(kThreads)
factor_matvec_kernel(const float* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ s, const float* __restrict__ b,
                     float* __restrict__ out, int64_t bt, int64_t n_in, int64_t r,
                     int64_t n_out) {
  constexpr int KC = kSmemFloats / ROWS;
  __shared__ float t_sh[ROWS][KC];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  const int nrows = static_cast<int>((bt - row0) < ROWS ? (bt - row0) : ROWS);

  for (int64_t k0 = 0; k0 < r; k0 += KC) {
    const int kc = static_cast<int>((r - k0) < KC ? (r - k0) : KC);
    // Stage 1: T[row][k - k0] = (X[row, :] . A[k, :]) * s[k].
    for (int kk = warp; kk < kc; kk += kWarps) {
      const float* arow = a + (k0 + kk) * n_in;
      float acc[ROWS][4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
      }
      for (int64_t c = 4 * lane; c < n_in; c += kTile) {
        float av[4];
        if constexpr (VEC4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(arow + c));
          av[0] = v.x; av[1] = v.y; av[2] = v.z; av[3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) av[q] = (c + q < n_in) ? __ldg(arow + c + q) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          if (i < nrows) {
            const float* xrow = x + (row0 + i) * n_in;
            float xv[4];
            if constexpr (VEC4) {
              const float4 v = __ldg(reinterpret_cast<const float4*>(xrow + c));
              xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) xv[q] = (c + q < n_in) ? __ldg(xrow + c + q) : 0.f;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(xv[q], av[q], acc[i][q]);
          }
        }
      }
      const float sk = __ldg(s + k0 + kk);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        float d = (acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3]);
#pragma unroll
        for (int o = kWarp / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (lane == 0) t_sh[i][kk] = __fmul_rn(d, sk);
      }
    }
    __syncthreads();
    // Stage 2: out[row, j] (+)= sum over this chunk's k, ascending, of T * B.
    for (int64_t j = threadIdx.x; j < n_out; j += kThreads) {
      float acc[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        acc[i] = (k0 == 0 || i >= nrows) ? 0.f : out[(row0 + i) * n_out + j];
      }
      const float* bcol = b + k0 * n_out + j;
      for (int kk = 0; kk < kc; ++kk) {
        const float bv = __ldg(bcol + static_cast<int64_t>(kk) * n_out);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i] = fmaf(t_sh[i][kk], bv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (i < nrows) out[(row0 + i) * n_out + j] = acc[i];
      }
    }
    __syncthreads();  // the next chunk overwrites t_sh
  }
}

template <int ROWS>
cudaError_t launch(const float* x, const float* a, const float* s, const float* b,
                   float* out, int64_t bt, int64_t n_in, int64_t r, int64_t n_out,
                   int vec4, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((bt + ROWS - 1) / ROWS));
  if (vec4) {
    factor_matvec_kernel<ROWS, true><<<grid, kThreads, 0, stream>>>(
        x, a, s, b, out, bt, n_in, r, n_out);
  } else {
    factor_matvec_kernel<ROWS, false><<<grid, kThreads, 0, stream>>>(
        x, a, s, b, out, bt, n_in, r, n_out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (bt, n_out) = ((x (bt, n_in) @ a (r, n_in)^T) * s (r,)) @ b (r, n_out).
// rows (1, 2, 4 or 8) is the batch rows per block; vec4 is 1 when n_in % 4
// == 0 and x and a start on 16-byte boundaries. Needs bt >= 1 and r >= 1.
int fm_factor_matvec_f32(const float* x, const float* a, const float* s, const float* b,
                         float* out, int64_t bt, int64_t n_in, int64_t r, int64_t n_out,
                         int rows, int vec4, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: err = launch<1>(x, a, s, b, out, bt, n_in, r, n_out, vec4, st); break;
    case 2: err = launch<2>(x, a, s, b, out, bt, n_in, r, n_out, vec4, st); break;
    case 4: err = launch<4>(x, a, s, b, out, bt, n_in, r, n_out, vec4, st); break;
    case 8: err = launch<8>(x, a, s, b, out, bt, n_in, r, n_out, vec4, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
