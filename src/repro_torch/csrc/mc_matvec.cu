// Observed-entry (COO) matvec of the matrix-completion gradient, f32, sm_90a:
//   out[seg_e] += vals_e * x[gat_e]
// G v takes seg = rows, gat = cols; G^T u swaps the roles.
//
// Replaces src/repro/kernels/mc_matvec/kernel.py: coo_matvec
// (_coo_matvec_kernel). The TPU kernel builds one-hot (block_e x dim)
// matrices and multiplies them on the MXU; at d = 480,189 that is a
// 512 x 480,189 matrix per entry block. Here it is a gather plus a segmented
// reduction.
//
// Bound: bytes. Each call must read, per observed entry, its gather index
// and its value (8 bytes; the segment of an entry is implied by a sorted
// order's offsets), plus the dense vectors once: at the Netflix shapes,
// p = 100,480,507 entries, 0.80 GB, about 0.24 ms at 3.35 TB/s. Two flops
// per entry are nothing next to that.
//
// Design:
// - No float atomics: repeated calls must give identical bits. The caller
//   builds, once per run, a stable segment-sorted order of the entries
//   (`perm`, with the gather index of each sorted entry in `gat`, since
//   indices never change during a run) and cuts every segment into pieces
//   of at most a fixed length (`piece_start`/`piece_end`, contiguous per
//   segment, `piece_ptr` per segment). Stage 1 gives each piece one warp:
//   lane j sums entries j, j + 32, ... in order, then a fixed shuffle tree
//   sums the lanes into `partial[piece]`. Stage 2 gives each segment one
//   thread that adds its pieces' partials in order (0 for an empty segment).
// - Skew: the busiest movie of the Netflix data has ~233 thousand ratings
//   against a mean of ~5,650; a warp per segment would leave that one warp
//   setting the kernel's time. Pieces bound every warp's work.
// - Values change every epoch, the order does not: `vals` (the residual)
//   stays in the caller's entry order and is read through `perm`. Keeping a
//   copy of it in each sorted order would need the same gather once per
//   epoch, 0.8 GB more memory and a second copy of the state to keep in step
//   with the first; this first kernel pays the gather on every call instead
//   (a random 4-byte read per entry), which is what keeps it off the bound.
// - The product is rounded before the sum (no FMA contraction), as in the
//   plain version, so a one-entry segment gives the plain version's bits.
// - Zero-weight padding entries carry vals = 0 and contribute exactly 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void __launch_bounds__(kThreads)
piece_sum_kernel(const int32_t* __restrict__ perm, const int32_t* __restrict__ gat,
                 const float* __restrict__ vals, const float* __restrict__ x,
                 const int64_t* __restrict__ piece_start, const int64_t* __restrict__ piece_end,
                 float* __restrict__ partial, int64_t num_pieces) {
  const int lane = threadIdx.x % kWarp;
  const int64_t piece =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (piece >= num_pieces) return;  // whole warp leaves together
  const int64_t end = piece_end[piece];
  float acc = 0.f;
#pragma unroll 4
  for (int64_t k = piece_start[piece] + lane; k < end; k += kWarp) {
    const float v = __ldg(vals + __ldcs(perm + k));
    const float g = __ldg(x + __ldcs(gat + k));
    acc = __fadd_rn(acc, __fmul_rn(v, g));
  }
  acc = warp_sum(acc);
  if (lane == 0) partial[piece] = acc;
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ partial, const int64_t* __restrict__ piece_ptr,
                   float* __restrict__ out, int64_t out_dim) {
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (seg >= out_dim) return;
  const int64_t end = piece_ptr[seg + 1];
  float acc = 0.f;
  for (int64_t j = piece_ptr[seg]; j < end; ++j) acc = __fadd_rn(acc, partial[j]);
  out[seg] = acc;
}

}  // namespace

extern "C" {

const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (out_dim,) = segmented sum over the sorted order; partial is
// (num_pieces,) scratch. num_pieces may be 0 (every segment empty).
int mc_coo_matvec_f32(const int32_t* perm, const int32_t* gat, const float* vals,
                      const float* x, const int64_t* piece_start, const int64_t* piece_end,
                      const int64_t* piece_ptr, float* partial, float* out,
                      int64_t num_pieces, int64_t out_dim, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_pieces > 0) {
    const int64_t blocks = (num_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
    piece_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        perm, gat, vals, x, piece_start, piece_end, partial, num_pieces);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (out_dim + kThreads - 1) / kThreads;
  segment_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      partial, piece_ptr, out, out_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
