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
// - Values are read in the order's own sorted order: the caller keeps a
//   copy of the values per order (the matrix-completion state keeps one of
//   its residual for the row order and one for the column order), so stage 1
//   reads the value and the gather index of each entry sequentially, the 8
//   bytes the bound counts, and gathers only x (G v: 71 KB of v; G^T u: 1.9
//   MB of u, both from L2). The residual changes once per epoch and each
//   call of an epoch's 2K reads it, so the copies are refreshed by one
//   gather per order per epoch (gather_sorted_kernel: vals_sorted[k] =
//   vals[perm[k]], a random 4-byte read per entry; its bound is perm read,
//   values read and written once, 1.2 GB, 0.36 ms) instead of a random read
//   through `perm` on every call, which kept the first version of this
//   kernel at 7% of its bound.
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
piece_sum_kernel(const int32_t* __restrict__ gat, const float* __restrict__ vals,
                 const float* __restrict__ x, const int64_t* __restrict__ piece_start,
                 const int64_t* __restrict__ piece_end,
                 float* __restrict__ partial, int64_t num_pieces) {
  const int lane = threadIdx.x % kWarp;
  const int64_t piece =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (piece >= num_pieces) return;  // whole warp leaves together
  const int64_t end = piece_end[piece];
  float acc = 0.f;
#pragma unroll 4
  for (int64_t k = piece_start[piece] + lane; k < end; k += kWarp) {
    const float v = __ldcs(vals + k);
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

// dst[k] = src[perm[k]], four entries a thread (16-byte loads of perm and
// stores of dst where `vec`).
__global__ void __launch_bounds__(kThreads)
gather_sorted_kernel(const int32_t* __restrict__ perm, const float* __restrict__ src,
                     float* __restrict__ dst, int64_t n, int vec) {
  const int64_t k = 4 * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (k >= n) return;
  if (vec && k + 4 <= n) {
    const int4 idx = __ldcs(reinterpret_cast<const int4*>(perm + k));
    const float4 val = make_float4(__ldg(src + idx.x), __ldg(src + idx.y), __ldg(src + idx.z),
                                   __ldg(src + idx.w));
    __stcs(reinterpret_cast<float4*>(dst + k), val);
  } else {
    for (int64_t j = k; j < n && j < k + 4; ++j) dst[j] = __ldg(src + __ldcs(perm + j));
  }
}

}  // namespace

extern "C" {

const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (out_dim,) = segmented sum over the sorted order, vals and gat in that
// order; partial is (num_pieces,) scratch. num_pieces may be 0 (every segment
// empty).
int mc_coo_matvec_f32(const int32_t* gat, const float* vals, const float* x,
                      const int64_t* piece_start, const int64_t* piece_end,
                      const int64_t* piece_ptr, float* partial, float* out,
                      int64_t num_pieces, int64_t out_dim, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_pieces > 0) {
    const int64_t blocks = (num_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
    piece_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        gat, vals, x, piece_start, piece_end, partial, num_pieces);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (out_dim + kThreads - 1) / kThreads;
  segment_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      partial, piece_ptr, out, out_dim);
  return static_cast<int>(cudaGetLastError());
}

// dst (n,) = src[perm] (n >= 1).
int mc_gather_sorted_f32(const int32_t* perm, const float* src, float* dst, int64_t n,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = reinterpret_cast<uintptr_t>(perm) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const int64_t blocks = (n + 4 * kThreads - 1) / (4 * kThreads);
  gather_sorted_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(perm, src, dst, n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
