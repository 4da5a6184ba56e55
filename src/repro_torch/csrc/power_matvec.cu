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
//   independent f32 accumulators, a shuffle reduction. A lane issues its
//   loads in batches of kBatch = 8 vectors, all eight in flight before the
//   first multiply-add, those past the row's end predicated off: R's rows
//   of 250 float4 take one batch, X's of 512 two. (A loop over a runtime
//   trip count unrolled by four, the first design, leaves on R lanes 26-31
//   one step short of lanes 0-25, and they run the loop's remainder one load
//   at a time at the end of every row.) Nothing is padded or copied; each
//   lane adds its vectors in column order, so each row's sum runs in one
//   fixed order.
// - rmatvec: the TPU kernel carries the column sum across a sequential grid.
//   Hopper blocks run in no order, so the sum is split in two fixed-order
//   stages instead of float atomics: blocks of (32 x 8) threads own a column
//   tile and a slab of rows and write per-slab partial sums (slabs, m); a
//   second small kernel sums the slabs in a fixed order. Repeated calls on
//   the same inputs give identical bits.
// - A is streamed with evict-first loads (__ldcs): it is far larger than L2
//   and is not reused within a call; the vector stays in cache.
//
// Block forms, matmat (out = A V, (n, k)) and rmatmat (out = A^T U, (m, k)),
// for the block:k solver. The reference vmaps the TPU matvec/rmatvec over the
// k probe columns, so it reads A k times; these read A once per group of up
// to 32 columns (k > 32 goes in groups of 32, one pass over A each).
//
// Bound: at k = 32 both limits at once. On X (1,281,167 x 2048): 10.50 GB of
// A (3.13 ms at 3.35 TB/s) and 2 n m k = 168 GFLOP (2.51 ms at 67 TFLOP/s
// f32); on R 1.53 ms of bytes and 1.22 ms of flops. So every element read
// must feed k multiply-adds from registers.
//
// Design (both): a block of 128 threads owns a tile of 256 rows (matmat) or
// 256 columns of A (rmatmat) and up to 32 output columns; A comes through
// shared memory in stages of 32 (columns of a row for matmat, rows for
// rmatmat), the stage's 32 x k slab of V or U beside it. Each thread keeps
// an 8 x 8 tile of outputs in registers (4 x 8 and 2 x 8 for k <= 16 and
// <= 8), so per stage step it reads 8 values of A and 8 of V from shared
// memory for 64 multiply-adds. Each output is one fmaf chain in ascending
// index order: no atomics, the same bits on every call.
// - matmat: the A tile is row-major in shared memory with rows padded to 36
//   floats (16-byte stores, and the 8 rows a warp reads at once fall in 8
//   banks); a thread owns rows ty + 32 i and columns 8 tx .. 8 tx + 7.
// - rmatmat: two fixed-order stages, as rmatvec: blocks over (column tile,
//   slab of rows) write per-slab partials (slabs, m, kc), then one thread
//   per output sums its slabs in order. The slab (8192 rows by default) keeps
//   the partials at 20 MB on R and 41 MB on X at k = 32, against 164 MB at
//   rmatvec's 2048.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerMatvecBlock = 8;  // warps (rows) per matvec block
constexpr int kBatch = 8;               // vectors a lane loads before using them
constexpr int kRowLanes = 8;            // row lanes (threadIdx.y) in rmatvec

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float4 load_vec(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ float load_vec(const float* p) { return __ldcs(p); }
__device__ __forceinline__ void fma_vec(const float4& x, const float4& w, float (&acc)[4]) {
  acc[0] = fmaf(x.x, w.x, acc[0]);
  acc[1] = fmaf(x.y, w.y, acc[1]);
  acc[2] = fmaf(x.z, w.z, acc[2]);
  acc[3] = fmaf(x.w, w.w, acc[3]);
}
__device__ __forceinline__ void fma_vec(float x, float w, float (&acc)[4]) {
  acc[0] = fmaf(x, w, acc[0]);
}

// V is float4 (the aligned path) or float; a row holds m / (floats in V) of them.
template <typename V>
__global__ void __launch_bounds__(kWarp * kRowsPerMatvecBlock)
matvec_kernel(const float* __restrict__ a, const float* __restrict__ v,
              float* __restrict__ out, int64_t n, int64_t m) {
  constexpr int kVec = sizeof(V) / sizeof(float);
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerMatvecBlock + threadIdx.x / kWarp;
  if (row >= n) return;  // whole warp leaves together: row is per warp
  const V* arow = reinterpret_cast<const V*>(a + row * m);
  const V* vv = reinterpret_cast<const V*>(v);
  const int mv = static_cast<int>(m / kVec);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int base = lane; base < mv; base += kWarp * kBatch) {
    V x[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int j = base + kWarp * i;
      x[i] = j < mv ? load_vec(arow + j) : V{};
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int j = base + kWarp * i;
      if (j < mv) fma_vec(x[i], __ldg(vv + j), acc);
    }
  }
  const float sum = warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (lane == 0) out[row] = sum;
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

// ---------------------------------------------------------------------------
// Block forms: matmat and rmatmat
// ---------------------------------------------------------------------------

constexpr int kMMThreads = 128;
constexpr int kMMStage = 32;  // A columns (matmat) or rows (rmatmat) per stage
constexpr int kMMTile = 256;  // A rows (matmat) or columns (rmatmat) per block
constexpr int kMMGroup = 32;  // output columns per pass over A

// The thread tile for a group of KT (4, 8, 16 or 32) output columns: TCOL
// threads across the columns, TN each; TROW threads down the 256 rows, TM each.
template <int KT>
struct MMShape {
  static constexpr int TN = KT >= 8 ? 8 : KT;
  static constexpr int TCOL = KT / TN;
  static constexpr int TROW = kMMThreads / TCOL;
  static constexpr int TM = kMMTile / TROW;
};

template <int TN>
__device__ __forceinline__ void load_row(const float* p, float (&b)[TN]) {
#pragma unroll
  for (int j = 0; j < TN; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + j);
    b[j] = q.x;
    b[j + 1] = q.y;
    b[j + 2] = q.z;
    b[j + 3] = q.w;
  }
}

// out[r, col0 + c] = sum_j a[r, j] v[j, col0 + c] for c < kc; v is (m, k) and
// out (n, k), both row-major.
template <int KT, bool VEC4>
__global__ void __launch_bounds__(kMMThreads)
matmat_kernel(const float* __restrict__ a, const float* __restrict__ v,
              float* __restrict__ out, int64_t n, int64_t m, int64_t k, int col0, int kc) {
  using S = MMShape<KT>;
  __shared__ __align__(16) float as[kMMTile][kMMStage + 4];
  __shared__ __align__(16) float vs[kMMStage][KT];
  const int tid = threadIdx.x;
  const int tx = tid % S::TCOL, ty = tid / S::TCOL;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kMMTile;
  float acc[S::TM][S::TN];
#pragma unroll
  for (int i = 0; i < S::TM; ++i)
#pragma unroll
    for (int j = 0; j < S::TN; ++j) acc[i][j] = 0.f;
  for (int64_t j0 = 0; j0 < m; j0 += kMMStage) {
    if constexpr (VEC4) {
      for (int i = tid; i < kMMTile * kMMStage / 4; i += kMMThreads) {
        const int r = i / (kMMStage / 4), c = 4 * (i % (kMMStage / 4));
        const int64_t gr = row0 + r, gc = j0 + c;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < n && gc < m) x = __ldcs(reinterpret_cast<const float4*>(a + gr * m + gc));
        *reinterpret_cast<float4*>(&as[r][c]) = x;
      }
    } else {
      for (int i = tid; i < kMMTile * kMMStage; i += kMMThreads) {
        const int r = i / kMMStage, c = i % kMMStage;
        const int64_t gr = row0 + r, gc = j0 + c;
        as[r][c] = (gr < n && gc < m) ? __ldcs(a + gr * m + gc) : 0.f;
      }
    }
    for (int i = tid; i < kMMStage * KT; i += kMMThreads) {
      const int jj = i / KT, c = i % KT;
      const int64_t gj = j0 + jj;
      vs[jj][c] = (gj < m && c < kc) ? __ldg(v + gj * k + col0 + c) : 0.f;
    }
    __syncthreads();
    const int steps = static_cast<int>(m - j0 < kMMStage ? m - j0 : kMMStage);
#pragma unroll 4
    for (int kk = 0; kk < steps; ++kk) {
      float b[S::TN];
      load_row<S::TN>(&vs[kk][tx * S::TN], b);
#pragma unroll
      for (int i = 0; i < S::TM; ++i) {
        const float x = as[ty + i * S::TROW][kk];
#pragma unroll
        for (int j = 0; j < S::TN; ++j) acc[i][j] = fmaf(x, b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int64_t r = row0 + ty + i * S::TROW;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < S::TN; ++j) {
      const int c = tx * S::TN + j;
      if (c < kc) out[r * k + col0 + c] = acc[i][j];
    }
  }
}

// Stage 1 of rmatmat: partial[slab, col, c] = sum over the slab's rows r of
// a[r, col] u[r, col0 + c], c < kc; u is (n, k), partial (slabs, m, kc).
template <int KT, bool VEC4>
__global__ void __launch_bounds__(kMMThreads)
rmatmat_partial_kernel(const float* __restrict__ a, const float* __restrict__ u,
                       float* __restrict__ partial, int64_t n, int64_t m, int64_t k, int col0,
                       int kc, int64_t rows_per_slab) {
  using S = MMShape<KT>;
  __shared__ __align__(16) float as[kMMStage][kMMTile];
  __shared__ __align__(16) float us[kMMStage][KT];
  const int tid = threadIdx.x;
  const int tx = tid % S::TCOL, ty = tid / S::TCOL;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kMMTile;
  const int64_t slab = blockIdx.y;
  const int64_t r0 = slab * rows_per_slab;
  const int64_t r1 = (r0 + rows_per_slab < n) ? r0 + rows_per_slab : n;
  float acc[S::TM][S::TN];
#pragma unroll
  for (int i = 0; i < S::TM; ++i)
#pragma unroll
    for (int j = 0; j < S::TN; ++j) acc[i][j] = 0.f;
  for (int64_t s0 = r0; s0 < r1; s0 += kMMStage) {
    if constexpr (VEC4) {
      for (int i = tid; i < kMMStage * kMMTile / 4; i += kMMThreads) {
        const int rr = i / (kMMTile / 4), c = 4 * (i % (kMMTile / 4));
        const int64_t gr = s0 + rr, gc = c0 + c;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < r1 && gc < m) x = __ldcs(reinterpret_cast<const float4*>(a + gr * m + gc));
        *reinterpret_cast<float4*>(&as[rr][c]) = x;
      }
    } else {
      for (int i = tid; i < kMMStage * kMMTile; i += kMMThreads) {
        const int rr = i / kMMTile, c = i % kMMTile;
        const int64_t gr = s0 + rr, gc = c0 + c;
        as[rr][c] = (gr < r1 && gc < m) ? __ldcs(a + gr * m + gc) : 0.f;
      }
    }
    for (int i = tid; i < kMMStage * KT; i += kMMThreads) {
      const int rr = i / KT, c = i % KT;
      const int64_t gr = s0 + rr;
      us[rr][c] = (gr < r1 && c < kc) ? __ldg(u + gr * k + col0 + c) : 0.f;
    }
    __syncthreads();
    const int steps = static_cast<int>(r1 - s0 < kMMStage ? r1 - s0 : kMMStage);
#pragma unroll 4
    for (int kk = 0; kk < steps; ++kk) {
      float b[S::TN];
      load_row<S::TN>(&us[kk][tx * S::TN], b);
#pragma unroll
      for (int i = 0; i < S::TM; ++i) {
        const float x = as[kk][ty + i * S::TROW];
#pragma unroll
        for (int j = 0; j < S::TN; ++j) acc[i][j] = fmaf(x, b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int64_t col = c0 + ty + i * S::TROW;
    if (col >= m) continue;
#pragma unroll
    for (int j = 0; j < S::TN; ++j) {
      const int c = tx * S::TN + j;
      if (c < kc) partial[(slab * m + col) * kc + c] = acc[i][j];
    }
  }
}

// Stage 2: out[col, col0 + c] = sum over slabs of partial[slab, col, c], in order.
__global__ void __launch_bounds__(256)
rmatmat_finish_kernel(const float* __restrict__ partial, float* __restrict__ out, int64_t slabs,
                      int64_t m, int64_t k, int col0, int kc) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= m * kc) return;
  const int64_t col = i / kc;
  const int c = static_cast<int>(i % kc);
  float acc = 0.f;
  for (int64_t s = 0; s < slabs; ++s) acc += partial[s * m * kc + i];
  out[col * k + col0 + c] = acc;
}

// The narrowest instantiated group width that holds kc columns.
inline int group_width(int kc) { return kc <= 4 ? 4 : kc <= 8 ? 8 : kc <= 16 ? 16 : 32; }

template <bool VEC4>
void launch_matmat(const float* a, const float* v, float* out, int64_t n, int64_t m, int64_t k,
                   int col0, int kc, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n + kMMTile - 1) / kMMTile));
  switch (group_width(kc)) {
    case 4: matmat_kernel<4, VEC4><<<grid, kMMThreads, 0, s>>>(a, v, out, n, m, k, col0, kc); break;
    case 8: matmat_kernel<8, VEC4><<<grid, kMMThreads, 0, s>>>(a, v, out, n, m, k, col0, kc); break;
    case 16: matmat_kernel<16, VEC4><<<grid, kMMThreads, 0, s>>>(a, v, out, n, m, k, col0, kc); break;
    default: matmat_kernel<32, VEC4><<<grid, kMMThreads, 0, s>>>(a, v, out, n, m, k, col0, kc); break;
  }
}

template <bool VEC4>
void launch_rmatmat_partial(const float* a, const float* u, float* partial, int64_t n, int64_t m,
                            int64_t k, int col0, int kc, int64_t rows_per_slab, int64_t slabs,
                            cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((m + kMMTile - 1) / kMMTile), static_cast<unsigned>(slabs));
  switch (group_width(kc)) {
    case 4: rmatmat_partial_kernel<4, VEC4><<<grid, kMMThreads, 0, s>>>(a, u, partial, n, m, k, col0, kc, rows_per_slab); break;
    case 8: rmatmat_partial_kernel<8, VEC4><<<grid, kMMThreads, 0, s>>>(a, u, partial, n, m, k, col0, kc, rows_per_slab); break;
    case 16: rmatmat_partial_kernel<16, VEC4><<<grid, kMMThreads, 0, s>>>(a, u, partial, n, m, k, col0, kc, rows_per_slab); break;
    default: rmatmat_partial_kernel<32, VEC4><<<grid, kMMThreads, 0, s>>>(a, u, partial, n, m, k, col0, kc, rows_per_slab); break;
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
  if (m > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);  // int column index
  const dim3 block(kWarp * kRowsPerMatvecBlock);
  const dim3 grid(static_cast<unsigned>((n + kRowsPerMatvecBlock - 1) / kRowsPerMatvecBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    matvec_kernel<float4><<<grid, block, 0, s>>>(a, v, out, n, m);
  } else {
    matvec_kernel<float><<<grid, block, 0, s>>>(a, v, out, n, m);
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

// out (n, k) = A (n, m) @ V (m, k), in groups of 32 columns (one pass over A
// each). vec is 4 (rows of A 16-byte aligned, m % 4 == 0) or 1.
int pm_matmat_f32(const float* a, const float* v, float* out, int64_t n, int64_t m, int64_t k,
                  int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n / kMMTile >= INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int64_t col0 = 0; col0 < k; col0 += kMMGroup) {
    const int kc = static_cast<int>(k - col0 < kMMGroup ? k - col0 : kMMGroup);
    if (vec == 4) {
      launch_matmat<true>(a, v, out, n, m, k, static_cast<int>(col0), kc, s);
    } else {
      launch_matmat<false>(a, v, out, n, m, k, static_cast<int>(col0), kc, s);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// out (m, k) = A (n, m)^T @ U (n, k) through partial (ceil(n / rows_per_slab),
// m, min(k, 32)), in groups of 32 columns.
int pm_rmatmat_f32(const float* a, const float* u, float* partial, float* out, int64_t n,
                   int64_t m, int64_t k, int64_t rows_per_slab, int vec, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t slabs = (n + rows_per_slab - 1) / rows_per_slab;
  if (slabs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int64_t col0 = 0; col0 < k; col0 += kMMGroup) {
    const int kc = static_cast<int>(k - col0 < kMMGroup ? k - col0 : kMMGroup);
    if (vec == 4) {
      launch_rmatmat_partial<true>(a, u, partial, n, m, k, static_cast<int>(col0), kc,
                                   rows_per_slab, slabs, s);
    } else {
      launch_rmatmat_partial<false>(a, u, partial, n, m, k, static_cast<int>(col0), kc,
                                    rows_per_slab, slabs, s);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rmatmat_finish_kernel<<<static_cast<unsigned>((m * kc + 255) / 256), 256, 0, s>>>(
        partial, out, slabs, m, k, static_cast<int>(col0), kc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
