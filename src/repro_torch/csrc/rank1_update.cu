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
// Design: a block of 256 threads owns a strip of 128 columns and a short
// range of rows (rankk_block_rows: 64 at k <= 8, 256 at k = 32), the strips
// of a range launched side by side so that they read its P rows from L2
// about together. Q's strip is staged once a block by cp.async, a column's k
// values in a row padded to an odd number of 16-byte chunks (so the lanes'
// float4 reads of 4 values of j fall in other banks). A lane owns 4 adjacent
// columns, so a warp covers the strip's row in 16-byte accesses (float4 when
// m % 4 == 0 and Z, Y0 and out are 16-byte aligned; else 4 columns 32 apart,
// 4 bytes each). A warp takes 4 rows a step through a two-stage ring in
// shared memory: cp.async brings the next step's rows of Z (and Y0) and
// their P rows while the warp forms this step's 16 dots (P as float4
// broadcasts, one float4 of Q for 16 multiply-adds), then writes a*z + b*dot
// (+ c*y0) with __stcs. k > 64 reads P, k > 128 also Q, from global memory.
// The blocks are short-lived on purpose: a persistent grid (the card's
// resident blocks walking all the rows, as ranges, as steps in turn, or
// taking units from a counter) streamed about a tenth slower on the H100,
// and so did the rank-1 kernel made persistent (tools/torch_rankk_bench.py
// --edit variants). Each dot is one fmaf chain in ascending j from 0,
// combined with round-to-nearest intrinsics in the plain version's order, so
// a launch's bits do not depend on the launch plan. Each element is read (a
// step ahead, into the ring) and then written by one lane, so out may be z.
// No atomics: a run repeats its bits.
//
// bf16 form (the hybrid optimizer's head update at full width):
//   rank1_update_bf16  Z' = a*Z + b*x y^T, Z and Z' bf16, x, y, a, b f32
// The reference's kernel takes Z of any dtype and writes z.dtype: a*z
// promotes a bf16 z to f32 and the outer product is f32, so it computes in
// f32 and rounds once to bf16. This kernel does the same, in the plain
// version's order: z widened exactly, a*z + b*(x*y) with round-to-nearest
// intrinsics (nothing contracted), rounded to nearest even.
// Bound: bytes, one HBM pass, 2 bytes read and 2 written an element: at
// 4096 x 92,416 (codeqwen1.5-7b's head) that is 1.514 GB.
// Design: rank1_kernel's, with 16-byte accesses of 8 bf16 when m % 8 == 0
// and Z, out 16-byte aligned (else one element a thread). Each element is
// read and then written by one thread, so out may be z.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_async.cuh"

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

__device__ __forceinline__ __nv_bfloat16 combine_bf16(float a, __nv_bfloat16 z, float b,
                                                       float xr, float yj) {
  return __float2bfloat16_rn(combine(a, __bfloat162float(z), b, xr, yj, 0.f, 0.f, false));
}

// Two packed bf16 (low half first) through combine_bf16.
__device__ __forceinline__ uint32_t combine_pair(float a, uint32_t zz, float b, float xr,
                                                 float y_lo, float y_hi) {
  const __nv_bfloat16 lo = combine_bf16(a, __ushort_as_bfloat16(static_cast<uint16_t>(zz)), b,
                                        xr, y_lo);
  const __nv_bfloat16 hi = combine_bf16(
      a, __ushort_as_bfloat16(static_cast<uint16_t>(zz >> 16)), b, xr, y_hi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
rank1_bf16_kernel(__nv_bfloat16* out, const __nv_bfloat16* z, const float* __restrict__ x,
                  const float* __restrict__ y, const float* __restrict__ scal, int64_t n,
                  int64_t m) {
  const float a = scal[0];
  const float b = scal[1];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int64_t row1 = (row0 + kRowsPerBlock < n) ? row0 + kRowsPerBlock : n;
  for (int64_t r = row0; r < row1; ++r) {
    const float xr = __ldg(x + r);
    const int64_t base = r * m;
    if constexpr (VEC == 8) {
      const int64_t m8 = m / 8;
      for (int64_t j = threadIdx.x; j < m8; j += kThreads) {
        const uint4 zz = reinterpret_cast<const uint4*>(z + base)[j];
        const float4 y0 = __ldg(reinterpret_cast<const float4*>(y) + 2 * j);
        const float4 y1 = __ldg(reinterpret_cast<const float4*>(y) + 2 * j + 1);
        uint4 o;
        o.x = combine_pair(a, zz.x, b, xr, y0.x, y0.y);
        o.y = combine_pair(a, zz.y, b, xr, y0.z, y0.w);
        o.z = combine_pair(a, zz.z, b, xr, y1.x, y1.y);
        o.w = combine_pair(a, zz.w, b, xr, y1.z, y1.w);
        reinterpret_cast<uint4*>(out + base)[j] = o;
      }
    } else {
      for (int64_t j = threadIdx.x; j < m; j += kThreads) {
        out[base + j] = combine_bf16(a, z[base + j], b, xr, __ldg(y + j));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Rank-k forms
// ---------------------------------------------------------------------------

constexpr int kRKStrip = 128;      // columns of Z a block owns: 32 lanes x 4
constexpr int kRKThreads = 256;
constexpr int kRKWarps = kRKThreads / 32;
constexpr int kRKRowsPerWarp = 4;  // rows a warp updates in one step
constexpr int kRKRowsPerStep = kRKRowsPerWarp * kRKWarps;
constexpr int kRKStages = 2;       // a warp's ring: steps in flight while one is formed
constexpr int kRKQMax = 128;       // widest k whose Q strip sits in shared memory
constexpr int kRKRingP = 64;       // widest k whose P rows go through the ring
constexpr int kRKMinBlocks = 3;    // resident blocks an SM the register budget allows

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Floats of a staged Q column: k rounded up to a whole number of 16-byte
// chunks, and to an odd one, so that the lanes' 16-byte reads of a column
// each fall in other banks (0 when Q is read from global memory).
__host__ __device__ inline int q_row(int64_t k) {
  if (k > kRKQMax) return 0;
  const int chunks = static_cast<int>((k + 3) / 4);
  return 4 * (chunks | 1);
}

// Floats of one P row in a ring stage (0: P is read from global memory).
__host__ __device__ inline int ring_p(int64_t k) {
  return k <= kRKRingP ? static_cast<int>((k + 3) / 4 * 4) : 0;
}

// Floats of one ring stage: the step's rows of Z (and Y0) in the strip, then
// their P rows.
__host__ __device__ inline int stage_floats(bool axpy, int kr) {
  return kRKRowsPerWarp * (kRKStrip * (axpy ? 2 : 1) + kr);
}

// Shared memory: Q's strip (one row of q_row(k) floats a column), then each
// warp's ring of kRKStages stages.
inline size_t rankk_smem(bool axpy, int64_t k) {
  return sizeof(float) * (kRKStrip * q_row(k) + static_cast<int64_t>(kRKWarps) * kRKStages *
                          stage_floats(axpy, ring_p(k)));
}

// Rows a block updates: enough steps that staging Q's strip (512 k bytes) is
// small beside the block's stream, few enough that blocks come and go (a
// persistent grid walking Z streamed about a tenth slower on the H100).
inline int64_t rankk_block_rows(int64_t n, int64_t k) {
  int64_t steps = k / 4 < 2 ? 2 : (k / 4 > 16 ? 16 : k / 4);
  const int64_t least = (n + 65534) / 65535;  // the grid's rows of blocks stay <= 65535
  if (steps * kRKRowsPerStep < least) steps = (least + kRKRowsPerStep - 1) / kRKRowsPerStep;
  return steps * kRKRowsPerStep;
}

// VEC 4: a thread's four columns are adjacent and Z, Y0 and out move 16
// bytes at a time (m % 4 == 0, 16-byte aligned); VEC 1: they are 32 apart,
// 4 bytes each. PV 4: P moves 16 bytes at a time (k % 4 == 0, aligned).
template <int VEC, int PV, bool AXPY>
__global__ void __launch_bounds__(kRKThreads, kRKMinBlocks)
rankk_kernel(float* out, const float* z, const float* __restrict__ y0,
             const float* __restrict__ p, const float* __restrict__ q,
             const float* __restrict__ scal, int64_t n, int64_t m, int k,
             int64_t block_rows, int q_vec) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const float a = scal[0];
  const float b = scal[1];
  const float c = AXPY ? scal[2] : 0.f;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int kq = q_row(k);
  const int kr = ring_p(k);
  const int sf = stage_floats(AXPY, kr);
  float* ring = qs + kRKStrip * kq + warp * kRKStages * sf;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kRKStrip;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * block_rows;
  const int64_t row1 = (row0 + block_rows < n) ? row0 + block_rows : n;
  const int64_t nsteps = (row1 - row0 + kRKRowsPerStep - 1) / kRKRowsPerStep;
  constexpr int zrows = kRKRowsPerWarp * kRKStrip;  // floats of a stage's Z rows
  int col[4], qrow[4];
  bool cok[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    col[t] = VEC == 4 ? 4 * lane + t : lane + 32 * t;
    cok[t] = c0 + col[t] < m;
    // Q's row of column col[t]: the lanes' columns of one t in consecutive rows
    qrow[t] = VEC == 4 ? 32 * t + lane : col[t];
  }
  // Q's strip, 16 (or 4) bytes a copy, in the first cp.async group
  if (kq > 0) {
    const int per_col = q_vec ? k / 4 : k;
    for (int i = threadIdx.x; i < kRKStrip * per_col; i += kRKThreads) {
      const int cc = i / per_col, j = (i % per_col) * (q_vec ? 4 : 1);
      const int r = VEC == 4 ? 32 * (cc % 4) + cc / 4 : cc;
      const bool v = c0 + cc < m;
      const float* src = v ? q + (c0 + cc) * k + j : q;
      if (q_vec)
        cp_async16(qs + r * kq + j, src, v);
      else
        cp_async4(qs + r * kq + j, src, v);
    }
  }
  // cp.async of step s's rows (Z, Y0, P; zeros past the block's rows)
  auto issue = [&](int64_t s) {
    float* st = ring + (s % kRKStages) * sf;
    const int64_t rb = row0 + s * kRKRowsPerStep + warp * kRKRowsPerWarp;
#pragma unroll
    for (int u = 0; u < kRKRowsPerWarp; ++u) {
      const bool ok = s < nsteps && rb + u < row1;
      const int64_t e = (rb + u) * m + c0;
      if constexpr (VEC == 4) {
        const bool v = ok && cok[0];
        cp_async16(st + u * kRKStrip + 4 * lane, v ? z + e + 4 * lane : z, v);
        if constexpr (AXPY)
          cp_async16(st + zrows + u * kRKStrip + 4 * lane, v ? y0 + e + 4 * lane : y0, v);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const bool v = ok && cok[t];
          cp_async4(st + u * kRKStrip + col[t], v ? z + e + col[t] : z, v);
          if constexpr (AXPY)
            cp_async4(st + zrows + u * kRKStrip + col[t], v ? y0 + e + col[t] : y0, v);
        }
      }
    }
    if (kr > 0) {
      float* ps = st + zrows * (AXPY ? 2 : 1);
      constexpr int step = PV;  // floats a copy
      const int per_row = k / step;
      for (int i = lane; i < kRKRowsPerWarp * per_row; i += 32) {
        const int u = i / per_row, j = (i % per_row) * step;
        const bool v = s < nsteps && rb + u < row1;
        const float* src = v ? p + (rb + u) * k + j : p;
        if constexpr (PV == 4)
          cp_async16(ps + u * kr + j, src, v);
        else
          cp_async4(ps + u * kr + j, src, v);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kRKStages - 1; ++i) {
    issue(i);
    cp_async_commit();
  }
  for (int64_t s = 0; s < nsteps; ++s) {
    issue(s + kRKStages - 1);  // into the stage step s - 1 used
    cp_async_commit();
    cp_async_wait<kRKStages - 1>();  // step s's stage (and at s = 0 Q) has landed
    if (s == 0)
      __syncthreads();  // every thread's part of Q
    else
      __syncwarp();
    const float* st = ring + (s % kRKStages) * sf;
    const float* ps = st + zrows * (AXPY ? 2 : 1);
    const int64_t rb = row0 + s * kRKRowsPerStep + warp * kRKRowsPerWarp;
    bool rok[kRKRowsPerWarp];
    float dot[kRKRowsPerWarp][4];
#pragma unroll
    for (int u = 0; u < kRKRowsPerWarp; ++u) {
      rok[u] = rb + u < row1;
#pragma unroll
      for (int t = 0; t < 4; ++t) dot[u][t] = 0.f;
    }
    // a column's 4 values of Q at a time; each (row, column) chain still
    // runs over j in ascending order
    auto q4 = [&](int t, int j) -> float4 {
      if (kq > 0) return *reinterpret_cast<const float4*>(qs + qrow[t] * kq + j);
      const float* qc = q + (c0 + col[t]) * k + j;
      return cok[t] ? make_float4(__ldg(qc), __ldg(qc + 1), __ldg(qc + 2), __ldg(qc + 3))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    int j = 0;
    if constexpr (PV == 4) {
#pragma unroll 2
      for (; j + 4 <= k; j += 4) {
        float4 pv[kRKRowsPerWarp];
#pragma unroll
        for (int u = 0; u < kRKRowsPerWarp; ++u)
          pv[u] = kr > 0 ? *reinterpret_cast<const float4*>(ps + u * kr + j)
                  : rok[u] ? __ldg(reinterpret_cast<const float4*>(p + (rb + u) * k + j))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 qv = q4(t, j);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int u = 0; u < kRKRowsPerWarp; ++u)
              dot[u][t] = fmaf(part(pv[u], jj), part(qv, jj), dot[u][t]);
        }
      }
    }
    for (; j < k; ++j) {
      float pj[kRKRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kRKRowsPerWarp; ++u)
        pj[u] = kr > 0 ? ps[u * kr + j] : rok[u] ? __ldg(p + (rb + u) * k + j) : 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float qv = kq > 0 ? qs[qrow[t] * kq + j]
                         : cok[t] ? __ldg(q + (c0 + col[t]) * k + j) : 0.f;
#pragma unroll
        for (int u = 0; u < kRKRowsPerWarp; ++u) dot[u][t] = fmaf(pj[u], qv, dot[u][t]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRKRowsPerWarp; ++u) {
      if (!rok[u]) continue;
      const int64_t e = (rb + u) * m + c0;
      float zv[4], yv[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (VEC == 4) {
        const float4 v = *reinterpret_cast<const float4*>(st + u * kRKStrip + 4 * lane);
        zv[0] = v.x, zv[1] = v.y, zv[2] = v.z, zv[3] = v.w;
        if constexpr (AXPY) {
          const float4 w = *reinterpret_cast<const float4*>(st + zrows + u * kRKStrip + 4 * lane);
          yv[0] = w.x, yv[1] = w.y, yv[2] = w.z, yv[3] = w.w;
        }
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          zv[t] = st[u * kRKStrip + col[t]];
          if constexpr (AXPY) yv[t] = st[zrows + u * kRKStrip + col[t]];
        }
      }
      float o[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        o[t] = __fadd_rn(__fmul_rn(a, zv[t]), __fmul_rn(b, dot[u][t]));
        if (AXPY) o[t] = __fadd_rn(o[t], __fmul_rn(c, yv[t]));
      }
      if constexpr (VEC == 4) {
        if (cok[0])
          __stcs(reinterpret_cast<float4*>(out + e) + lane, make_float4(o[0], o[1], o[2], o[3]));
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (cok[t]) __stcs(out + e + col[t], o[t]);
      }
    }
    __syncwarp();  // every lane is done with the stage before it is refilled
  }
  cp_async_wait_all();
}

// The launch plan: a block a strip of 128 columns and rankk_block_rows rows,
// the strips of a range of rows launched side by side (they read its P rows
// from L2 about together), the ranges down Z in order.
template <int VEC, int PV, bool AXPY>
cudaError_t launch_k(float* out, const float* z, const float* y0, const float* p,
                     const float* q, const float* scal, int64_t n, int64_t m, int k,
                     int device, cudaStream_t s) {
  const auto kernel = rankk_kernel<VEC, PV, AXPY>;
  const int64_t strips = (m + kRKStrip - 1) / kRKStrip;
  const int64_t block_rows = rankk_block_rows(n, k);
  const int64_t ranges = (n + block_rows - 1) / block_rows;
  if (strips > 0x7fffffff || ranges > 65535) return cudaErrorInvalidValue;
  const size_t smem = rankk_smem(AXPY, k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int q_vec = k % 4 == 0 && aligned16(q);
  kernel<<<dim3(static_cast<unsigned>(strips), static_cast<unsigned>(ranges)), kRKThreads, smem,
           s>>>(out, z, y0, p, q, scal, n, m, k, block_rows, q_vec);
  return cudaGetLastError();
}

template <bool AXPY>
cudaError_t dispatch_k(bool vec, bool pvec, float* out, const float* z, const float* y0,
                       const float* p, const float* q, const float* scal, int64_t n,
                       int64_t m, int k, int device, cudaStream_t s) {
  if (vec)
    return pvec ? launch_k<4, 4, AXPY>(out, z, y0, p, q, scal, n, m, k, device, s)
                : launch_k<4, 1, AXPY>(out, z, y0, p, q, scal, n, m, k, device, s);
  return pvec ? launch_k<1, 4, AXPY>(out, z, y0, p, q, scal, n, m, k, device, s)
              : launch_k<1, 1, AXPY>(out, z, y0, p, q, scal, n, m, k, device, s);
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

// out (n, m) = a*z + b*x y^T for bf16 z and out (n, m) row-major, f32 x (n,),
// y (m,) and scal = [a, b] on the device; out may equal z. The 16-byte route
// takes m % 8 == 0 with z, out and y 16-byte aligned.
int r1_update_bf16(void* out, const void* z, const float* x, const float* y, const float* scal,
                   int64_t n, int64_t m, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock));
  auto* o = static_cast<__nv_bfloat16*>(out);
  const auto* zz = static_cast<const __nv_bfloat16*>(z);
  if (m % 8 == 0 && aligned16(out) && aligned16(z) && aligned16(y)) {
    rank1_bf16_kernel<8><<<grid, kThreads, 0, s>>>(o, zz, x, y, scal, n, m);
  } else {
    rank1_bf16_kernel<1><<<grid, kThreads, 0, s>>>(o, zz, x, y, scal, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (n, m) = a*z + b*p q^T [+ c*y0] for p (n, k), q (m, k); scal on the
// device as for r1_update_f32. out may equal z. k >= 1. The routes (16-byte
// or 4-byte Z, Y0 and out; 16-byte or 4-byte P) follow m, k and the pointers'
// alignment.
int rk_update_f32(float* out, const float* z, const float* y0, const float* p, const float* q,
                  const float* scal, int64_t n, int64_t m, int64_t k, int axpy, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = m % 4 == 0 && aligned16(out) && aligned16(z) && (!axpy || aligned16(y0));
  const bool pvec = k % 4 == 0 && aligned16(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  err = axpy ? dispatch_k<true>(vec, pvec, out, z, y0, p, q, scal, n, m, kk, device, s)
             : dispatch_k<false>(vec, pvec, out, z, y0, p, q, scal, n, m, kk, device, s);
  return static_cast<int>(err);
}

}  // extern "C"
