// One RWKV-6 (WKV6) chunk, sm_90a: for every (batch, head) and a chunk of q
// tokens,
//     y (q, dv)       = inter-chunk + intra-chunk + diagonal bonus terms,
//     S_out (dk, dv)  = decayed S_in + the chunk's decayed k (x) v,
// from r, k, logw (q, dk), v (q, dv), the bonus u (dk) of the head and
// S_in (dk, dv). r, k and v are bf16 or f32 (one dtype), logw bf16 or f32,
// u and S_in f32; y and S_out are f32.
//
// Replaces src/repro/kernels/wkv6_chunk/kernel.py: wkv6_chunk (_wkv6_kernel).
// It computes the TPU kernel's chunk form in f32, with its five clamps:
//     cw = inclusive prefix sum of logw over the chunk, pw = cw - logw
//     y  = (r * exp(clip(pw, -80, 0))) @ S_in
//        + tril_{s<t}[(r * exp(clip(pw, -80, 0))) (k * exp(clip(-cw, -80, 80)))^T] @ v
//        + (sum_k r * u * k) * v
//     S_out = S_in * exp(clip(cw_last, -80, 0))[:, None]
//           + (k * exp(clip(cw_last - cw, -80, 0)))^T @ v
// Once a channel's cumulative log decay passes -80 inside the chunk, both
// factors of a pair's weight saturate and the weight is 1, not
// exp(pw_t - cw_s): that is the TPU kernel's (and the model's) function, and
// this kernel reproduces it (ROADMAP, reference caveat (e)).
//
// Bound: at the main path's shape (B = 4, H = 64, q = 256, dk = dv = 64, r/k/v
// bf16, logw f32) one call does about 3.2e9 flop (the strictly lower
// triangle of R K^T and of A V, q^2/2 * 64 * 2 each, plus q * 64 * 64 * 2 for
// the inter-chunk product and for the state, per head) and moves about 67 MB
// (inputs read once, y and S_out written once): 48 us at the 67 TFLOP/s f32
// CUDA-core peak, 20 us at 3.35 TB/s. It is bound by operations. The
// operands are cast to f32 before every product, as in the TPU kernel, and
// the exp-scaled factors reach e^+-80, which bf16 cannot hold, so the first
// version runs f32 FMAs on the CUDA cores; 3xTF32 tensor-core products,
// wgmma and TMA staging are later work.
//
// Design:
// - The TPU kernel holds the whole chunk (q x q scores) in VMEM; at q = 256
//   the f32 score matrix alone is 256 KB, more than a block's 227 KB of
//   shared memory. So the query rows are tiled: grid (B * H, q / 64 + 1).
//   Block y > 0 owns one 64-row tile of y and loops over the 64-key tiles at
//   or below the diagonal (tiles above it are skipped; the diagonal tile is
//   masked s < t); block y = 0 computes S_out, a 64 x 64 reduction over the
//   whole chunk. The state block and the last (heaviest) row tiles go first.
// - cw is an inclusive prefix sum per channel; it runs to about -110 at
//   q = 256, where one f32 ulp is 7.6e-6, and the clamped factors turn an
//   error in it into the same relative error of a pair's weight. So it is
//   summed in f64 and rounded to f32 once per row (a sequential f32 sum is
//   off by up to ten ulps there). Every block recomputes it from row 0 in
//   one fixed order (one thread per channel adds the rows in turn), so every
//   block, and every call, gets the same bits for the same row.
//   pw = cw - logw in f32, as in the TPU kernel (not cw of the previous row).
// - Products are taken as the TPU kernel's dots are, each summed on its own
//   and then added: y = (inter + intra) + bonus, S_out = decayed S_in + sum.
// - r, k, v, logw and y are read and written through their (batch, head,
//   token) strides, so the (B, S, H, 64) projections of the model go in at a
//   chunk offset without a copy, and y lands in the model's (B, S, H, 64)
//   buffer; the last dimension must be contiguous. u is (H, dk), broadcast
//   over the batch. S_in and S_out are contiguous (B, H, dk, dv).
// - 256 threads; thread (ty, tx) owns rows ty + 16 r and columns tx + 16 c
//   (r, c < 4) of each 64 x 64 product. Shared tiles are f32 with rows of
//   65 floats, so the column walks of a warp fall on distinct banks. 66 KB of
//   dynamic shared memory a block. dk and dv up to 64: tiles are zero-filled
//   past q, dk and dv (a zero row or channel adds nothing).
// - No atomics: repeated calls give identical bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;       // tokens per tile
constexpr int kD = 64;       // compiled head dim (dk, dv <= kD)
constexpr int kLd = kD + 1;  // shared row stride in floats
constexpr int kTile = kT * kLd;
constexpr float kClamp = 80.f;
constexpr int kSmemBytes = (4 * kTile + 3 * kD) * static_cast<int>(sizeof(float));

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

struct Strides {  // elements: (batch, head, token) of r, k, v, logw and y
  int64_t r[3], k[3], v[3], w[3], y[3];
};

// dst[row][col] = src[t0 + row, col] for t0 + row < q and col < d, else 0.
template <typename T>
__device__ void load_tile(float* dst, const T* src, int64_t st, int t0, int q, int d) {
  for (int i = threadIdx.x; i < kT * kD; i += kThreads) {
    const int row = i / kD, col = i % kD;
    const int t = t0 + row;
    dst[row * kLd + col] = (t < q && col < d) ? to_f32(src[t * st + col]) : 0.f;
  }
}

// In place, lw -> cw for the tile's `rows` real rows: thread c < kD adds
// channel c's rows in order onto its running f64 carry (the prefix sum of
// all rows before the tile). One fixed order in every block.
__device__ __forceinline__ void tile_cumsum(float* s, double& carry, int rows) {
  if (threadIdx.x < kD) {
    const int c = threadIdx.x;
    double acc = carry;
    for (int row = 0; row < rows; ++row) {
      acc += static_cast<double>(s[row * kLd + c]);
      s[row * kLd + c] = static_cast<float>(acc);
    }
    carry = acc;
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const TW* __restrict__ lw, const float* __restrict__ u,
                  const float* __restrict__ s0, float* __restrict__ y,
                  float* __restrict__ s_out, Strides st, int h, int q, int dk, int dv) {
  extern __shared__ float smem[];
  float* sA = smem;              // logw -> cw / pw, then score tiles
  float* sR = sA + kTile;        // r, then r * exp(clip(pw))
  float* sK = sR + kTile;        // k, then its decayed form
  float* sV = sK + kTile;        // v, or S_in
  float* sU = sV + kTile;        // u of the head
  float* sDiag = sU + kD;        // sum_k r u k of the tile's rows
  float* sLast = sDiag + kD;     // cw of the chunk's last row

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const T* rb = r + bi * st.r[0] + hi * st.r[1];
  const T* kb = k + bi * st.k[0] + hi * st.k[1];
  const T* vb = v + bi * st.v[0] + hi * st.v[1];
  const TW* wb = lw + bi * st.w[0] + hi * st.w[1];
  const float* s_in = s0 + static_cast<int64_t>(bh) * dk * dv;
  const int n_tiles = (q + kT - 1) / kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  double carry = 0.0;  // meaningful in threads < kD

  if (blockIdx.y == 0) {
    // ---- S_out = S_in * exp(clip(cw_last)) + (k * exp(clip(cw_last - cw)))^T v
    for (int j = 0; j < n_tiles; ++j) {
      load_tile(sA, wb, st.w[2], j * kT, q, dk);
      __syncthreads();
      tile_cumsum(sA, carry, min(kT, q - j * kT));
      __syncthreads();
    }
    if (threadIdx.x < kD) sLast[threadIdx.x] = static_cast<float>(carry);
    carry = 0.0;
    float acc[4][4] = {};
    for (int j = 0; j < n_tiles; ++j) {
      load_tile(sA, wb, st.w[2], j * kT, q, dk);
      load_tile(sK, kb, st.k[2], j * kT, q, dk);
      load_tile(sV, vb, st.v[2], j * kT, q, dv);
      __syncthreads();
      tile_cumsum(sA, carry, min(kT, q - j * kT));
      __syncthreads();
      for (int i = threadIdx.x; i < kT * kD; i += kThreads) {
        const int row = i / kD, col = i % kD;
        const int o = row * kLd + col;
        sK[o] *= expf(clip(sLast[col] - sA[o], -kClamp, 0.f));
      }
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < kT; ++s) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sK[s * kLd + ty + 16 * i];
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = sV[s * kLd + tx + 16 * i];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
      }
      __syncthreads();
    }
    float* so = s_out + static_cast<int64_t>(bh) * dk * dv;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = ty + 16 * i;
      if (kk >= dk) continue;
      const float decay = expf(clip(sLast[kk], -kClamp, 0.f));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int vv = tx + 16 * jj;
        if (vv < dv) so[kk * dv + vv] = s_in[kk * dv + vv] * decay + acc[i][jj];
      }
    }
    return;
  }

  // ---- y rows t0 .. t0 + 63
  const int tile = n_tiles - static_cast<int>(blockIdx.y);  // heaviest first
  const int t0 = tile * kT;
  const int rows = min(kT, q - t0);

  // the carry into this tile: the prefix sum of rows 0 .. t0 - 1
  for (int j = 0; j < tile; ++j) {
    load_tile(sA, wb, st.w[2], j * kT, q, dk);
    __syncthreads();
    tile_cumsum(sA, carry, kT);
    __syncthreads();
  }
  load_tile(sA, wb, st.w[2], t0, q, dk);
  load_tile(sR, rb, st.r[2], t0, q, dk);
  load_tile(sK, kb, st.k[2], t0, q, dk);
  for (int i = threadIdx.x; i < kD; i += kThreads) sU[i] = i < dk ? u[hi * dk + i] : 0.f;
  __syncthreads();
  if (threadIdx.x < kD) {  // pw = cw - logw of the tile's rows
    const int c = threadIdx.x;
    double acc = carry;
    for (int row = 0; row < rows; ++row) {
      const float w = sA[row * kLd + c];
      acc += static_cast<double>(w);
      sA[row * kLd + c] = static_cast<float>(acc) - w;
    }
  } else if (threadIdx.x < kD + kT) {  // the diagonal bonus's dot products
    const int row = threadIdx.x - kD;
    float d = 0.f;
    for (int c = 0; c < kD; ++c) d += sR[row * kLd + c] * sU[c] * sK[row * kLd + c];
    sDiag[row] = d;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kT * kD; i += kThreads) {
    const int o = (i / kD) * kLd + i % kD;
    sR[o] *= expf(clip(sA[o], -kClamp, 0.f));
  }
  for (int i = threadIdx.x; i < kD * kD; i += kThreads) {  // S_in into sV
    const int kk = i / kD, vv = i % kD;
    sV[kk * kLd + vv] = (kk < dk && vv < dv) ? s_in[kk * dv + vv] : 0.f;
  }
  __syncthreads();

  // inter-chunk: (r * exp(clip(pw))) @ S_in
  float inter[4][4] = {};
#pragma unroll 4
  for (int kk = 0; kk < kD; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sR[(ty + 16 * i) * kLd + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = sV[kk * kLd + tx + 16 * i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) inter[i][jj] = fmaf(a[i], b[jj], inter[i][jj]);
  }
  __syncthreads();

  // intra-chunk: key tiles 0 .. tile, the diagonal one masked s < t
  float intra[4][4] = {};
  carry = 0.0;
  for (int j = 0; j <= tile; ++j) {
    const int s0j = j * kT;
    load_tile(sA, wb, st.w[2], s0j, q, dk);
    load_tile(sK, kb, st.k[2], s0j, q, dk);
    load_tile(sV, vb, st.v[2], s0j, q, dv);
    __syncthreads();
    tile_cumsum(sA, carry, min(kT, q - s0j));
    __syncthreads();
    for (int i = threadIdx.x; i < kT * kD; i += kThreads) {
      const int o = (i / kD) * kLd + i % kD;
      sK[o] *= expf(clip(-sA[o], -kClamp, kClamp));
    }
    __syncthreads();
    float sc[4][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < kD; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sR[(ty + 16 * i) * kLd + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = sK[(tx + 16 * i) * kLd + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = fmaf(a[i], b[jj], sc[i][jj]);
    }
    // sA's cw is no longer read: the scores go there, masked s < t
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int row = ty + 16 * i, key = tx + 16 * jj;
        sA[row * kLd + key] = (s0j + key < t0 + row) ? sc[i][jj] : 0.f;
      }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < kT; ++s) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[(ty + 16 * i) * kLd + s];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = sV[s * kLd + tx + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) intra[i][jj] = fmaf(a[i], b[jj], intra[i][jj]);
    }
    if (j < tile) __syncthreads();
  }

  // y = (inter + intra) + diag * v; sV holds this tile's own v rows
  float* yb = y + bi * st.y[0] + hi * st.y[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = tx + 16 * jj;
      if (col < dv) {
        yb[(t0 + row) * st.y[2] + col] =
            (inter[i][jj] + intra[i][jj]) + sDiag[row] * sV[row * kLd + col];
      }
    }
  }
}

template <typename T, typename TW>
cudaError_t launch(const void* r, const void* k, const void* v, const void* lw, const float* u,
                   const float* s0, float* y, float* s_out, const Strides& st, int b, int h,
                   int q, int dk, int dv, cudaStream_t stream) {
  auto kern = wkv6_chunk_kernel<T, TW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (q + kT - 1) / kT;
  if (n_tiles + 1 > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(b) * static_cast<unsigned>(h),
                  static_cast<unsigned>(n_tiles + 1));
  kern<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(lw), u, s0, y, s_out, st, h, q, dk, dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_w(int wdtype, const void* r, const void* k, const void* v, const void* lw,
                       const float* u, const float* s0, float* y, float* s_out,
                       const Strides& st, int b, int h, int q, int dk, int dv,
                       cudaStream_t stream) {
  if (wdtype == 0) return launch<T, float>(r, k, v, lw, u, s0, y, s_out, st, b, h, q, dk, dv,
                                           stream);
  if (wdtype == 1) return launch<T, __nv_bfloat16>(r, k, v, lw, u, s0, y, s_out, st, b, h, q,
                                                   dk, dv, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y (strided, f32) and s_out ((b, h, dk, dv) contiguous, f32) of one chunk
// from r, k, logw (b, h, q, dk), v (b, h, q, dv), read through their
// (batch, head, token) strides in elements (the last dimension contiguous),
// u (h, dk) and s0 (b, h, dk, dv), both contiguous f32. dtype: r, k, v
// (0 = f32, 1 = bf16); wdtype: logw (the same codes). Needs b, h, q >= 1 and
// 1 <= dk, dv <= 64. s_out must not alias s0.
int wkv6_forward(const void* r, const void* k, const void* v, const void* logw, const void* u,
                 const void* s0, void* y, void* s_out, int64_t r_sb, int64_t r_sh,
                 int64_t r_st, int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb,
                 int64_t v_sh, int64_t v_st, int64_t w_sb, int64_t w_sh, int64_t w_st,
                 int64_t y_sb, int64_t y_sh, int64_t y_st, int b, int h, int q, int dk, int dv,
                 int dtype, int wdtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || h < 1 || q < 1 || dk < 1 || dk > kD || dv < 1 || dv > kD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st = {{r_sb, r_sh, r_st}, {k_sb, k_sh, k_st}, {v_sb, v_sh, v_st},
                      {w_sb, w_sh, w_st}, {y_sb, y_sh, y_st}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* sof = static_cast<float*>(s_out);
  if (dtype == 0) {
    err = dispatch_w<float>(wdtype, r, k, v, logw, uf, s0f, yf, sof, st, b, h, q, dk, dv, s);
  } else if (dtype == 1) {
    err = dispatch_w<__nv_bfloat16>(wdtype, r, k, v, logw, uf, s0f, yf, sof, st, b, h, q, dk,
                                    dv, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
