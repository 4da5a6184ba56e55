// GQA flash attention, forward, sm_90a:
//     out (B, Hq, Sq, Dh) = softmax(Q K^T * scale [causal mask]) V,
// q (B, Hq, Sq, Dh), k and v (B, Hkv, Skv, Dh), bf16 or f32, out in q's dtype.
//
// Replaces src/repro/kernels/flash_attention/kernel.py: flash_attention
// (_flash_kernel). It computes what the TPU kernel computes, all in f32:
// Q K^T * scale, the -1e30 mask (kv positions >= Skv; with causal, kpos >
// qpos, top-left aligned), the running max m and sum l of an online softmax,
// the f32 accumulator, p kept in f32 for P.V (the plain version rounds p to
// v's dtype first), and acc / max(l, 1e-30) at the end.
//
// Bound: at the main path's shape (B = 4, Hq = 12, Hkv = 2, S = 8192,
// Dh = 128, causal, bf16) one call does about 8.3e11 flop (2 * 2 * S^2 / 2 *
// Dh per query head) and moves about 0.23 GB (q, k, v read once, out written
// once): 0.83 ms at the 989 TFLOP/s bf16 dense tensor-core peak, 0.07 ms at
// 3.35 TB/s. It is bound by operations. Half of those operations, Q K^T,
// run on the tensor cores for bf16 inputs (mma.sync m16n8k16, bf16 products,
// which are exact in f32, summed in f32); P V runs on the CUDA cores in f32,
// so p stays f32 as in the TPU kernel (a bf16 product would round it), and
// f32 inputs take the CUDA cores for both products (a TF32 product would
// round them). wgmma, TMA staging and a tensor-core P V are later work.
//
// Design:
// - The TPU kernel's sequential kv grid axis becomes a loop inside the
//   block. A block owns one (batch * query head, 64-row query tile); its
//   m, l and accumulator stay in registers for the whole loop, so nothing
//   passes between blocks. Blocks of the heaviest causal tiles go first
//   (grid.y runs the query tiles from the last one down).
// - Causal: the loop stops after the kv tile that holds the tile's last
//   real query row, which replaces the TPU kernel's pl.when skip of tiles
//   above the diagonal; the diagonal tile is masked element by element.
// - GQA: query head h reads kv head h / (Hq / Hkv) of the same batch row
//   (kernel.py:108); K and V are never repeated in memory.
// - q, k and v are read through their (B, H, S) strides, so the head-major
//   view that attention_block builds by reshape + transpose goes in without
//   a copy (the last dimension must be contiguous). Ragged Sq and Skv are
//   masked here; nothing is padded: tiles are zero-filled past the edge and
//   past Dh, and out-of-range kv positions score -1e30 (exp gives 0).
// - 256 threads. Thread (ty, tx) owns query rows ty + 16 r and kv columns
//   tx + 16 c (r, c < 4) of the 64 x 64 score tile S, and the same rows
//   times Dh columns tx * 4 + 64 g of the accumulator, so the row max and
//   sum are a 16-lane shuffle; P (64 x 64 f32) goes through shared memory
//   to the P V product. DH is compiled as 64 or 128; a smaller Dh runs with
//   a zero tail.
// - f32 inputs: Q and one K-or-V buffer in f32 in dynamic shared memory,
//   rows padded by 4 floats so the float4 reads of 8 lanes fall on distinct
//   banks. Per kv tile: load K, S = Q K^T in registers (16 FMAs per pair of
//   float4 reads), softmax update, P to shared memory, load V into the same
//   buffer, acc += P V.
// - bf16 inputs: Q and K stay bf16 in shared memory (rows padded by 8
//   elements: the fragment reads of a warp fall on 32 distinct banks), V is
//   widened to f32 beside them. Per kv tile: load K and V, S = Q K^T by
//   mma.sync (warp w owns S rows 16 (w % 4) and columns 32 (w / 4), four
//   m16n8k16 products per 16-deep step) written to the P buffer, then the
//   same softmax and P V as above.
// - 16-byte loads (8 bf16 or 4 f32 a thread) when every row starts on a
//   16-byte boundary and Dh fills whole 16-byte chunks, else element loads.
//   88 KB (f32) or 89 KB (bf16) of shared memory at DH = 128 and at most 128
//   registers a thread leave room for two blocks per SM.
// - No atomics: repeated calls give identical bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                // query rows per block
constexpr int kBK = 64;                // kv rows per tile
constexpr int kPStride = kBK + 16;     // P row stride: two rows' halves on distinct banks
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [0, 64) of one head's tile starting at `base` (row stride `ss`
// elements) into shared memory as f32, row stride DH + 4; zero past `nrows`
// rows and past `dh` columns.
template <typename T, int DH, bool VEC>
__device__ __forceinline__ void load_tile(float* sm, const T* __restrict__ base, int64_t ss,
                                          int nrows, int dh) {
  constexpr int LD = DH + 4;
  if constexpr (VEC) {
    constexpr int VE = 16 / sizeof(T);  // elements per 16-byte chunk
    constexpr int CPR = DH / VE;        // chunks per row
    for (int c = threadIdx.x; c < kBK * CPR; c += kThreads) {
      const int row = c / CPR;
      const int col = (c % CPR) * VE;
      float vals[VE];
      if (row < nrows && col < dh) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(base + row * ss + col));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < VE; ++i) vals[i] = to_f32(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < VE; ++i) vals[i] = 0.f;
      }
      float* dst = sm + row * LD + col;
#pragma unroll
      for (int i = 0; i < VE; i += 4) {
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kBK * DH; e += kThreads) {
      const int row = e / DH;
      const int col = e % DH;
      sm[row * LD + col] = (row < nrows && col < dh) ? to_f32(base[row * ss + col]) : 0.f;
    }
  }
}

// The same tile kept in bf16, row stride DH + 8 elements.
template <int DH, bool VEC>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* sm,
                                               const __nv_bfloat16* __restrict__ base,
                                               int64_t ss, int nrows, int dh) {
  constexpr int LDH = DH + 8;
  if constexpr (VEC) {
    constexpr int CPR = DH / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < kBK * CPR; c += kThreads) {
      const int row = c / CPR;
      const int col = (c % CPR) * 8;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (row < nrows && col < dh) {
        raw = __ldg(reinterpret_cast<const uint4*>(base + row * ss + col));
      }
      *reinterpret_cast<uint4*>(sm + row * LDH + col) = raw;
    }
  } else {
    for (int e = threadIdx.x; e < kBK * DH; e += kThreads) {
      const int row = e / DH;
      const int col = e % DH;
      sm[row * LDH + col] =
          (row < nrows && col < dh) ? base[row * ss + col] : __float2bfloat16_rn(0.f);
    }
  }
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, k-major).
__device__ __forceinline__ void mma_bf16_16816(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Shared memory of one block, in bytes: Q, K (bf16) or K-or-V (f32), V
// (bf16 inputs only), and P.
template <typename T, int DH>
constexpr int smem_bytes() {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return 2 * kBQ * (DH + 8) * 2 + kBK * (DH + 4) * 4 + kBQ * kPStride * 4;
  } else {
    return 2 * kBQ * (DH + 4) * 4 + kBQ * kPStride * 4;
  }
}

template <typename T, int DH, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                 int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int hq,
                 int group, int sq, int skv, int dh, float scale, int causal) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LD = DH + 4;   // f32 rows
  constexpr int LDH = DH + 8;  // bf16 rows
  constexpr int NG = DH / 64;  // float4 column groups of the accumulator a thread owns
  extern __shared__ float4 smem_f4[];
  // f32 inputs: qs | kvs (K, then V) | ps.  bf16 inputs: qh | kh | vs | ps.
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* kvs = qs + kBQ * LD;
  __nv_bfloat16* qh = reinterpret_cast<__nv_bfloat16*>(smem_f4);
  __nv_bfloat16* kh = qh + kBQ * LDH;
  float* vs = kBf16 ? reinterpret_cast<float*>(kh + kBK * LDH) : kvs;
  float* ps = kBf16 ? vs + kBK * LD : kvs + kBK * LD;

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal tiles first
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int qrows = min(kBQ, sq - q0);
  if constexpr (kBf16) {
    load_tile_bf16<DH, VEC>(qh, q + b * q_sb + h * q_sh + q0 * q_ss, q_ss, qrows, dh);
  } else {
    load_tile<T, DH, VEC>(qs, q + b * q_sb + h * q_sh + q0 * q_ss, q_ss, qrows, dh);
  }

  float m[4], l[4], acc[4][NG][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][g][e] = 0.f;
    }
  }

  const int n_kt = (skv + kBK - 1) / kBK;
  const int kt_end = causal ? min(n_kt, (q0 + qrows - 1) / kBK + 1) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    const int krows = min(kBK, skv - k0);
    __syncthreads();  // the last tile's P.V is done with the K, V and P buffers
    float s[4][4];
    if constexpr (kBf16) {
      load_tile_bf16<DH, VEC>(kh, kb + k0 * k_ss, k_ss, krows, dh);
      load_tile<T, DH, VEC>(vs, vb + k0 * v_ss, v_ss, krows, dh);
      __syncthreads();
      // S = Q K^T on the tensor cores: warp w, rows wr.., columns wc.. .
      const int wr = (warp % 4) * 16;
      const int wc = (warp / 4) * 32;
      const int gid = lane / 4;
      const int tig = lane % 4;
      float c[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
      }
      const uint32_t* qa = reinterpret_cast<const uint32_t*>(qh + (wr + gid) * LDH) + tig;
      const uint32_t* qb8 = reinterpret_cast<const uint32_t*>(qh + (wr + gid + 8) * LDH) + tig;
#pragma unroll
      for (int kk = 0; kk < DH / 2; kk += 8) {  // 16 bf16 = 8 words a step
        const uint32_t a0 = qa[kk], a1 = qb8[kk], a2 = qa[kk + 4], a3 = qb8[kk + 4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t* kr =
              reinterpret_cast<const uint32_t*>(kh + (wc + 8 * j + gid) * LDH) + tig;
          mma_bf16_16816(c[j], a0, a1, a2, a3, kr[kk], kr[kk + 4]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wc + 8 * j + 2 * tig;
        *reinterpret_cast<float2*>(ps + (wr + gid) * kPStride + col) =
            make_float2(c[j][0], c[j][1]);
        *reinterpret_cast<float2*>(ps + (wr + gid + 8) * kPStride + col) =
            make_float2(c[j][2], c[j][3]);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[r][cc] = ps[(ty + 16 * r) * kPStride + tx + 16 * cc];
      }
    } else {
      load_tile<T, DH, VEC>(kvs, kb + k0 * k_ss, k_ss, krows, dh);
      __syncthreads();
      // S = Q K^T for rows ty + 16 r, columns tx + 16 c, on the CUDA cores.
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[r][cc] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qv[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * LD + d);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          kv[cc] = *reinterpret_cast<const float4*>(kvs + (tx + 16 * cc) * LD + d);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            s[r][cc] = fmaf(qv[r].x, kv[cc].x, s[r][cc]);
            s[r][cc] = fmaf(qv[r].y, kv[cc].y, s[r][cc]);
            s[r][cc] = fmaf(qv[r].z, kv[cc].z, s[r][cc]);
            s[r][cc] = fmaf(qv[r].w, kv[cc].w, s[r][cc]);
          }
        }
      }
    }

    // Scale, mask, online softmax; P to shared memory (each thread its own
    // elements).
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int kpos = k0 + tx + 16 * cc;
        const bool ok = kpos < skv && (!causal || kpos <= qpos);
        s[r][cc] = ok ? s[r][cc] * scale : kNegInf;
        mx = fmaxf(mx, s[r][cc]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        s[r][cc] = expf(s[r][cc] - m_new);
        sum += s[r][cc];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][g][e] *= alpha;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) ps[(ty + 16 * r) * kPStride + tx + 16 * cc] = s[r][cc];
    }
    __syncthreads();  // P is complete (f32 inputs: and every thread is done with K)
    if constexpr (!kBf16) {
      load_tile<T, DH, VEC>(vs, vb + k0 * v_ss, v_ss, krows, dh);
      __syncthreads();
    }

    // acc += P V, kv rows in ascending order, f32 on the CUDA cores.
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pv[r] = *reinterpret_cast<const float4*>(ps + (ty + 16 * r) * kPStride + j);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + (j + jj) * LD + tx * 4 + 64 * g);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = jj == 0 ? pv[r].x : jj == 1 ? pv[r].y : jj == 2 ? pv[r].z : pv[r].w;
            acc[r][g][0] = fmaf(p, vv.x, acc[r][g][0]);
            acc[r][g][1] = fmaf(p, vv.y, acc[r][g][1]);
            acc[r][g][2] = fmaf(p, vv.z, acc[r][g][2]);
            acc[r][g][3] = fmaf(p, vv.w, acc[r][g][3]);
          }
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), in T.
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row < sq) {
      const float den = fmaxf(l[r], 1e-30f);
      T* orow = out + (static_cast<int64_t>(bh) * sq + row) * dh;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = tx * 4 + 64 * g + e;
          if (d < dh) store_out(orow + d, acc[r][g][e] / den);
        }
      }
    }
  }
}

template <typename T, int DH, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, const int64_t* st,
                   int b, int hq, int hkv, int sq, int skv, int dh, float scale, int causal,
                   cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DH, VEC>;
  constexpr int smem = smem_bytes<T, DH>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kBQ - 1) / kBQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(b) * static_cast<unsigned>(hq),
                  static_cast<unsigned>(n_qt));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], hq,
      hq / hkv, sq, skv, dh, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, const int64_t* st,
                     int b, int hq, int hkv, int sq, int skv, int dh, int dh_bucket, float scale,
                     int causal, int vec, cudaStream_t stream) {
  if (dh_bucket == 64) {
    return vec ? launch<T, 64, true>(q, k, v, out, st, b, hq, hkv, sq, skv, dh, scale, causal,
                                     stream)
               : launch<T, 64, false>(q, k, v, out, st, b, hq, hkv, sq, skv, dh, scale, causal,
                                      stream);
  }
  if (dh_bucket == 128) {
    return vec ? launch<T, 128, true>(q, k, v, out, st, b, hq, hkv, sq, skv, dh, scale, causal,
                                      stream)
               : launch<T, 128, false>(q, k, v, out, st, b, hq, hkv, sq, skv, dh, scale, causal,
                                       stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (b, hq, sq, dh), contiguous, = attention of q over k, v, read through
// the (batch, head, sequence) strides q_sb.. v_ss (elements; the last
// dimension contiguous). dtype 0 = f32, 1 = bf16; dh_bucket 64 or 128 >= dh;
// vec 1 when every row starts on a 16-byte boundary and dh fills whole
// 16-byte chunks. Needs b, hq, sq >= 1, hkv >= 1 dividing hq.
int fa_forward(const void* q, const void* k, const void* v, void* out, int64_t q_sb,
               int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
               int64_t v_sb, int64_t v_sh, int64_t v_ss, int b, int hq, int hkv, int sq,
               int skv, int dh, int dh_bucket, float scale, int causal, int dtype, int vec,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hkv < 1 || hq % hkv != 0 || dh < 1 || dh > dh_bucket) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = dispatch<float>(q, k, v, out, st, b, hq, hkv, sq, skv, dh, dh_bucket, scale, causal,
                          vec, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(q, k, v, out, st, b, hq, hkv, sq, skv, dh, dh_bucket, scale,
                                  causal, vec, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
