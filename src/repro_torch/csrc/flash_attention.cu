// GQA flash attention, forward, sm_90a:
//     out (B, Hq, Sq, Dh) = softmax(Q K^T * scale [causal mask]) V,
// q (B, Hq, Sq, Dh), k and v (B, Hkv, Skv, Dh), bf16 or f32, out in q's dtype.
//
// Replaces src/repro/kernels/flash_attention/kernel.py: flash_attention
// (_flash_kernel). It computes what the TPU kernel computes, all in f32:
// Q K^T * scale, the -1e30 mask (kv positions >= Skv; with causal, kpos >
// qpos, top-left aligned: query row i at kv position qpos = q_offset + i,
// q_offset 0 but for a sequence shard's rows, whose keys are the whole
// sequence's), the running max m and sum l of an online softmax,
// the f32 accumulator, p kept in f32 for P.V (the plain version rounds p to
// v's dtype first), and acc / max(l, 1e-30) at the end.
//
// Bound: at the main path's shape (B = 4, Hq = 12, Hkv = 2, S = 8192,
// Dh = 128, causal, bf16) one call does about 8.3e11 flop (2 * 2 * S^2 / 2 *
// Dh per query head) and moves about 0.23 GB (q, k, v read once, out written
// once): 0.834 ms at the 989 TFLOP/s bf16 dense tensor-core peak, 0.07 ms at
// 3.35 TB/s. It is bound by operations.
//
// Two routes, chosen by the caller from dtype and shape (kernel.py,
// wgmma_route); both are hand-written here and neither falls back on the
// other.
//
// 1. The wgmma route (flash_fwd_wgmma_kernel): bf16, Dh 64 or 128, every
//    (B, H, S) stride a multiple of 16 bytes and 16-byte aligned bases, Skv
//    >= 1. It takes the main path (qwen2-1.5b, Dh 128) and every full-size
//    dense config.
//    - A block owns 128 query rows of one (batch, query head): two consumer
//      warpgroups of 64 rows each and one producer warpgroup, of which one
//      thread issues every copy (setmaxnreg leaves the producer 24
//      registers a thread and gives the consumers 240). The producer loads
//      Q once and K and V tiles of 128 kv rows into a 3-stage ring in
//      shared memory by TMA; mbarriers count the bytes in, and the
//      consumers' eight warps release a stage. Tiles of 128 kv rows match
//      the 128-row query block, so the causal diagonal is one tile, and 128
//      columns of S are as wide as the registers allow (64 f32 of S, 64 of O
//      and 64 of the split P a thread); 224 KB of Q and ring at Dh 128.
//      Tensor maps are built per call from the (B, H, S) strides, so the
//      head-major views layers.attention_block passes go in without a copy;
//      TMA's zero fill past Sq and Skv replaces masked loads (out-of-range
//      kv columns are masked to -1e30 as well, so they weigh 0). Tiles land
//      128-byte swizzled, in panels of 64 columns, the layout wgmma reads.
//    - S = Q K^T by wgmma m64n128k16 (both operands K-major in shared
//      memory), f32 in registers. The online softmax runs on those
//      registers: mask (only on the tile that holds the diagonal or the kv
//      edge), row max over the four lanes of a quad, exp2 of s * scale *
//      log2(e) - m in one FMA, the alpha rescale of O. S never goes through
//      shared memory.
//    - P.V by wgmma m64nDHk16 with A from registers (the accumulator layout
//      of S is the A-fragment layout) and V as the B operand, MN-major
//      (transposed) from the same shared-memory tile. p stays f32 for l; for
//      the product it is split in registers into p_hi = bf16(p) and p_lo =
//      bf16(p - p_hi), and two wgmmas add p_hi V and p_lo V into the same f32
//      accumulator: p keeps about 16 significant bits (2^-16 of p against
//      f32 p), what the TPU kernel's f32 p asks for and far inside the bf16
//      output's 2^-9. Rounding p to bf16 once, as SDPA and the plain version
//      do, would change the function. The split costs 1.5x the tensor-core
//      work: the floor at the main shape is 1.26 ms, against the function's
//      0.834.
//    - Overlap: each step issues S of tile t + 1 and P V of tile t as two
//      commit groups, waits for S alone, runs the exponentials of tile t + 1
//      while P V is in flight, then splits p and rescales O. The two
//      warpgroups share the tensor cores, so one's softmax runs under the
//      other's products.
//    - Causal: the kv loop stops after the tile that holds the block's last
//      query row; blocks of the heaviest query tiles go first.
//    - No atomics and one fixed order of every sum: repeated calls give
//      identical bits.
// 2. The generic route (flash_fwd_kernel): f32 inputs, which run on the CUDA
//    cores for both products (a TF32 product would round them), and bf16
//    shapes TMA cannot describe (Dh 12, 16, 65, 100; unaligned strides),
//    whose Q.K^T runs on mma.sync m16n8k16 and P.V on the CUDA cores in f32.
//    - A block owns one (batch * query head, 64-row query tile); its m, l and
//      accumulator stay in registers for the whole kv loop. 256 threads:
//      thread (ty, tx) owns query rows ty + 16 r and kv columns tx + 16 c
//      (r, c < 4) of the 64 x 64 score tile, and the same rows times Dh
//      columns tx * 4 + 64 g of the accumulator, so the row max and sum are a
//      16-lane shuffle; P (64 x 64 f32) goes through shared memory to the
//      P V product. DH is compiled as 64 or 128; a smaller Dh runs with a
//      zero tail. Ragged Sq and Skv are masked in the loads.
//    - f32: Q and one K-or-V buffer in f32 in shared memory, rows padded by 4
//      floats. bf16: Q and K stay bf16 (rows padded by 8 elements), V is
//      widened to f32; S = Q K^T by mma.sync (warp w owns S rows 16 (w % 4)
//      and columns 32 (w / 4)) is written to the P buffer.
//    - 16-byte loads when every row starts on a 16-byte boundary and Dh fills
//      whole 16-byte chunks, else element loads. 88-89 KB of shared memory
//      at DH = 128: two blocks per SM. No atomics.
// GQA in both: query head h reads kv head h / (Hq / Hkv) of the same batch
// row (kernel.py:108); K and V are never repeated in memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

// ---------------------------------------------------------------------------
// The generic route
// ---------------------------------------------------------------------------
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
                 int group, int sq, int skv, int dh, float scale, int causal, int qoff) {
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
  // query row i sits at kv position qoff + i (a sequence shard's rows)
  const int kt_end = causal ? min(n_kt, (qoff + q0 + qrows - 1) / kBK + 1) : n_kt;
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
      const int qpos = qoff + q0 + ty + 16 * r;
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
                   int qoff, cudaStream_t stream) {
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
      hq / hkv, sq, skv, dh, scale, causal, qoff);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, const int64_t* st,
                     int b, int hq, int hkv, int sq, int skv, int dh, int dh_bucket, float scale,
                     int causal, int qoff, int vec, cudaStream_t stream) {
  if (dh_bucket == 64) {
    return vec ? launch<T, 64, true>(q, k, v, out, st, b, hq, hkv, sq, skv, dh, scale, causal,
                                     qoff, stream)
               : launch<T, 64, false>(q, k, v, out, st, b, hq, hkv, sq, skv, dh, scale, causal,
                                      qoff, stream);
  }
  if (dh_bucket == 128) {
    return vec ? launch<T, 128, true>(q, k, v, out, st, b, hq, hkv, sq, skv, dh, scale, causal,
                                      qoff, stream)
               : launch<T, 128, false>(q, k, v, out, st, b, hq, hkv, sq, skv, dh, scale, causal,
                                       qoff, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// The wgmma route
// ---------------------------------------------------------------------------
namespace hopper {

constexpr int kBQ = 128;                   // query rows per block: two warpgroups of 64
constexpr int kBK = 128;                   // kv rows per tile
constexpr int kStages = 3;                 // depth of the K/V ring
constexpr int kConsumerWarps = 8;          // two consumer warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // and the producer warpgroup
// Registers a thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 <= 65,536.
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kPanel = 64;                 // bf16 columns of one 128-byte swizzled panel
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "a Q tile and a K or V tile share one layout");

// Shared memory of one block: Q | K0 V0 | K1 V1 ..., each tile DH / 64
// panels of 128 rows x 128 bytes (1024-byte aligned, as the 128-byte swizzle
// needs), plus 1024 bytes to align the base.
template <int DH>
struct Tiles {
  static constexpr int kPanels = DH / kPanel;
  static constexpr int kPanelBytes = kBK * kPanel * 2;
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  static constexpr int kSmemBytes = (1 + 2 * kStages) * kTileBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One TMA box (64 columns x 128 rows of one (head, batch)) into shared
// memory at `dst`; its bytes count toward `bar`'s expected transaction.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(batch),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`:
// lbo and sbo in bytes (sbo = 1024, the stride of 8-row groups; lbo = the
// stride of 64-column panels along N for the MN-major V, unused for the
// K-major Q and K).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, f32) = [d +] A (64 x 16) B (16 x 128): A and B bf16 in shared
// memory, both K-major (descriptors da, db); scale_d = 0 ignores d's old value.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16) B (16 x 128): A bf16 in registers (the
// fragment of the accumulator layout), B bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64): A bf16 in registers (the
// fragment of the accumulator layout), B bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  uint32_t u;
  __builtin_memcpy(&u, &x, sizeof(u));
  return u;
}

// acc (64 x DH) += P (64 x 128) V (128 x DH) for one warpgroup, P from the
// A fragments `a` (16 kv columns each), V's tile described by `v_desc`.
template <int DH>
__device__ __forceinline__ void pv_product(float (&o)[DH / 2], const uint32_t (&a)[kBK / 16][4],
                                           uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t d = v_desc + ((kk * 16 * 128) >> 4);  // 16 kv rows of 128 bytes
    if constexpr (DH == 128) {
      wgmma_rs_m64n128_tb(o, a[kk], d);
    } else {
      wgmma_rs_m64n64_tb(o, a[kk], d);
    }
  }
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x 128) = Q K^T for one warpgroup: DH / 16 steps of 16 columns, four
// to a 128-byte panel.
template <int DH>
__device__ __forceinline__ void qk_product(float (&sc)[kBK / 2], uint64_t q_desc,
                                           uint64_t k_desc) {
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    const uint32_t off = (j / 4) * Tiles<DH>::kPanelBytes + (j % 4) * 32;
    wgmma_ss_m64n128(sc, q_desc + (off >> 4), k_desc + (off >> 4), j > 0);
  }
}

// The online softmax's first half on a finished S tile, in place: mask (on
// the tile that holds the kv edge or the causal diagonal; qpos0 is the kv
// position of this thread's first row), the new row max m
// (log2 domain), sc = exp2(sc * scale_log2 - m), alpha = exp2(m_old - m), and
// the row sums into l (this thread's share).
__device__ __forceinline__ void softmax_exp(float (&sc)[kBK / 2], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], float scale_log2, bool edge,
                                            int k0, int skv, int causal, int qpos0, int col0) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = sc[4 * j + e];
      if (edge) {
        const int kpos = k0 + 8 * j + col0 + (e % 2);
        if (kpos >= skv || (causal && kpos > qpos0 + 8 * (e / 2))) x = kNegInf;
      }
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  }
  float neg_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * scale_log2);
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    neg_m[i] = -m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < kBK / 2; ++e) {
    sc[e] = ex2(fmaf(sc[e], scale_log2, neg_m[(e / 2) % 2]));
    rs[(e / 2) % 2] += sc[e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rs[i];
}

// p (f32, in sc) into bf16 A fragments p_hi = bf16(p) and p_lo = bf16(p -
// p_hi). Fragment register r of step kk holds columns 16 kk + 8 (r / 2) +
// col0 + {0, 1} of row row0 + 8 (r % 2): S elements 8 kk + 2 r and + 1.
__device__ __forceinline__ void split_p(const float (&sc)[kBK / 2], uint32_t (&p_hi)[kBK / 16][4],
                                        uint32_t (&p_lo)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float p0 = sc[8 * kk + 2 * r], p1 = sc[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[kk][r] = bf16x2_bits(hi);
      p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                       int hq, int group, int sq, int skv, float scale_log2, int causal,
                       int qoff) {
  using T = Tiles<DH>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(8) uint64_t q_bar;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // stage s of the ring: K at k_tile(s), V at k_tile(s) + kTileBytes
  auto k_tile = [&](int s) { return base + (1 + 2 * s) * T::kTileBytes; };

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal tiles first
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int n_kt = (skv + kBK - 1) / kBK;
  // query row i sits at kv position qoff + i (a sequence shard's rows); an
  // offset off the 128-row tile puts the diagonal inside a tile
  const int kt_end = causal ? min(n_kt, (qoff + q_last) / kBK + 1) : n_kt;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kConsumerWarps);
    }
    mbar_init(&q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(&q_bar, T::kTileBytes);
#pragma unroll
      for (int p = 0; p < T::kPanels; ++p) {
        tma_load(base + p * T::kPanelBytes, &tq, &q_bar, p * kPanel, q0, h, b);
      }
      for (int kt = 0; kt < kt_end; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty_bar[s], ((kt / kStages) & 1) ^ 1);  // a fresh stage passes at once
        mbar_expect_tx(&full_bar[s], 2 * T::kTileBytes);
#pragma unroll
        for (int p = 0; p < T::kPanels; ++p) {
          const uint32_t off = p * T::kPanelBytes;
          tma_load(k_tile(s) + off, &tk, &full_bar[s], p * kPanel, kt * kBK, kvh, b);
          tma_load(k_tile(s) + T::kTileBytes + off, &tv, &full_bar[s], p * kPanel, kt * kBK,
                   kvh, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // A consumer warpgroup: rows q0 + 64 wg .. + 63. Thread (warp wl, lane)
  // holds rows r = q0 + 64 wg + 16 wl + lane / 4 and r + 8, and in each
  // 8-column block j of S (and of O) the columns 8 j + 2 (lane % 4) + {0, 1}:
  // element [4 j + 2 i + c] is row r + 8 i, column 8 j + 2 (lane % 4) + c.
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint64_t q_desc = sw128_desc(base + wg * 64 * 128, 0, 1024);
  const int qpos0 = qoff + row0;  // kv position of row row0 (the causal mask's)
  auto edge = [&](int k0) {
    return k0 + kBK > skv || (causal && k0 + kBK - 1 > qoff + q0 + wg * 64);
  };
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums; the quad adds them at the end
  float alpha[2];
  float sc[kBK / 2];
  uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];

  // Tile 0: S, softmax, split.
  mbar_wait(&q_bar, 0);
  mbar_wait(&full_bar[0], 0);
  wgmma_fence();
  qk_product<DH>(sc, q_desc, sw128_desc(k_tile(0), 0, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax_exp(sc, m, l, alpha, scale_log2, edge(0), 0, skv, causal, qpos0, col0);
  split_p(sc, p_hi, p_lo);

  // Step kt < kt_end - 1: S of tile kt + 1 and P V of tile kt go to the
  // tensor cores as two commit groups, S first; the exponentials of tile
  // kt + 1 run while P V is in flight; then the split and the rescale of O.
  // Every step issues both groups (the last tile's P V follows the loop), so
  // the compiler can see which group each wait completes and leaves the
  // wgmmas asynchronous.
  // V is MN-major: 8-row groups 1024 bytes apart, 64-column panels
  // kPanelBytes apart.
  auto v_desc = [&](int s) { return sw128_desc(k_tile(s) + T::kTileBytes, T::kPanelBytes, 1024); };
  int kt = 0;
  for (; kt + 1 < kt_end; ++kt) {
    const int s = kt % kStages;
    const int s1 = (kt + 1) % kStages;
    mbar_wait(&full_bar[s1], ((kt + 1) / kStages) & 1);
    wgmma_fence();
    qk_product<DH>(sc, q_desc, sw128_desc(k_tile(s1), 0, 1024));
    wgmma_commit();
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
    pv_product<DH>(o, p_hi, v_desc(s));
    pv_product<DH>(o, p_lo, v_desc(s));
    wgmma_commit();
    wgmma_wait<1>();  // S of tile kt + 1 is done
    fence_regs(sc);
    softmax_exp(sc, m, l, alpha, scale_log2, edge((kt + 1) * kBK), (kt + 1) * kBK, skv, causal,
                qpos0, col0);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[s]);  // this warp is done with K and V of tile kt
    split_p(sc, p_hi, p_lo);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
    }
  }
  // The last tile's P V.
  fence_regs(o);
  fence_regs(p_hi);
  fence_regs(p_lo);
  wgmma_fence();
  pv_product<DH>(o, p_hi, v_desc(kt % kStages));
  pv_product<DH>(o, p_lo, v_desc(kt % kStages));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

  // out = acc / max(l, 1e-30), bf16.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row < sq) {
      const float den = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = out + (static_cast<int64_t>(bh) * sq + row) * DH + col0;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] / den, o[4 * j + 2 * i + 1] / den);
      }
    }
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime's entry-point
// query, so the library does not link libcuda.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A (Dh, S, H, B) bf16 map with 64 x 128 boxes, 128-byte swizzle, zero fill
// past every edge; strides in elements.
CUresult tensor_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int dh, int s,
                    int h, int b, int64_t ss, int64_t sh, int64_t sb) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kPanel, kBK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kMapFailed = 100000;  // + CUresult: a tensor map was refused

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, const int64_t* st, int b,
           int hq, int hkv, int sq, int skv, float scale, int causal, int qoff,
           cudaStream_t stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  CUresult res = tensor_map(encode, &tq, q, DH, sq, hq, b, st[2], st[1], st[0]);
  if (res == CUDA_SUCCESS) res = tensor_map(encode, &tk, k, DH, skv, hkv, b, st[5], st[4], st[3]);
  if (res == CUDA_SUCCESS) res = tensor_map(encode, &tv, v, DH, skv, hkv, b, st[8], st[7], st[6]);
  if (res != CUDA_SUCCESS) return kMapFailed + static_cast<int>(res);
  auto kern = flash_fwd_wgmma_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tiles<DH>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (sq + kBQ - 1) / kBQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(b) * static_cast<unsigned>(hq),
                  static_cast<unsigned>(n_qt));
  kern<<<grid, kThreads, Tiles<DH>::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), hq, hq / hkv, sq, skv,
      scale * 1.4426950408889634f, causal, qoff);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

extern "C" {

const char* fa_error_string(int code) {
  if (code >= hopper::kMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (b, hq, sq, dh), contiguous, = attention of q over k, v, read through
// the (batch, head, sequence) strides q_sb.. v_ss (elements; the last
// dimension contiguous). dtype 0 = f32, 1 = bf16; dh_bucket 64 or 128 >= dh;
// vec 1 when every row starts on a 16-byte boundary and dh fills whole
// 16-byte chunks. Needs b, hq, sq >= 1, hkv >= 1 dividing hq. With causal,
// query row i sits at kv position qoff + i (qoff 0, any sq: top-left; qoff > 0
// with qoff + sq <= skv: a sequence shard's rows against the whole sequence's
// keys).
int fa_forward(const void* q, const void* k, const void* v, void* out, int64_t q_sb,
               int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
               int64_t v_sb, int64_t v_sh, int64_t v_ss, int b, int hq, int hkv, int sq,
               int skv, int dh, int dh_bucket, float scale, int causal, int qoff, int dtype,
               int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hkv < 1 || hq % hkv != 0 || dh < 1 || dh > dh_bucket || qoff < 0 ||
      (qoff > 0 && qoff + sq > skv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = dispatch<float>(q, k, v, out, st, b, hq, hkv, sq, skv, dh, dh_bucket, scale, causal,
                          qoff, vec, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(q, k, v, out, st, b, hq, hkv, sq, skv, dh, dh_bucket, scale,
                                  causal, qoff, vec, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The wgmma route: bf16 q, k, v with dh 64 or 128, 16-byte aligned bases and
// (batch, head, sequence) strides that are multiples of 8 elements (a stride
// of a dimension of size 1 is not read), skv >= 1; out and qoff as above.
int fa_forward_wgmma(const void* q, const void* k, const void* v, void* out, int64_t q_sb,
                     int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                     int64_t v_sb, int64_t v_sh, int64_t v_ss, int b, int hq, int hkv, int sq,
                     int skv, int dh, float scale, int causal, int qoff, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  bool ok = hkv >= 1 && hq % hkv == 0 && b >= 1 && sq >= 1 && skv >= 1 && qoff >= 0 &&
            (qoff == 0 || qoff + sq <= skv);
  for (const void* p : {q, k, v}) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int64_t x : st) ok = ok && x > 0 && x % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    return hopper::launch<64>(q, k, v, out, st, b, hq, hkv, sq, skv, scale, causal, qoff, s);
  }
  if (dh == 128) {
    return hopper::launch<128>(q, k, v, out, st, b, hq, hkv, sq, skv, scale, causal, qoff, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
