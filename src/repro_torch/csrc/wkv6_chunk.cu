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
//     R~ = r * exp(clip(pw, -80, 0)),  K~ = k * exp(clip(-cw, -80, 80))
//     y  = R~ @ S_in + tril_{s<t}[R~ K~^T] @ v + (sum_k r * u * k) * v
//     S_out = S_in * exp(clip(cw_last, -80, 0))[:, None]
//           + (k * exp(clip(cw_last - cw, -80, 0)))^T @ v
// Once a channel's cumulative log decay passes -80 inside the chunk, both
// factors of a pair's weight saturate and the weight is 1, not
// exp(pw_t - cw_s): that is the TPU kernel's (and the model's) function, and
// this kernel reproduces it (ROADMAP, reference caveat (e)).
//
// Bound: at the main path's shape (B = 4, H = 64, q = 256, dk = dv = 64, r/k/v
// bf16, logw f32) the function is about 3.2e9 flop (the strictly lower
// triangle of R~ K~^T and of A V, q^2/2 * 64 * 2 each, plus q * 64 * 64 * 2
// for the inter-chunk product and for the state, per head) and moves about
// 67 MB (inputs read once, y and S_out written once): 20 us at 3.35 TB/s,
// 19 us at the TF32 tensor cores' 495 / 3 TFLOP/s (three TF32 products per
// f32 product keep f32's accuracy), 48 us at the 67 TFLOP/s f32 CUDA-core
// peak. So on the tensor cores it is bound by bytes and operations alike.
// bf16 has f32's exponent range; what it lacks is precision (8 bits), so the
// products run on f32 values, as the TPU kernel's do, in 3xTF32.
//
// Design:
// - One block per (batch, head) walks the chunk's 64-row tiles in order and
//   carries the state of the earlier tiles,
//       M_j = S_in + sum over tiles i < j of K~_i^T V_i   (64 x 64, f32),
//   so tile j's rows take y = R~_j M_j + tril(R~_j K~_j^T) V_j + bonus: the
//   same function (every factor and clamp is per (row, channel); only the
//   sum over the earlier keys is regrouped), with 17 tile products per head
//   at q = 256 instead of the masked square form's 28, no triangle to
//   balance across blocks, and shared memory that does not grow with q.
// - cw is computed once per (batch, head): 256 threads, thread (segment,
//   channel) owning 16 rows of a tile; each sums its rows in f64, the
//   segment totals are added onto the channel's carry in a fixed order, and
//   each thread walks its rows again, rounding cw to f32 once per (row,
//   channel) (cw runs to about -110 at q = 256, where one f32 ulp is
//   7.6e-6, and the clamped factors carry its error relatively).
//   pw = cw - logw in f32, as in the TPU kernel. S_out needs cw_last before
//   the walk: a first pass sums logw over the chunk in f64, each thread
//   every 16th row (f32 logw; 32nd for bf16) of the channels of one 16-byte
//   column, then the partials of each channel in order.
// - Each tile's r, k, v and logw arrive as 16-byte vectors, all of a
//   thread's in flight before any is stored, when every row starts on a
//   16-byte boundary and dk = dv = 64 (the model's layout), else element by
//   element; the stored values are the same either way. The walking threads
//   form R~, K~ and the state's k exp(clip(cw_last - cw)) in place, three
//   exps per (row, channel).
// - Warps 0-3 own 16 rows each of y: the diagonal tile's scores R~ K~^T for
//   the 8-key column tiles at or below their rows (two halves of 32 keys),
//   masked s < t, then A V, then R~ M_j (64-deep). Warps 4-7 own 16 rows of
//   dk each: K^_j^T V_j, added into S_out's sum in shared memory, and
//   K~_j^T V_j, added into M once warps 0-3 have read M_j (a named
//   barrier).
// - Every product is mma.sync m16n8k8 TF32 in 3xTF32: x = hi + lo, each part
//   truncated to TF32, and a b = lo*hi + hi*lo + hi*hi (the lo*lo term is
//   under 2^-20 of the product). bf16 v is exact in TF32 (8 mantissa bits),
//   so with bf16 v the products with V take two terms. Each product is at
//   most 64 deep and starts from zero, and is then added in f32: a long
//   mma.sync chain into one accumulator truncates (PERF.md, PR 17 (a)).
// - Range: R~ lies in [2^-115, 1] |r| and K~ in [1, 2^115] |k|; the lo part
//   of a value near 2^-115 is subnormal, and the tensor cores may flush it.
//   So R~ and the state's k factor are scaled by 2^58 and K~ (and M) by
//   2^-58 when they are formed (r * (exp(.) * 2^58): the scaled factor is
//   normal, so the product rounds as the unscaled one would). A power of two
//   changes no product's bits unless it over- or underflows, and here
//   neither happens; the state's product is scaled back by 2^-58 in f32.
// - The diagonal A enters the mma from its accumulator registers: the C
//   fragment holds columns 2t, 2t+1, which serve as the A fragment's k = t
//   and t + 4 when V's rows are read in the same order. The products with V
//   read keys in that order too, and the shared tiles' row strides (68 and
//   72 floats) put every fragment load of a warp on distinct banks.
// - r, k, v, logw and y are read and written through their (batch, head,
//   token) strides, so the (B, S, H, 64) projections of the model go in at a
//   chunk offset without a copy, and y lands in the model's (B, S, H, 64)
//   buffer; the last dimension must be contiguous. u is (H, dk), broadcast
//   over the batch. S_in and S_out are contiguous (B, H, dk, dv). dk and dv
//   up to 64; tiles are zero-filled past q, dk and dv (a zero row or channel
//   adds nothing). 107 KB of shared memory a block, two blocks an SM.
// - No atomics, and every sum in one fixed order: repeated calls give
//   identical bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // warps 0-3: y; warps 4-7: the state products
constexpr int kT = 64;         // tokens per tile
constexpr int kD = 64;         // compiled head dim (dk, dv <= kD)
constexpr int kSeg = 4;        // row segments of a tile in the prefix sum
constexpr int kRows = kT / kSeg;
constexpr int kLd = kD + 4;    // row stride of the token-major tiles (floats)
constexpr int kLdM = kD + 8;   // row stride of M
constexpr float kClamp = 80.f;
constexpr float kUp = 0x1p58f;
constexpr float kDown = 0x1p-58f;

struct Smem {
  float r[kT][kLd];     // r, then R~ 2^58
  float k[kT][kLd];     // k, then K~ 2^-58
  float kh[kT][kLd];    // logw, then k exp(clip(cw_last - cw)) 2^58
  union {
    float v[kT][kLd];       // v in f32
    double pre[32][kD];     // the cw_last pass's partial sums
  };
  float m[kD][kLdM];    // M_j 2^-58
  float so[kD][kLdM];   // sum over the tiles so far of K^^T V 2^58
  double tot[kSeg][kD]; // per-segment sums of logw
  float last[kD];       // cw_last
  float u[kD];          // u of the head
  float diag[2][kT];    // sum_k r u k of the tile's rows, channels 0-31 and 32-63
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

struct Strides {  // elements: (batch, head, token) of r, k, v, logw and y
  int64_t r[3], k[3], v[3], w[3], y[3];
};

// x = hi + lo + (under 2^-20 |x|): hi is x truncated to TF32 (its top 19
// bits), lo the exact rest x - hi truncated to TF32 in turn.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;
}

// d += a b on the tensor cores (TF32 inputs, f32 accumulator).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32 for B values (b0, b1); with kExact, B is exact in TF32
// (bf16 v) and its lo term is dropped.
template <bool kExact>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  if constexpr (kExact) {
    const uint32_t b[2] = {__float_as_uint(b0), __float_as_uint(b1)};
    mma_tf32(d, al, b);
    mma_tf32(d, ah, b);
  } else {
    uint32_t bh[2], bl[2];
    split_tf32(b0, bh[0], bl[0]);
    split_tf32(b1, bh[1], bl[1]);
    mma_tf32(d, al, bh);
    mma_tf32(d, ah, bl);
    mma_tf32(d, ah, bh);
  }
}

// A fragment (rows row0 + g and + 8, columns col0 + t and + 4) of a
// token-major tile, split.
__device__ __forceinline__ void a_frag(const float (*s)[kLd], int row0, int col0, int g, int t,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split_tf32(s[row0 + g][col0 + t], ah[0], al[0]);
  split_tf32(s[row0 + g + 8][col0 + t], ah[1], al[1]);
  split_tf32(s[row0 + g][col0 + t + 4], ah[2], al[2]);
  split_tf32(s[row0 + g + 8][col0 + t + 4], ah[3], al[3]);
}

// 16-byte vectors of a (token, 64) tile: E elements each, a thread's share
// of a 64-row tile, and the vectors of one row.
template <typename T>
constexpr int kVecElems = 16 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int kVecsPerThread = kT * kD / kVecElems<T> / kThreads;
template <typename T>
constexpr int kVecsPerRow = kD / kVecElems<T>;

// The E elements at columns col .. col + E - 1 of token row `row` (when
// row < q; zeros past q and past d columns): one 16-byte load when `vec`
// (every row 16-byte aligned, d = 64), else E loads of one element.
template <typename T>
__device__ __forceinline__ uint4 fetch16(const T* base, int64_t stride, int row, int col, int q,
                                         int d, bool vec) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);  // zero bits: 0.0 in f32 and in bf16
  if (row >= q) return raw;
  const T* p = base + row * stride + col;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVecElems<T>; ++i) {
    if (col + i < d) e[i] = p[i];
  }
  return raw;
}

// A thread's vectors of rows t0 .. t0 + 63 (the loads all issued first),
// then stored to a tile in f32.
template <typename T>
struct TileFetch {
  uint4 raw[kVecsPerThread<T>];

  __device__ __forceinline__ void load(const T* base, int64_t stride, int t0, int q, int d,
                                       bool vec) {
#pragma unroll
    for (int n = 0; n < kVecsPerThread<T>; ++n) {
      const int i = threadIdx.x + kThreads * n;
      raw[n] = fetch16(base, stride, t0 + i / kVecsPerRow<T>, (i % kVecsPerRow<T>) * kVecElems<T>,
                       q, d, vec);
    }
  }
  __device__ __forceinline__ void store(float (*dst)[kLd]) const {
#pragma unroll
    for (int n = 0; n < kVecsPerThread<T>; ++n) {
      const int i = threadIdx.x + kThreads * n;
      const int row = i / kVecsPerRow<T>, col = (i % kVecsPerRow<T>) * kVecElems<T>;
      const T* e = reinterpret_cast<const T*>(&raw[n]);
#pragma unroll
      for (int j = 0; j < kVecElems<T>; j += 4) {
        *reinterpret_cast<float4*>(&dst[row][col + j]) =
            make_float4(to_f32(e[j]), to_f32(e[j + 1]), to_f32(e[j + 2]), to_f32(e[j + 3]));
      }
    }
  }
};

// Named barrier 1 over the whole block: warps 0-3 arrive once they have read
// M_j, warps 4-7 wait there before adding into M.
__device__ __forceinline__ void m_read_arrive() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
}
__device__ __forceinline__ void m_read_wait() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// out[j] (j < 16) summed over the warp's 32 lanes by four transposing steps
// (lanes keep half their values and swap the other half with lane ^ o) and
// one butterfly: lane l ends with the sum of value (l >> 1) & 15.
__device__ __forceinline__ float warp_sum16(float (&x)[kRows], int lane) {
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    const int o = 16 >> step, half = 8 >> step;
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? x[i] : x[i + half];
      const float keep = up ? x[i + half] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return x[0] + __shfl_xor_sync(0xffffffffu, x[0], 1);
}

// Products over one tile K^T V into acc (rows d0 + g, + 8 of dk; the keys in
// the order 2t, 2t + 1 of each 8-key step).
template <bool kExact>
__device__ __forceinline__ void state_product(const float (*kt)[kLd], const float (*vt)[kLd],
                                              int d0, int g, int t, float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < kT / 8; ++ks) {
    const int s0 = 8 * ks + 2 * t;
    uint32_t ah[4], al[4];
    split_tf32(kt[s0][d0 + g], ah[0], al[0]);
    split_tf32(kt[s0][d0 + g + 8], ah[1], al[1]);
    split_tf32(kt[s0 + 1][d0 + g], ah[2], al[2]);
    split_tf32(kt[s0 + 1][d0 + g + 8], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma3<kExact>(acc[nt], ah, al, vt[s0][8 * nt + g],
                                                vt[s0 + 1][8 * nt + g]);
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const TW* __restrict__ lw, const float* __restrict__ u,
                  const float* __restrict__ s0, float* __restrict__ y,
                  float* __restrict__ s_out, Strides st, int h, int q, int dk, int dv,
                  bool vec) {
  constexpr bool kExactV = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const T* rb = r + bi * st.r[0] + hi * st.r[1];
  const T* kb = k + bi * st.k[0] + hi * st.k[1];
  const T* vb = v + bi * st.v[0] + hi * st.v[1];
  const TW* wb = lw + bi * st.w[0] + hi * st.w[1];
  float* yb = y + bi * st.y[0] + hi * st.y[1];
  const float* s_in = s0 + static_cast<int64_t>(bh) * dk * dv;
  const int n_tiles = (q + kT - 1) / kT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = tid % kD, seg = tid / kD;  // prefix-sum role: channel, row segment
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates

  // ---- cw_last: logw summed over the chunk in f64, thread (residue rr,
  // vector column) summing rows rr, rr + R, ... of its E channels, eight
  // vectors in flight at a time; then the R partials of each channel in order
  constexpr int kEw = kVecElems<TW>, kVrw = kVecsPerRow<TW>, kRes = kThreads / kVrw;
  {
    const int rr = tid / kVrw, col = (tid % kVrw) * kEw;
    double acc[kEw];
#pragma unroll
    for (int e = 0; e < kEw; ++e) acc[e] = 0.0;
    for (int row0 = rr; row0 < q; row0 += 8 * kRes) {
      uint4 raw[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) raw[n] = fetch16(wb, st.w[2], row0 + kRes * n, col, q, dk, vec);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const TW* e = reinterpret_cast<const TW*>(&raw[n]);
#pragma unroll
        for (int i = 0; i < kEw; ++i) acc[i] += static_cast<double>(to_f32(e[i]));
      }
    }
#pragma unroll
    for (int e = 0; e < kEw; ++e) sm.pre[rr][col + e] = acc[e];
  }
  if (tid < kD) sm.u[tid] = tid < dk ? u[hi * dk + tid] : 0.f;
  for (int i = tid; i < kD * kD; i += kThreads) {  // M_0 = S_in 2^-58
    const int kk = i / kD, vv = i % kD;
    sm.m[kk][vv] = (kk < dk && vv < dv) ? s_in[kk * dv + vv] * kDown : 0.f;
    sm.so[kk][vv] = 0.f;
  }
  __syncthreads();
  if (tid < kD) {
    double last = 0.0;
    for (int i = 0; i < kRes; ++i) last += sm.pre[i][tid];
    sm.last[tid] = static_cast<float>(last);
  }
  __syncthreads();

  double carry = 0.0;  // the prefix sum of channel c before the tile

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = j * kT;
    const bool last_tile = j == n_tiles - 1;
    // ---- loads: every vector of the tile in flight, then stored in f32
    {
      TileFetch<TW> fw;
      TileFetch<T> fr, fk, fv;
      fw.load(wb, st.w[2], t0, q, dk, vec);
      fr.load(rb, st.r[2], t0, q, dk, vec);
      fk.load(kb, st.k[2], t0, q, dk, vec);
      fv.load(vb, st.v[2], t0, q, dv, vec);
      fw.store(sm.kh);
      fr.store(sm.r);
      fk.store(sm.k);
      fv.store(sm.v);
    }
    __syncthreads();
    // ---- the bonus's dot products and the segment totals: thread (seg, c)
    // owns rows 16 seg .. + 15 of channel c
    {
      float ruk[kRows];
      double tot = 0.0;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = seg * kRows + i;
        ruk[i] = sm.r[row][c] * sm.u[c] * sm.k[row][c];
        tot += static_cast<double>(sm.kh[row][c]);
      }
      const float dsum = warp_sum16(ruk, lane);
      if ((lane & 1) == 0) sm.diag[c / 32][seg * kRows + ((lane >> 1) & 15)] = dsum;
      sm.tot[seg][c] = tot;
    }
    __syncthreads();
    // ---- cw of the thread's rows, and R~, K~, K^ formed from it
    {
      double start = carry;
      for (int s = 0; s < seg; ++s) start += sm.tot[s][c];
      double next = start;
      for (int s = seg; s < kSeg; ++s) next += sm.tot[s][c];
      const float last = sm.last[c];
      double acc = start;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = seg * kRows + i;
        const float w = sm.kh[row][c], kr = sm.k[row][c];
        acc += static_cast<double>(w);
        const float cw = static_cast<float>(acc);
        const float pw = cw - w;
        sm.r[row][c] *= expf(clip(pw, -kClamp, 0.f)) * kUp;
        sm.k[row][c] = kr * (expf(clip(-cw, -kClamp, kClamp)) * kDown);
        sm.kh[row][c] = kr * (expf(clip(last - cw, -kClamp, 0.f)) * kUp);
      }
      carry = next;
    }
    __syncthreads();

    if (warp < 4) {
      // ---- y rows t0 + r0 .. + 15
      const int r0 = 16 * warp;
      float dacc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dacc[i][e] = 0.f;
      // the diagonal tile, A V: keys below the warp's last row, 8 at a time
      const int n_keys8 = 2 * warp + 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (4 * half >= n_keys8) break;
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll 2
        for (int ks = 0; ks < kD / 8; ++ks) {
          uint32_t ah[4], al[4];
          a_frag(sm.r, r0, 8 * ks, g, t, ah, al);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kn = 4 * half + i;
            if (kn < n_keys8) {
              mma3<false>(sc[i], ah, al, sm.k[8 * kn + g][8 * ks + t],
                          sm.k[8 * kn + g][8 * ks + t + 4]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kn = 4 * half + i;
          if (kn < n_keys8) {
            const int key = 8 * kn + 2 * t, ra = r0 + g, rb2 = r0 + g + 8;
            // C (ra, key), (ra, key+1), (rb2, key), (rb2, key+1) as the A
            // fragment's (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
            const float a0 = key < ra ? sc[i][0] : 0.f;
            const float a2 = key + 1 < ra ? sc[i][1] : 0.f;
            const float a1 = key < rb2 ? sc[i][2] : 0.f;
            const float a3 = key + 1 < rb2 ? sc[i][3] : 0.f;
            uint32_t ah[4], al[4];
            split_tf32(a0, ah[0], al[0]);
            split_tf32(a1, ah[1], al[1]);
            split_tf32(a2, ah[2], al[2]);
            split_tf32(a3, ah[3], al[3]);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              mma3<kExactV>(dacc[nt], ah, al, sm.v[key][8 * nt + g], sm.v[key + 1][8 * nt + g]);
            }
          }
        }
      }
      // R~ M_j: the inter-chunk state and every earlier tile
      float yacc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[i][e] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < kD / 8; ++ks) {
        uint32_t ah[4], al[4];
        a_frag(sm.r, r0, 8 * ks, g, t, ah, al);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          mma3<false>(yacc[nt], ah, al, sm.m[8 * ks + t][8 * nt + g],
                      sm.m[8 * ks + t + 4][8 * nt + g]);
        }
      }
      m_read_arrive();
      // y = (R~ M_j + A V) + bonus * v
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + (e >= 2 ? 8 : 0);
        const int tt = t0 + row;
        if (tt >= q) continue;
        const float bonus = sm.diag[0][row] + sm.diag[1][row];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = 8 * nt + 2 * t + (e & 1);
          if (col < dv) {
            yb[tt * st.y[2] + col] = (yacc[nt][e] + dacc[nt][e]) + bonus * sm.v[row][col];
          }
        }
      }
    } else {
      // ---- the state products of dk rows d0 .. + 15
      const int d0 = 16 * (warp - 4);
      float acc[8][4];
      state_product<kExactV>(sm.kh, sm.v, d0, g, t, acc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sm.so[d0 + g + (e >= 2 ? 8 : 0)][8 * nt + 2 * t + (e & 1)] += acc[nt][e];
        }
      if (!last_tile) state_product<kExactV>(sm.k, sm.v, d0, g, t, acc);
      m_read_wait();
      if (!last_tile) {  // M_{j+1} = M_j + K~_j^T V_j
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sm.m[d0 + g + (e >= 2 ? 8 : 0)][8 * nt + 2 * t + (e & 1)] += acc[nt][e];
          }
      }
    }
    __syncthreads();
  }

  if (warp >= 4) {  // S_out = S_in exp(clip(cw_last)) + 2^-58 sum K^^T V
    const int d0 = 16 * (warp - 4);
    float* so = s_out + static_cast<int64_t>(bh) * dk * dv;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = d0 + g + (e >= 2 ? 8 : 0);
      if (kk >= dk) continue;
      const float decay = expf(clip(sm.last[kk], -kClamp, 0.f));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int vv = 8 * nt + 2 * t + (e & 1);
        if (vv < dv) so[kk * dv + vv] = s_in[kk * dv + vv] * decay + sm.so[kk][vv] * kDown;
      }
    }
  }
}

// Every row of r, k, v and logw starts on a 16-byte boundary, and dk = dv =
// 64: the tiles load as 16-byte vectors.
bool aligned16(const void* p, const int64_t (&s)[3], int esize) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int64_t x : s) {
    if ((x * esize) % 16 != 0) return false;
  }
  return true;
}

template <typename T, typename TW>
cudaError_t launch(const void* r, const void* k, const void* v, const void* lw, const float* u,
                   const float* s0, float* y, float* s_out, const Strides& st, int b, int h,
                   int q, int dk, int dv, cudaStream_t stream) {
  const int es = static_cast<int>(sizeof(T));
  const bool vec = dk == kD && dv == kD && aligned16(r, st.r, es) && aligned16(k, st.k, es) &&
                   aligned16(v, st.v, es) && aligned16(lw, st.w, static_cast<int>(sizeof(TW)));
  auto kern = wkv6_chunk_kernel<T, TW>;
  constexpr int kSmemBytes = static_cast<int>(sizeof(Smem));
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(b) * static_cast<unsigned>(h), kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(lw), u, s0, y, s_out, st, h, q, dk, dv, vec);
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
