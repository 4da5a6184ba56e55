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
//   MB of u, both from L2). A random read through `perm` on every call kept
//   the first version of this kernel at 7% of its bound.
// - The copies are made once per state (see the record gather below) and
//   never gathered again: the residual changes once
//   per epoch by an elementwise step (update_resid_kernel, below), which
//   writes it in caller order and in each sorted order from the state's
//   values and weights kept in that order, with sequential reads. Its bound
//   is bytes: 24 an entry in caller order (rows, cols, resid, vals, weight
//   read, resid' written) and 20 in each sorted order (the gather index in
//   place of rows and cols; the segment's factor is one read a piece), 64 in
//   all, 6.4 GB at the Netflix shapes, 1.9 ms; u and v are gathered from L2.
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

// The record gather: the sorted copies dst_f[k] = src_f[perm[k]] of F
// caller-order 4-byte fields (f32 or int32 words; a state's residual,
// values, weights and the order's gather index) for one order.
//
// Bound: bytes, but the reads through perm are random: each lands in its own
// 32-byte sector of an array far larger than L2, so a random sector costs
// what 32 bytes do whatever is used of it. Gathering the fields one at a time
// paid that sector once per field (four per entry per order); here a first,
// sequential pass packs each entry's fields into one 16-byte record in caller
// order (records[i] = {src_0[i], ..., src_{F-1}[i]}), and the gather fetches
// an entry's whole record with one 16-byte load: one random sector per entry,
// plus the perm and the stores, both sequential. Each thread takes four sorted
// entries: one 16-byte load of perm, four record loads in flight, and one
// 16-byte store per field (the four entries' words of that field). The
// records are scratch of 16 bytes an entry (the caller's), used for one order
// and freed by the caller. A copy's bits; no atomics. With F = 1 there is
// nothing to pack: the gather reads the field itself.
struct Fields {
  const uint32_t* src[4];
  uint32_t* dst[4];
};

template <int F>
__global__ void __launch_bounds__(kThreads)
pack_records_kernel(Fields f, uint4* __restrict__ records, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < F; ++j) w[j] = __ldcs(f.src[j] + i);
  records[i] = make_uint4(w[0], w[1], w[2], w[3]);
}

// Four sorted entries a thread (16-byte loads of perm and stores of each
// field where `vec`; a scalar path for the tail and unaligned arrays).
template <int F>
__global__ void __launch_bounds__(kThreads)
gather_records_kernel(const int32_t* __restrict__ perm, const uint4* __restrict__ records,
                      Fields f, int64_t n, int vec) {
  const int64_t k = 4 * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (k >= n) return;
  if (vec && k + 4 <= n) {
    const int4 idx = __ldcs(reinterpret_cast<const int4*>(perm + k));
    const uint4 a = __ldg(records + idx.x);
    const uint4 b = __ldg(records + idx.y);
    const uint4 c = __ldg(records + idx.z);
    const uint4 d = __ldg(records + idx.w);
    __stcs(reinterpret_cast<uint4*>(f.dst[0] + k), make_uint4(a.x, b.x, c.x, d.x));
    if (F > 1) __stcs(reinterpret_cast<uint4*>(f.dst[1] + k), make_uint4(a.y, b.y, c.y, d.y));
    if (F > 2) __stcs(reinterpret_cast<uint4*>(f.dst[2] + k), make_uint4(a.z, b.z, c.z, d.z));
    if (F > 3) __stcs(reinterpret_cast<uint4*>(f.dst[3] + k), make_uint4(a.w, b.w, c.w, d.w));
  } else {
    for (int64_t j = k; j < n && j < k + 4; ++j) {
      const uint4 r = __ldg(records + __ldcs(perm + j));
      f.dst[0][j] = r.x;
      if (F > 1) f.dst[1][j] = r.y;
      if (F > 2) f.dst[2][j] = r.z;
      if (F > 3) f.dst[3][j] = r.w;
    }
  }
}

// F = 1: dst[k] = src[perm[k]], four entries a thread, as above.
__global__ void __launch_bounds__(kThreads)
gather_word_kernel(const int32_t* __restrict__ perm, const uint32_t* __restrict__ src,
                   uint32_t* __restrict__ dst, int64_t n, int vec) {
  const int64_t k = 4 * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (k >= n) return;
  if (vec && k + 4 <= n) {
    const int4 idx = __ldcs(reinterpret_cast<const int4*>(perm + k));
    __stcs(reinterpret_cast<uint4*>(dst + k),
           make_uint4(__ldg(src + idx.x), __ldg(src + idx.y), __ldg(src + idx.z),
                      __ldg(src + idx.w)));
  } else {
    for (int64_t j = k; j < n && j < k + 4; ++j) dst[j] = __ldg(src + __ldcs(perm + j));
  }
}

template <int F>
cudaError_t launch_record_gather(const int32_t* perm, const Fields& f, uint4* records, int64_t n,
                                 int vec, cudaStream_t s) {
  pack_records_kernel<F><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                           s>>>(f, records, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gather_records_kernel<F><<<static_cast<unsigned>((n + 4 * kThreads - 1) / (4 * kThreads)),
                             kThreads, 0, s>>>(perm, records, f, n, vec);
  return cudaGetLastError();
}

// One order's sorted copies for update_resid_kernel. Piece j covers sorted
// positions piece_start[j]:piece_end[j] of segment piece_seg[j]; the entry
// at sorted position k has x_seg[piece_seg[j]] and x_gat[gat[k]] as its two
// factors (the row order: u by row, v by column; the column order: v by
// column, u by row).
struct SortedResid {
  const int32_t* gat;
  const int64_t* piece_start;
  const int64_t* piece_end;
  const int64_t* piece_seg;
  const float* resid;
  const float* vals;
  const float* weight;
  const float* x_seg;
  const float* x_gat;
  float* out;
  int64_t num_pieces;
};

// MatrixCompletion.update's chain, each operation rounded on its own, in
// the chain's order (no FMA contraction): the plain version's bits.
//   resid' = ((1 - g) resid - (g w) vals) - (g mu) (w (x_a x_b))
__device__ __forceinline__ float resid_step(float omg, float g, float gmu, float resid, float val,
                                            float w, float xa, float xb) {
  const float uv = __fmul_rn(w, __fmul_rn(xa, xb));
  const float keep = __fmul_rn(omg, resid);
  const float pull = __fmul_rn(__fmul_rn(g, w), val);
  return __fsub_rn(__fsub_rn(keep, pull), __fmul_rn(gmu, uv));
}

// The new residual in caller order (blocks [0, caller_blocks), four entries
// a thread, 16-byte loads and stores where `vec`), then in the row order
// (the next row.num_pieces / 8 blocks) and the column order (the rest), a
// warp per piece. gamma is read on the device (no host sync); 1 - g and
// g * mu are formed as the chain forms them in f32.
__global__ void __launch_bounds__(kThreads)
update_resid_kernel(const float* __restrict__ gamma, float mu, const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ cols, const float* __restrict__ resid,
                    const float* __restrict__ vals, const float* __restrict__ weight,
                    const float* __restrict__ u, const float* __restrict__ v,
                    float* __restrict__ out, int64_t p, int vec, int64_t caller_blocks,
                    SortedResid row, int64_t row_blocks, SortedResid col) {
  const float g = __ldg(gamma);
  const float omg = __fsub_rn(1.f, g);
  const float gmu = __fmul_rn(g, mu);
  int64_t blk = blockIdx.x;
  if (blk < caller_blocks) {
    const int64_t k = 4 * (blk * kThreads + threadIdx.x);
    if (k >= p) return;
    if (vec && k + 4 <= p) {
      const int4 r = __ldcs(reinterpret_cast<const int4*>(rows + k));
      const int4 c = __ldcs(reinterpret_cast<const int4*>(cols + k));
      const float4 re = __ldcs(reinterpret_cast<const float4*>(resid + k));
      const float4 va = __ldcs(reinterpret_cast<const float4*>(vals + k));
      const float4 w = __ldcs(reinterpret_cast<const float4*>(weight + k));
      float4 o;
      o.x = resid_step(omg, g, gmu, re.x, va.x, w.x, __ldg(u + r.x), __ldg(v + c.x));
      o.y = resid_step(omg, g, gmu, re.y, va.y, w.y, __ldg(u + r.y), __ldg(v + c.y));
      o.z = resid_step(omg, g, gmu, re.z, va.z, w.z, __ldg(u + r.z), __ldg(v + c.z));
      o.w = resid_step(omg, g, gmu, re.w, va.w, w.w, __ldg(u + r.w), __ldg(v + c.w));
      __stcs(reinterpret_cast<float4*>(out + k), o);
    } else {
      for (int64_t j = k; j < p && j < k + 4; ++j) {
        out[j] = resid_step(omg, g, gmu, __ldcs(resid + j), __ldcs(vals + j), __ldcs(weight + j),
                            __ldg(u + __ldcs(rows + j)), __ldg(v + __ldcs(cols + j)));
      }
    }
    return;
  }
  blk -= caller_blocks;
  const bool by_row = blk < row_blocks;
  const SortedResid o = by_row ? row : col;
  const int64_t piece = (by_row ? blk : blk - row_blocks) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (piece >= o.num_pieces) return;
  const float xs = __ldg(o.x_seg + o.piece_seg[piece]);
  const int64_t end = o.piece_end[piece];
#pragma unroll 4
  for (int64_t k = o.piece_start[piece] + threadIdx.x % kWarp; k < end; k += kWarp) {
    const float xg = __ldg(o.x_gat + __ldcs(o.gat + k));
    __stcs(o.out + k, resid_step(omg, g, gmu, __ldcs(o.resid + k), __ldcs(o.vals + k),
                                 __ldcs(o.weight + k), xs, xg));
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

// dst_f (n,) = src_f[perm] for the first `fields` (1 to 4) of src and dst,
// 4-byte words each; records is (n,) 16-byte scratch, unused for one field.
// n >= 1.
int mc_gather_sorted(const int32_t* perm, int fields, const void* s0, const void* s1,
                     const void* s2, const void* s3, void* d0, void* d1, void* d2, void* d3,
                     void* records, int64_t n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fields < 1 || fields > 4) return static_cast<int>(cudaErrorInvalidValue);
  const Fields f{{static_cast<const uint32_t*>(s0), static_cast<const uint32_t*>(s1),
                  static_cast<const uint32_t*>(s2), static_cast<const uint32_t*>(s3)},
                 {static_cast<uint32_t*>(d0), static_cast<uint32_t*>(d1),
                  static_cast<uint32_t*>(d2), static_cast<uint32_t*>(d3)}};
  uintptr_t align = reinterpret_cast<uintptr_t>(perm);
  for (int j = 0; j < fields; ++j) align |= reinterpret_cast<uintptr_t>(f.dst[j]);
  const int vec = align % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* rec = static_cast<uint4*>(records);
  switch (fields) {
    case 1:
      gather_word_kernel<<<static_cast<unsigned>((n + 4 * kThreads - 1) / (4 * kThreads)),
                           kThreads, 0, s>>>(perm, f.src[0], f.dst[0], n, vec);
      err = cudaGetLastError();
      break;
    case 2: err = launch_record_gather<2>(perm, f, rec, n, vec, s); break;
    case 3: err = launch_record_gather<3>(perm, f, rec, n, vec, s); break;
    default: err = launch_record_gather<4>(perm, f, rec, n, vec, s); break;
  }
  return static_cast<int>(err);
}

// The matrix-completion residual after a step: out (p,) in caller order from
// rows, cols, resid, vals, weight; and, for each order with pieces, its
// out_sorted from the copies in that order (see SortedResid). gamma is a
// device pointer to one f32; mu is already f32. p >= 1.
int mc_update_resid_f32(const float* gamma, float mu, const int32_t* rows, const int32_t* cols,
                        const float* resid, const float* vals, const float* weight,
                        const float* u, const float* v, float* out, int64_t p,
                        const int32_t* r_gat, const int64_t* r_start, const int64_t* r_end,
                        const int64_t* r_seg, const float* r_resid, const float* r_vals,
                        const float* r_weight, float* r_out, int64_t r_pieces,
                        const int32_t* c_gat, const int64_t* c_start, const int64_t* c_end,
                        const int64_t* c_seg, const float* c_resid, const float* c_vals,
                        const float* c_weight, float* c_out, int64_t c_pieces, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(cols) |
                   reinterpret_cast<uintptr_t>(resid) | reinterpret_cast<uintptr_t>(vals) |
                   reinterpret_cast<uintptr_t>(weight) | reinterpret_cast<uintptr_t>(out)) %
                      16 == 0;
  const SortedResid row{r_gat, r_start, r_end, r_seg, r_resid, r_vals, r_weight, u, v, r_out,
                        r_pieces};
  const SortedResid col{c_gat, c_start, c_end, c_seg, c_resid, c_vals, c_weight, v, u, c_out,
                        c_pieces};
  const int64_t caller_blocks = (p + 4 * kThreads - 1) / (4 * kThreads);
  const int64_t row_blocks = (r_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t col_blocks = (c_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  update_resid_kernel<<<static_cast<unsigned>(caller_blocks + row_blocks + col_blocks), kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
      gamma, mu, rows, cols, resid, vals, weight, u, v, out, p, vec, caller_blocks, row,
      row_blocks, col);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
