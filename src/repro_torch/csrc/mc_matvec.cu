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
//
// Block forms for the block:k solver, on the same orders and pieces:
// - coo_matmat: out[seg_e, :] += vals_e * X[gat_e, :] with X (in_dim, k)
//   row-major (the reference vmaps coo_matvec over the k columns); k > 32 in
//   groups of 32 columns, one pass over the entries each.
//   Association (fixed, no atomics): for each (piece, column) the rounded
//   products added in the piece's sorted order from 0, then a segment's
//   pieces added in order from 0 (ref.coo_matmat_chain gives its bits). Only
//   the order of the adds fixes the bits, so the loads run ahead of them.
//   Bound: bytes, 8 per entry (gat, val) plus X and out once, 0.245 ms at the
//   Netflix shapes and k = 8. But each entry also gathers its X row, one
//   random 32-byte L2 sector at k = 8 (V, 0.6 MB, and U, 15 MB, both stay in
//   L2), 100 M sectors a call, and an H100 80GB HBM3 at 700 W serves about
//   136-152 G random sectors a second (tools/torch_gather_probe.py): that
//   gather is the floor.
//   Design: a group of G lanes takes a piece, each lane V columns: V = 4 (one
//   16-byte load of the row's slice) where k % 4 == 0 and X is 16-byte
//   aligned, else V = 1; so at k = 8 two lanes a piece and sixteen pieces a
//   warp, at k = 32 eight and four, and every lane works (a warp along k
//   would idle 24 of its lanes at k = 8). A warp walks a run of pieces and
//   each group takes the next one as soon as it finishes the last (a
//   warp-wide ballot; no atomics), so a long user or movie does not idle the
//   warp's other groups. A step takes 8 (at least G) entries of the piece:
//   each lane loads its share of their (gat, val) pairs (16 bytes at a time
//   where it takes 4 or more and both arrays are aligned: the step's window
//   then starts on a multiple of 4), the group passes them round by
//   shuffles, and every X-row load of the step is issued before its adds. A
//   segment of one piece (almost every user: a mean of 209 ratings against a
//   piece of 1024) is written by its piece; only segments of several pieces
//   go through `partial` and stage 2.
// - update_resid with block factors: the dot sum_j u[row, j] v[col, j] in
//   place of u[row] v[col], in ascending j (the first product, then each
//   rounded product added), then resid_step_dot's chain: the same chain in
//   all three orders, so each order has the caller order's bits. Bound:
//   bytes, 64 an entry in the three orders (24 in the caller order alone);
//   the floor adds the random factor rows: at k = 8 four 32-byte sectors an
//   entry over the three orders (u's and v's rows in the caller order, the
//   other factor's row in each sorted order), two in the caller order
//   alone. Design: the caller order takes four consecutive entries a
//   thread (16-byte loads of rows, cols, resid, vals, weight and a 16-byte
//   streaming store where aligned) and gathers both factor rows of all four
//   a tile of 8 columns at a time (16-byte loads where k % 4 == 0 and the
//   factors are aligned, else 4-byte), all of a tile's loads issued before
//   its chains. A sorted order gives a warp a piece: the piece's segment row
//   is read once into registers (k <= 32; past that a tile at a time, once
//   a step), each lane takes four entries a step (positions 32 apart, so
//   each warp load and store is 128 contiguous bytes) and gathers only the
//   other factor's row.
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
__device__ __forceinline__ float resid_step_dot(float omg, float g, float gmu, float resid,
                                                float val, float w, float dot) {
  const float uv = __fmul_rn(w, dot);
  const float keep = __fmul_rn(omg, resid);
  const float pull = __fmul_rn(__fmul_rn(g, w), val);
  return __fsub_rn(__fsub_rn(keep, pull), __fmul_rn(gmu, uv));
}

__device__ __forceinline__ float resid_step(float omg, float g, float gmu, float resid, float val,
                                            float w, float xa, float xb) {
  return resid_step_dot(omg, g, gmu, resid, val, w, __fmul_rn(xa, xb));
}

// The new residual in caller order (blocks [0, caller_blocks), four entries
// a thread, 16-byte loads and stores where `vec`), then in the row order
// (the next row.num_pieces / 8 blocks) and the column order (the rest), a
// warp per piece. gamma is read on the device (no host sync); 1 - g and
// g * mu are formed as the chain forms them in f32. Each order's residual
// and its output may be one array (the fits update in place): an entry is
// read by the thread that writes it, before the store, so neither pointer
// is __restrict__ (nor the SortedResid ones).
__global__ void __launch_bounds__(kThreads)
update_resid_kernel(const float* __restrict__ gamma, float mu, const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ cols, const float* resid,
                    const float* __restrict__ vals, const float* __restrict__ weight,
                    const float* __restrict__ u, const float* __restrict__ v,
                    float* out, int64_t p, int vec, int64_t caller_blocks,
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

// ---------------------------------------------------------------------------
// Block forms
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
// Warps resident on one H100 (132 SMs x 64), and the most pieces a warp walks.
constexpr int64_t kResidentWarps = 132 * 64;
constexpr int64_t kMaxPiecesPerWarp = 32;

// coo_matmat's operands (see mc_coo_matmat_f32): the order's sorted gather
// index and values, X (in_dim, k) row-major, the pieces, the (pieces, k)
// scratch and the (out_dim, k) output.
struct CooBlock {
  const int32_t* gat;
  const float* vals;
  const float* x;
  const int64_t* piece_start;
  const int64_t* piece_end;
  const int64_t* piece_seg;
  const int64_t* piece_ptr;
  float* partial;
  float* out;
  int64_t num_pieces;
  int64_t k;
};

// V consecutive columns of a row: one 4-byte or one 16-byte access.
__device__ __forceinline__ void load_cols(const float* p, float (&c)[1]) { c[0] = __ldg(p); }
__device__ __forceinline__ void load_cols(const float* p, float (&c)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  c[0] = t.x;
  c[1] = t.y;
  c[2] = t.z;
  c[3] = t.w;
}
__device__ __forceinline__ void store_cols(float* p, const float (&c)[1]) { *p = c[0]; }
__device__ __forceinline__ void store_cols(float* p, const float (&c)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(c[0], c[1], c[2], c[3]);
}

// Stage 1 of coo_matmat, columns col0 .. col0 + kc: for each piece, its
// entries' products vals_e * X[gat_e, c] added in sorted order from 0 (each
// product rounded, then added). A group of G lanes takes one piece at a time,
// lane s its V columns col0 + s V .. + V (live while s V < kc); a warp's
// 32 / G groups walk the warp's `per_warp` pieces, each group taking the
// next one as it finishes the last, so one long piece does not idle the
// others. A step takes E = max(G, 8) entries of the group's piece: each lane
// loads E / G of their (gat, val) pairs, the group passes them round by
// shuffles, every X-row load of the step is issued before its adds. A piece
// that is its segment's only one writes out (as stage 2 would: 0 + the sum);
// the others write partial[piece].
template <int G, int V>
__global__ void __launch_bounds__(kThreads)
piece_sum_block_kernel(CooBlock a, int col0, int kc, int per_warp, int quad) {
  constexpr int kGroups = kWarp / G;
  constexpr int E = G < 8 ? 8 : G;
  constexpr int L = E / G;
  // a lane's L entries as 16-byte loads of gat and vals (where `quad`: both
  // 16-byte aligned), the step's window starting on a multiple of 4
  constexpr bool kQuad = L % 4 == 0;
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % G;
  const int lead = lane - sub;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp) * per_warp;
  if (first >= a.num_pieces) return;  // whole warp leaves together
  const int64_t last = first + per_warp < a.num_pieces ? first + per_warp : a.num_pieces;
  const int64_t col = col0 + sub * V;
  const bool live = sub * V < kc;
  int64_t next = first + kGroups;
  int64_t piece = first + lane / G;
  // the piece's entries are start .. end; a step takes positions base .. base + E
  int64_t start = 0, end = 0, base = 0;
  if (piece < last) {
    start = a.piece_start[piece];
    end = a.piece_end[piece];
    base = kQuad ? start & ~int64_t{3} : start;
  } else {
    piece = -1;
  }
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.f;
  while (__any_sync(kFull, piece >= 0)) {
    // lane sub holds positions base + sub L .. + L
    int32_t gl[L];
    float vl[L];
    const int64_t e0 = base + sub * L;
    if (kQuad && quad) {
#pragma unroll
      for (int q = 0; q < L; q += 4) {
        const bool in = e0 + q < end;  // a quad past the piece is not read
        const int4 g4 = in ? __ldcs(reinterpret_cast<const int4*>(a.gat + e0 + q))
                           : make_int4(0, 0, 0, 0);
        const float4 v4 = in ? __ldcs(reinterpret_cast<const float4*>(a.vals + e0 + q))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        gl[q] = g4.x, gl[q + 1] = g4.y, gl[q + 2] = g4.z, gl[q + 3] = g4.w;
        vl[q] = v4.x, vl[q + 1] = v4.y, vl[q + 2] = v4.z, vl[q + 3] = v4.w;
      }
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int64_t e = e0 + l;
        const bool in = e >= start && e < end;
        gl[l] = in ? __ldcs(a.gat + e) : 0;
        vl[l] = in ? __ldcs(a.vals + e) : 0.f;
      }
    }
    // window positions lo .. hi hold the piece's entries (hi <= lo for an idle group)
    const int64_t lo64 = start - base, hi64 = end - base;
    const int lo = lo64 > 0 ? static_cast<int>(lo64) : 0;
    const int hi = hi64 < E ? static_cast<int>(hi64) : E;
    float xv[E][V];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int32_t gi = G == 1 ? gl[i] : __shfl_sync(kFull, gl[i % L], i / L, G);
      if (live && i >= lo && i < hi)
        load_cols(a.x + static_cast<int64_t>(gi) * a.k + col, xv[i]);
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float vi = G == 1 ? vl[i] : __shfl_sync(kFull, vl[i % L], i / L, G);
      if (live && i >= lo && i < hi) {
#pragma unroll
        for (int c = 0; c < V; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(vi, xv[i][c]));
      }
    }
    base += E;
    const bool done = piece >= 0 && base >= end;
    if (done && live) {
      const int64_t seg = a.piece_seg[piece];
      if (a.piece_ptr[seg + 1] - a.piece_ptr[seg] == 1) {
        float o[V];
#pragma unroll
        for (int c = 0; c < V; ++c) o[c] = __fadd_rn(0.f, acc[c]);
        store_cols(a.out + seg * a.k + col, o);
      } else {
        store_cols(a.partial + piece * a.k + col, acc);
      }
    }
    const unsigned fin = __ballot_sync(kFull, done && sub == 0);
    if (done) {
      piece = next + __popc(fin & ((1u << lead) - 1u));
      if (piece < last) {
        start = a.piece_start[piece];
        end = a.piece_end[piece];
        base = kQuad ? start & ~int64_t{3} : start;
      } else {
        piece = -1;
        start = end = base = 0;
      }
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c] = 0.f;
    }
    next += __popc(fin);
  }
}

// Stage 2: out[seg, col0 + c] = its pieces' partials added in order from 0
// (0 for an empty segment); a segment of one piece was written by stage 1.
__global__ void __launch_bounds__(kThreads)
segment_sum_block_kernel(const float* __restrict__ partial, const int64_t* __restrict__ piece_ptr,
                         float* __restrict__ out, int64_t out_dim, int64_t k, int col0, int kc) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= out_dim * kc) return;
  const int64_t seg = i / kc;
  const int64_t col = col0 + i % kc;
  const int64_t lo = piece_ptr[seg], end = piece_ptr[seg + 1];
  if (end - lo == 1) return;
  float acc = 0.f;
  for (int64_t j = lo; j < end; ++j) acc = __fadd_rn(acc, partial[j * k + col]);
  out[seg * k + col] = acc;
}

// Stage 1 with `group` lanes a piece (a power of 2), V columns a lane.
template <int V>
cudaError_t launch_piece_sum(int group, const CooBlock& a, int col0, int kc, int per_warp,
                             int quad, unsigned blocks, cudaStream_t s) {
  switch (group) {
    case 1:
      piece_sum_block_kernel<1, V><<<blocks, kThreads, 0, s>>>(a, col0, kc, per_warp, quad);
      break;
    case 2:
      piece_sum_block_kernel<2, V><<<blocks, kThreads, 0, s>>>(a, col0, kc, per_warp, quad);
      break;
    case 4:
      piece_sum_block_kernel<4, V><<<blocks, kThreads, 0, s>>>(a, col0, kc, per_warp, quad);
      break;
    case 8:
      piece_sum_block_kernel<8, V><<<blocks, kThreads, 0, s>>>(a, col0, kc, per_warp, quad);
      break;
    default:  // 16-byte lanes take at most 8 lanes a piece
      if constexpr (V == 1) {
        if (group == 16)
          piece_sum_block_kernel<16, V><<<blocks, kThreads, 0, s>>>(a, col0, kc, per_warp, quad);
        else
          piece_sum_block_kernel<32, V><<<blocks, kThreads, 0, s>>>(a, col0, kc, per_warp, quad);
      }
      break;
  }
  return cudaGetLastError();
}

// The block update: entries a thread in the caller order (a multiple of 4),
// entries a lane per step in a sorted order, and the factor columns loaded
// at once (a tile).
constexpr int kCallerBatch = 4;
constexpr int kSortedBatch = 4;
constexpr int kTile = 8;
// A segment row of at most this many columns stays in registers.
constexpr int kSegRegs = 32;

// Columns j0 .. j0 + kTile of a factor row, zeros past k: 16-byte loads where
// V (k % 4 == 0 and the factor 16-byte aligned), else 4-byte loads.
template <bool V>
__device__ __forceinline__ void load_tile(const float* __restrict__ row, int64_t j0, int64_t k,
                                          float (&t)[kTile]) {
  if (V) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(row + j0));
    const float4 hi = j0 + kTile <= k ? __ldg(reinterpret_cast<const float4*>(row + j0 + 4))
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    t[0] = lo.x, t[1] = lo.y, t[2] = lo.z, t[3] = lo.w;
    t[4] = hi.x, t[5] = hi.y, t[6] = hi.z, t[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < kTile; ++j) t[j] = j0 + j < k ? __ldg(row + j0 + j) : 0.f;
  }
}

// load_tile for an entry of a sorted order's step; zeros (no load) for a
// position past the piece.
template <bool V>
__device__ __forceinline__ void load_gat_tile(bool in, const float* __restrict__ row, int64_t j0,
                                              int64_t k, float (&t)[kTile]) {
  if (in) {
    load_tile<V>(row, j0, k, t);
  } else {
#pragma unroll
    for (int j = 0; j < kTile; ++j) t[j] = 0.f;
  }
}

// dot = sum_j a[j] b[j] over one tile's columns j0 + j < k, continuing the
// chain in ascending j: the first product is the start, each later one is
// rounded and then added.
__device__ __forceinline__ void dot_tile(const float (&a)[kTile], const float (&b)[kTile],
                                         int64_t j0, int64_t k, float& dot) {
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (j0 + j < k) {
      const float p = __fmul_rn(a[j], b[j]);
      dot = j0 + j == 0 ? p : __fadd_rn(dot, p);
    }
  }
}

// The caller order: kCallerBatch consecutive entries a thread (16-byte loads of
// rows, cols, resid, vals, weight and a 16-byte streaming store where `vec`),
// both factor rows of every entry gathered a tile at a time, each tile's
// gathers issued before its chains.
template <bool V>
__device__ __forceinline__ void update_caller_block(
    int64_t blk, float omg, float g, float gmu, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ cols, const float* resid,
    const float* __restrict__ vals, const float* __restrict__ weight, const float* __restrict__ u,
    const float* __restrict__ v, float* out, int64_t p, int64_t k, int vec) {
  constexpr int B = kCallerBatch;
  const int64_t e0 = B * (blk * kThreads + threadIdx.x);
  if (e0 >= p) return;
  const bool full = vec && e0 + B <= p;
  int32_t r[B], c[B];
  float re[B], va[B], w[B];
  if (full) {
#pragma unroll
    for (int q = 0; q < B; q += 4) {
      const int4 r4 = __ldcs(reinterpret_cast<const int4*>(rows + e0 + q));
      const int4 c4 = __ldcs(reinterpret_cast<const int4*>(cols + e0 + q));
      const float4 re4 = __ldcs(reinterpret_cast<const float4*>(resid + e0 + q));
      const float4 va4 = __ldcs(reinterpret_cast<const float4*>(vals + e0 + q));
      const float4 w4 = __ldcs(reinterpret_cast<const float4*>(weight + e0 + q));
      r[q] = r4.x, r[q + 1] = r4.y, r[q + 2] = r4.z, r[q + 3] = r4.w;
      c[q] = c4.x, c[q + 1] = c4.y, c[q + 2] = c4.z, c[q + 3] = c4.w;
      re[q] = re4.x, re[q + 1] = re4.y, re[q + 2] = re4.z, re[q + 3] = re4.w;
      va[q] = va4.x, va[q + 1] = va4.y, va[q + 2] = va4.z, va[q + 3] = va4.w;
      w[q] = w4.x, w[q + 1] = w4.y, w[q + 2] = w4.z, w[q + 3] = w4.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const bool in = e0 + i < p;  // past p: row and column 0, never stored
      r[i] = in ? __ldcs(rows + e0 + i) : 0;
      c[i] = in ? __ldcs(cols + e0 + i) : 0;
      re[i] = in ? __ldcs(resid + e0 + i) : 0.f;
      va[i] = in ? __ldcs(vals + e0 + i) : 0.f;
      w[i] = in ? __ldcs(weight + e0 + i) : 0.f;
    }
  }
  float dot[B];
  for (int64_t j0 = 0; j0 < k; j0 += kTile) {
    float ta[B][kTile], tb[B][kTile];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      load_tile<V>(u + static_cast<int64_t>(r[i]) * k, j0, k, ta[i]);
      load_tile<V>(v + static_cast<int64_t>(c[i]) * k, j0, k, tb[i]);
    }
#pragma unroll
    for (int i = 0; i < B; ++i) dot_tile(ta[i], tb[i], j0, k, dot[i]);
  }
  float o[B];
#pragma unroll
  for (int i = 0; i < B; ++i) o[i] = resid_step_dot(omg, g, gmu, re[i], va[i], w[i], dot[i]);
  if (full) {
#pragma unroll
    for (int q = 0; q < B; q += 4)
      __stcs(reinterpret_cast<float4*>(out + e0 + q),
             make_float4(o[q], o[q + 1], o[q + 2], o[q + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < B; ++i)
      if (e0 + i < p) __stcs(out + e0 + i, o[i]);
  }
}

// A sorted order, a warp per piece: the piece's segment row (x_seg) is read
// once into registers (R: k <= kSegRegs; else a tile at a time from L1, once
// per step), then each lane takes kSortedBatch entries a step (positions lane,
// lane + 32, ...: every load of gat, resid, vals, weight and every store
// covers 128 contiguous bytes a warp) and gathers only the other factor's row
// of each, a tile at a time, each tile's gathers issued before its chains.
template <bool V, bool R>
__device__ __forceinline__ void update_sorted_piece(const SortedResid& o, int64_t piece,
                                                    float omg, float g, float gmu, int64_t k) {
  constexpr int kRegTiles = R ? kSegRegs / kTile : 1;
  const int lane = threadIdx.x % kWarp;
  const float* xs = o.x_seg + o.piece_seg[piece] * k;
  float seg[kRegTiles][kTile];
  if (R) {
#pragma unroll
    for (int t = 0; t < kRegTiles; ++t)
      if (t * kTile < k) load_tile<V>(xs, t * kTile, k, seg[t]);
  }
  const int64_t end = o.piece_end[piece];
  for (int64_t e0 = o.piece_start[piece] + lane; e0 < end; e0 += kWarp * kSortedBatch) {
    const float* xg[kSortedBatch];
    bool in[kSortedBatch];
    float re[kSortedBatch], va[kSortedBatch], w[kSortedBatch];
#pragma unroll
    for (int i = 0; i < kSortedBatch; ++i) {
      const int64_t e = e0 + kWarp * i;
      in[i] = e < end;
      xg[i] = o.x_gat + static_cast<int64_t>(in[i] ? __ldcs(o.gat + e) : 0) * k;
      re[i] = in[i] ? __ldcs(o.resid + e) : 0.f;
      va[i] = in[i] ? __ldcs(o.vals + e) : 0.f;
      w[i] = in[i] ? __ldcs(o.weight + e) : 0.f;
    }
    float dot[kSortedBatch];
    if (R) {
#pragma unroll
      for (int t = 0; t < kRegTiles; ++t) {
        const int64_t j0 = t * kTile;
        if (j0 < k) {
          float tb[kSortedBatch][kTile];
#pragma unroll
          for (int i = 0; i < kSortedBatch; ++i) load_gat_tile<V>(in[i], xg[i], j0, k, tb[i]);
#pragma unroll
          for (int i = 0; i < kSortedBatch; ++i) dot_tile(seg[t], tb[i], j0, k, dot[i]);
        }
      }
    } else {
      for (int64_t j0 = 0; j0 < k; j0 += kTile) {
        float ts[kTile], tb[kSortedBatch][kTile];
        load_tile<V>(xs, j0, k, ts);
#pragma unroll
        for (int i = 0; i < kSortedBatch; ++i) load_gat_tile<V>(in[i], xg[i], j0, k, tb[i]);
#pragma unroll
        for (int i = 0; i < kSortedBatch; ++i) dot_tile(ts, tb[i], j0, k, dot[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kSortedBatch; ++i)
      if (in[i])
        __stcs(o.out + e0 + kWarp * i,
               resid_step_dot(omg, g, gmu, re[i], va[i], w[i], dot[i]));
  }
}

// update_resid_kernel with (d, k) and (m, k) factors: blocks [0,
// caller_blocks) the caller order, the next row_blocks the row order (a warp
// a piece), the rest the column order. The products are u_j v_j in every
// order (x_seg x_gat in a sorted one: the same product), so each order has
// the caller order's bits. ORDERS names the launch in a profile: true when
// it writes the sorted orders too (update_resid), false for the caller
// order alone (update_resid_caller); the code is the same. resid and out
// may alias, as in update_resid_kernel.
template <bool V, bool R, bool ORDERS>
__global__ void __launch_bounds__(kThreads)
update_resid_block_kernel(const float* __restrict__ gamma, float mu,
                          const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                          const float* resid, const float* __restrict__ vals,
                          const float* __restrict__ weight, const float* __restrict__ u,
                          const float* __restrict__ v, float* out, int64_t p,
                          int64_t k, int vec, int64_t caller_blocks, SortedResid row,
                          int64_t row_blocks, SortedResid col) {
  const float g = __ldg(gamma);
  const float omg = __fsub_rn(1.f, g);
  const float gmu = __fmul_rn(g, mu);
  int64_t blk = blockIdx.x;
  if (blk < caller_blocks) {
    update_caller_block<V>(blk, omg, g, gmu, rows, cols, resid, vals, weight, u, v, out, p, k,
                           vec);
    return;
  }
  blk -= caller_blocks;
  const bool by_row = blk < row_blocks;
  const SortedResid o = by_row ? row : col;
  const int64_t piece = (by_row ? blk : blk - row_blocks) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (piece >= o.num_pieces) return;
  update_sorted_piece<V, R>(o, piece, omg, g, gmu, k);
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

// out (out_dim, k) = segmented sums of vals_sorted * x[gat_sorted, :] over the
// sorted order, x (in_dim, k); partial is (num_pieces, k) scratch, written
// only for segments of several pieces. Groups of 32 columns, one pass over the
// entries each.
int mc_coo_matmat_f32(const int32_t* gat, const float* vals, const float* x,
                      const int64_t* piece_start, const int64_t* piece_end,
                      const int64_t* piece_seg, const int64_t* piece_ptr, float* partial,
                      float* out, int64_t num_pieces, int64_t out_dim, int64_t k, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CooBlock a{gat, vals, x, piece_start, piece_end, piece_seg, piece_ptr, partial, out,
                   num_pieces, k};
  // 16-byte lanes where every row of X starts on a 16-byte boundary
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int quad =
      (reinterpret_cast<uintptr_t>(gat) | reinterpret_cast<uintptr_t>(vals)) % 16 == 0;
  for (int64_t col0 = 0; col0 < k; col0 += kWarp) {
    const int kc = static_cast<int>(k - col0 < kWarp ? k - col0 : kWarp);
    if (num_pieces > 0) {
      const int lanes = vec ? kc / 4 : kc;
      int group = 1;
      while (group < lanes) group *= 2;
      // pieces a warp walks: enough warps for two per resident slot, at most
      // kMaxPiecesPerWarp, and at least one a group
      int64_t per = num_pieces / (2 * kResidentWarps);
      if (per > kMaxPiecesPerWarp) per = kMaxPiecesPerWarp;
      if (per < kWarp / group) per = kWarp / group;
      const int64_t warps = (num_pieces + per - 1) / per;
      const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
      err = vec ? launch_piece_sum<4>(group, a, static_cast<int>(col0), kc, static_cast<int>(per),
                                      quad, blocks, s)
                : launch_piece_sum<1>(group, a, static_cast<int>(col0), kc, static_cast<int>(per),
                                      quad, blocks, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int64_t blocks = (out_dim * kc + kThreads - 1) / kThreads;
    segment_sum_block_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        partial, piece_ptr, out, out_dim, k, static_cast<int>(col0), kc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// mc_update_resid_f32 with u (d, k) and v (m, k) row-major. p >= 1, k >= 1.
// r_pieces = c_pieces = 0 (their pointers unused) writes the caller order
// alone.
int mc_update_resid_block_f32(const float* gamma, float mu, const int32_t* rows,
                              const int32_t* cols, const float* resid, const float* vals,
                              const float* weight, const float* u, const float* v, float* out,
                              int64_t p, int64_t k,
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
  const bool vec_rows = k % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const bool in_regs = k <= kSegRegs;
  const SortedResid row{r_gat, r_start, r_end, r_seg, r_resid, r_vals, r_weight, u, v, r_out,
                        r_pieces};
  const SortedResid col{c_gat, c_start, c_end, c_seg, c_resid, c_vals, c_weight, v, u, c_out,
                        c_pieces};
  const int64_t caller_blocks =
      (p + kCallerBatch * kThreads - 1) / (kCallerBatch * kThreads);
  const int64_t row_blocks = (r_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t col_blocks = (c_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const unsigned blocks = static_cast<unsigned>(caller_blocks + row_blocks + col_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_UPDATE_BLOCK(V, R, O)                                                                \
  update_resid_block_kernel<V, R, O><<<blocks, kThreads, 0, s>>>(                               \
      gamma, mu, rows, cols, resid, vals, weight, u, v, out, p, k, vec, caller_blocks, row,     \
      row_blocks, col)
#define MC_UPDATE_BLOCK_ORDERS(V, R)                                                            \
  if (r_pieces + c_pieces > 0) MC_UPDATE_BLOCK(V, R, true); else MC_UPDATE_BLOCK(V, R, false)
  if (vec_rows) {
    if (in_regs) MC_UPDATE_BLOCK_ORDERS(true, true); else MC_UPDATE_BLOCK_ORDERS(true, false);
  } else {
    if (in_regs) MC_UPDATE_BLOCK_ORDERS(false, true); else MC_UPDATE_BLOCK_ORDERS(false, false);
  }
#undef MC_UPDATE_BLOCK_ORDERS
#undef MC_UPDATE_BLOCK
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
