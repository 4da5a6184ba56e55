// Fused factor-form scoring for the serving path, sm_90a:
//     out (b, n_out) = ((X (b, n_in) @ A (r, n_in)^T) * s (r,)) @ B (r, n_out)
// X, A and B each f32 or bf16, s and out f32, every sum in f32.
//
// Replaces src/repro/kernels/factor_matvec/kernel.py: factor_matvec
// (_factor_matvec_kernel). The factored iterate W = A^T diag(s) B is never
// formed; the rank-r intermediate T = (X A^T) * s stays in shared memory.
//
// Bound: at serving batches (b <= 64, r <= 64) the kernel reads A and B once
// (about 0.8 MB at 2048 -> 1000, r = 64) and does 25 MFLOP, under a
// microsecond of the card's time either way: what is left is latency, of the
// loads, the products and the launch. At b = 1024, r = 256 the f32 function
// is 1.6 GFLOP, 24 us at the 67 TFLOP/s of the CUDA cores; on the tensor
// cores in 3xTF32 (three TF32 products per f32 product) it is 4.8 GFLOP of
// TF32 work, under 10 us at 495 TFLOP/s (mma.sync reaches a part of that
// rate). Plain TF32 keeps 11 bits of each operand and would fail the
// serving engine's 1e-4 start-up check.
//
// Design:
// - A thread-block cluster of 16 blocks (the non-portable size Hopper
//   allows) owns a tile of up to 64 batch rows (grid: 16 x batch tiles); one
//   batch tile at the serving batch spreads over 16 SMs where the first
//   version of this kernel ran one block per row.
// - Stage 1, T = (X A^T) * s, 64 rank columns at a time: block c of the
//   cluster sums the products over its chunk c of n_in (at most 16 chunks,
//   of a width that depends on n_in alone, a multiple of 8) on the tensor
//   cores, mma.sync m16n8k8 TF32 in 3xTF32: each f32 operand is split into
//   a TF32 hi part and a TF32 lo part, and lo*hi + hi*lo + hi*hi go into an
//   f32 accumulator. Warp w owns rank columns 8w..8w+7 of the tile and every
//   batch row; each of the three products is issued for all of a warp's
//   tiles before the next, and the even and the odd 8-column steps go into
//   two accumulators, so independent MMAs run back to back.
// - X and A come in 64-column stages through a 3-slot ring in shared
//   memory: where n_in % 4 == 0 and X and A start on 16-byte boundaries, by
//   the copy engine (TMA: two 32-column boxes of each per stage from 2-D
//   tensor maps, 128-byte swizzle, zeros past every edge, completion counted
//   in bytes on an mbarrier per slot); otherwise by cp.async copies of 4 or
//   16 bytes into the same swizzled layout, zero-filled past the edges. On
//   one cluster a stream of cp.async copies was bound by the loads each SM
//   keeps in flight; the copy engine moves whole boxes.
// - The chunks' partial sums meet through distributed shared memory: each
//   block stores every row of its partial into the block that owns the row
//   (block c owns rows c*BT/16..), cluster.sync(); the owner sums the chunks
//   in ascending order, scales by s and stores its rows of T into every
//   block of the cluster, cluster.sync(). Only stores cross the cluster,
//   so no block waits on a remote read. A and X are read once per batch
//   tile, each block a chunk of them.
// - Stage 2: block c owns out columns c*W..(c+1)*W - 1 (W = n_out / 16
//   rounded up to 8), up to 128 at a time, and multiplies T's 64 rank
//   columns by B's rows on the tensor cores, 3xTF32 again, 8 ranks per step
//   in ascending order, the even and the odd steps into two accumulators
//   (twice the independent MMAs in flight); B's tile is copied in by
//   cp.async while the cluster reduces.
// - Accuracy: the tensor cores' f32 accumulation truncates, which biases a
//   long chain of MMAs into one accumulator. So each 64-column stage of
//   stage 1 and each rank tile of stage 2 starts from zero, and their sums
//   are added in f32 (round to nearest): stage 1 in registers, stage 2
//   through `out`, written and read back by the thread that owns it.
// - Bits: every output is summed in one fixed order that depends on n_in
//   alone: in stage 1, the even and the odd 8-column steps of a stage, the
//   stages in ascending order within a chunk, then the chunks in ascending
//   order; in stage 2, the even and the odd 8-rank steps of a rank tile in
//   ascending order, then the rank tiles in ascending order. Rank padding
//   with s = 0 rows (zero factors) adds steps of exact zeros, whose products
//   leave an accumulator as it was, and rank tiles of zeros, so a padded
//   rank bucket gives the live rank's bits (the live rank's last step is
//   zero-filled). Nothing depends on r, b or n_out; no atomics, so repeated
//   calls give identical bits.
// - Ragged b, n_in, r and n_out are masked by the copies and the stores;
//   nothing is padded in memory.
// - bf16 operands (X, A, B each on its own, as the reference's kernel takes
//   any input dtype and accumulates in f32): the kernel reads the 2-byte
//   elements from global memory itself, four at a time where the rows allow
//   8-byte loads, and widens each to f32 as it stages it into the same
//   shared layout (a plain load and store in place of the asynchronous copy;
//   X and A then never take the copy engine). A bf16 value is exact in TF32,
//   so its low split is zero and the products are the f32 route's on the
//   widened operands, in the same order: the same bits as the f32 kernel on
//   x.float(), a.float(), b.float().
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kCluster = 16;    // blocks of a cluster: stage-1 chunks, stage-2 column slices
constexpr int kRankTile = 64;   // rank columns of T per pass
constexpr int kKTile = 64;      // n_in columns per ring stage: two boxes of 32
constexpr int kBox = kSwizzleBox;  // columns of one 128-byte swizzled box (32)
constexpr int kStages = 3;      // ring depth
constexpr int kOutChunk = 128;  // out columns per stage-2 pass of a block
constexpr int kOutTiles = kOutChunk / 8 / 8;  // n-tiles per warp in a pass
// Padded row strides (floats): conflict-free fragment reads, 16-byte rows.
constexpr int kLdT = kRankTile + 4;
constexpr int kLdB = kOutChunk + 8;

// Ring stages hold X and A as boxes of 32 columns, 128 bytes a row, with the
// 16-byte chunks of row i stored at chunk ^ (i % 8) (the copy engine's
// 128-byte swizzle; the cp.async path writes the same layout), so that
// fragment reads hit 32 different banks.
template <int MT>
struct Smem {
  static constexpr int kRows = 16 * MT;                // batch rows of a tile
  static constexpr int kSliceRows = kRows / kCluster;  // rows of T each block reduces
  float xs[kStages][kKTile / kBox][kRows][kBox];
  float as[kStages][kKTile / kBox][kRankTile][kBox];
  float recv[kCluster][kSliceRows][kRankTile];  // every chunk's partial of this block's rows
  float ts[kRows][kLdT];  // the whole tile of T, written by the cluster
  float bs[kRankTile][kLdB];  // B's rows of the rank tile, this pass's columns
  uint64_t full[kStages];     // a ring stage's copies have landed (copy-engine path)
};

// Bits of the kernel's `bf16` argument: which operands hold bf16 elements.
constexpr int kX16 = 1, kA16 = 2, kB16 = 4;

// Four (vec) or one bf16 element(s) at src, widened to f32, stored at dst
// (16-byte aligned when vec); zeros where !ok. bf16 is the top half of an
// f32, so the widening is exact.
__device__ __forceinline__ void stage_bf16(float* dst, const uint16_t* __restrict__ src, bool ok,
                                           bool vec) {
  if (vec) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
      v = make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                      __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
    }
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    *dst = ok ? __uint_as_float(static_cast<uint32_t>(__ldg(src)) << 16) : 0.f;
  }
}

// One ring stage: X rows row0.. and A rows k0.. over columns col0..col0+63
// into slot `slot`. With tensor maps (tma), thread 0 asks the copy engine
// for the four boxes, zero past every edge of X and A, counted in bytes on
// the slot's barrier; otherwise cp.async copies of 16 (vec) or 4 bytes of an
// f32 operand, or loads of 4 (vec) or 1 element(s) of a bf16 one widened by
// stage_bf16, into the same swizzled layout, zero past the batch (nx rows),
// the rank tile (na rows) and col_end; the copies as one group.
template <int MT>
__device__ __forceinline__ void issue_stage(Smem<MT>& sm, int slot, const CUtensorMap* tx,
                                            const CUtensorMap* ta, const void* __restrict__ x,
                                            const void* __restrict__ a, int64_t row0, int nx,
                                            int64_t k0, int na, int64_t n_in, int64_t col0,
                                            int64_t col_end, bool tma, bool vec, int bf16) {
  constexpr int kRows = Smem<MT>::kRows;
  if (tma) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.full[slot], sizeof(sm.xs[0]) + sizeof(sm.as[0]));
#pragma unroll
      for (int bx = 0; bx < kKTile / kBox; ++bx) {
        tma_load(&sm.xs[slot][bx][0][0], tx, &sm.full[slot], col0 + bx * kBox, row0);
        tma_load(&sm.as[slot][bx][0][0], ta, &sm.full[slot], col0 + bx * kBox, k0);
      }
    }
    return;
  }
  const int step = vec ? 4 : 1;
  const int per_row = kKTile / step;
  for (int i = threadIdx.x; i < (kRows + kRankTile) * per_row; i += kThreads) {
    const int row = i / per_row;
    const int col = (i % per_row) * step;
    const int bx = col / kBox;
    const bool is_x = row < kRows;
    const int rr = is_x ? row : row - kRows;
    const bool ok = (is_x ? rr < nx : rr < na) && col0 + col < col_end;
    const int64_t at = (is_x ? row0 + rr : k0 + rr) * n_in + col0 + col;
    float* dst = is_x ? &sm.xs[slot][bx][rr][swz(rr, col % kBox)]
                      : &sm.as[slot][bx][rr][swz(rr, col % kBox)];
    if (bf16 & (is_x ? kX16 : kA16)) {
      stage_bf16(dst, static_cast<const uint16_t*>(is_x ? x : a) + at, ok, vec);
      continue;
    }
    const float* base = static_cast<const float*>(is_x ? x : a);
    if (vec) {
      cp_async16(dst, ok ? base + at : base, ok);
    } else {
      cp_async4(dst, ok ? base + at : base, ok);
    }
  }
  cp_async_commit();
}

// B rows k0..k0+nb-1, columns jbeg..jbeg+ncols-1 into bs by cp.async copies
// of 16 (vec) or 4 bytes (f32 B; as one group) or loads of 4 (vec) or 1
// element(s) widened by stage_bf16 (bf16 B), zero past nb rows (up to rt8)
// and ncols columns.
template <int MT>
__device__ __forceinline__ void issue_b(Smem<MT>& sm, const void* __restrict__ b, int64_t k0,
                                        int nb, int rt8, int64_t n_out, int64_t jbeg, int ncols,
                                        bool vec, bool b16) {
  const int ncols8 = (ncols + 7) & ~7;
  const int step = vec ? 4 : 1;
  const int per_row = ncols8 / step;
  for (int i = threadIdx.x; i < rt8 * per_row; i += kThreads) {
    const int k = i / per_row;
    const int c = (i % per_row) * step;
    const bool ok = k < nb && c < ncols;
    const int64_t at = (k0 + k) * n_out + jbeg + c;
    if (b16) {
      stage_bf16(&sm.bs[k][c], static_cast<const uint16_t*>(b) + at, ok, vec);
      continue;
    }
    const float* base = static_cast<const float*>(b);
    if (vec) {
      cp_async16(&sm.bs[k][c], ok ? base + at : base, ok);
    } else {
      cp_async4(&sm.bs[k][c], ok ? base + at : base, ok);
    }
  }
  cp_async_commit();
}

// Stage 2's sums of one rank tile (its even and its odd 8-rank steps, in
// that order) into out, masked: stored for the first tile, added (one f32
// rounding, by the thread that stored it) after that.
template <int MT>
__device__ __forceinline__ void write_out(const float (&acc)[2][MT][kOutTiles][4],
                                          float* __restrict__ out, bool add, int64_t row0,
                                          int64_t bt, int64_t n_out, int64_t jbeg, int64_t jend,
                                          int ntiles) {
  const int warp = threadIdx.x / kWarp, g = (threadIdx.x % kWarp) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j) {
    const int nt = warp + 8 * j;
    if (nt >= ntiles) continue;
    const int64_t col = jbeg + nt * 8 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t row = row0 + mt * 16 + g + (q >= 2 ? 8 : 0);
        const int64_t c = col + (q & 1);
        if (row < bt && c < jend) {
          const float v = __fadd_rn(acc[0][mt][j][q], acc[1][mt][j][q]);
          float* o = out + row * n_out + c;
          *o = add ? __fadd_rn(*o, v) : v;
        }
      }
    }
  }
}

// One 8-rank step of stage 2 at rank column kk of T: lo*hi, hi*lo, hi*hi,
// each for every (m-tile, n-tile) of the warp before the next.
template <int MT>
__device__ __forceinline__ void stage2_step(const Smem<MT>& sm, float (&acc)[MT][kOutTiles][4],
                                            int kk, int ntiles) {
  const int warp = threadIdx.x / kWarp, g = (threadIdx.x % kWarp) / 4, t = threadIdx.x % 4;
  uint32_t ah[MT][4], al[MT][4], bh[kOutTiles][2], bl[kOutTiles][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    split_tf32(sm.ts[mt * 16 + g][kk + t], ah[mt][0], al[mt][0]);
    split_tf32(sm.ts[mt * 16 + g + 8][kk + t], ah[mt][1], al[mt][1]);
    split_tf32(sm.ts[mt * 16 + g][kk + t + 4], ah[mt][2], al[mt][2]);
    split_tf32(sm.ts[mt * 16 + g + 8][kk + t + 4], ah[mt][3], al[mt][3]);
  }
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j) {
    if (warp + 8 * j < ntiles) {
      split_tf32(sm.bs[kk + t][(warp + 8 * j) * 8 + g], bh[j][0], bl[j][0]);
      split_tf32(sm.bs[kk + t + 4][(warp + 8 * j) * 8 + g], bh[j][1], bl[j][1]);
    }
  }
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (warp + 8 * j < ntiles) mma_tf32(acc[mt][j], al[mt], bh[j]);
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (warp + 8 * j < ntiles) mma_tf32(acc[mt][j], ah[mt], bl[j]);
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (warp + 8 * j < ntiles) mma_tf32(acc[mt][j], ah[mt], bh[j]);
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
factor_matvec_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap ta,
                     const void* __restrict__ x, const void* __restrict__ a,
                     const float* __restrict__ s, const void* __restrict__ b,
                     float* __restrict__ out, int64_t bt, int64_t n_in, int64_t r, int64_t n_out,
                     int chunks, int64_t chunk_width, int64_t out_cols, int tma, int vec_in,
                     int vec_out, int bf16) {
  constexpr int kRows = Smem<MT>::kRows;
  constexpr int kSliceRows = Smem<MT>::kSliceRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled boxes need a 1024-byte-aligned base (the launch asks for
  // 1 KB more than Smem takes)
  Smem<MT>& sm = *reinterpret_cast<Smem<MT>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / kWarp, g = (threadIdx.x % kWarp) / 4, t = threadIdx.x % 4;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kRows;
  const int nx = static_cast<int>(bt - row0 < kRows ? bt - row0 : kRows);
  const bool by_tma = tma != 0;

  // this block's stage-1 chunk of n_in and stage-2 slice of n_out
  const int64_t kbeg = rank * chunk_width;
  const int64_t kend = kbeg + chunk_width < n_in ? kbeg + chunk_width : n_in;
  const int nst = rank < chunks ? static_cast<int>((kend - kbeg + kKTile - 1) / kKTile) : 0;
  const int64_t slice0 = rank * out_cols;
  const int64_t slice_end = slice0 + out_cols < n_out ? slice0 + out_cols : n_out;
  const int npass = slice_end > slice0
                        ? static_cast<int>((slice_end - slice0 + kOutChunk - 1) / kOutChunk)
                        : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(&sm.full[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int64_t ring_used = 0;  // ring stages consumed so far: slot and barrier phase of the next

  for (int64_t k0 = 0; k0 < r; k0 += kRankTile) {
    const int rt = static_cast<int>(r - k0 < kRankTile ? r - k0 : kRankTile);
    const int rt8 = (rt + 7) & ~7;

    // Stage 1: this chunk's partial of X A^T for the rank tile.
    if (rank < chunks) {
      float acc1[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc1[mt][q] = 0.f;
      const bool live = warp * 8 < rt;
      auto issue = [&](int it) {
        issue_stage(sm, static_cast<int>((ring_used + it) % kStages), &tx, &ta, x, a, row0, nx,
                    k0, rt, n_in, kbeg + static_cast<int64_t>(it) * kKTile, kend, by_tma,
                    vec_in != 0, bf16);
      };
#pragma unroll
      for (int st = 0; st < kStages - 1; ++st) {
        if (st < nst) {
          issue(st);
        } else if (!by_tma) {
          cp_async_commit();
        }
      }
      for (int it = 0; it < nst; ++it) {
        const int64_t used = ring_used + it;
        const int slot = static_cast<int>(used % kStages);
        if (by_tma) {
          mbar_wait(&sm.full[slot], static_cast<uint32_t>((used / kStages) & 1));
        } else {
          cp_async_wait<kStages - 2>();
        }
        __syncthreads();  // every warp is done with the slot the next stage refills
        if (it + kStages - 1 < nst) {
          issue(it + kStages - 1);
        } else if (!by_tma) {
          cp_async_commit();
        }
        const int64_t col0 = kbeg + static_cast<int64_t>(it) * kKTile;
        const int ksteps = static_cast<int>(
            (kend - col0 + 7) / 8 < kKTile / 8 ? (kend - col0 + 7) / 8 : kKTile / 8);
        if (live) {
          // 3xTF32 per m-tile: lo*hi, hi*lo, then hi*hi into one f32
          // accumulator, each product issued for every m-tile before the
          // next (independent MMAs back to back); even and odd 8-column
          // steps into two accumulators, added once per stage.
          float step[2][MT][4];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int q = 0; q < 4; ++q) step[e][mt][q] = 0.f;
#pragma unroll
          for (int ks = 0; ks < kKTile / 8; ++ks) {
            if (ks < ksteps) {
              // columns kk + t and kk + t + 4 of rows = g (mod 8), swizzled
              const int bx = ks * 8 / kBox;
              const int c0 = swz(g, ks * 8 % kBox + t), c1 = swz(g, ks * 8 % kBox + t + 4);
              uint32_t bh[2], bl[2], ah[MT][4], al[MT][4];
              split_tf32(sm.as[slot][bx][warp * 8 + g][c0], bh[0], bl[0]);
              split_tf32(sm.as[slot][bx][warp * 8 + g][c1], bh[1], bl[1]);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                split_tf32(sm.xs[slot][bx][mt * 16 + g][c0], ah[mt][0], al[mt][0]);
                split_tf32(sm.xs[slot][bx][mt * 16 + g + 8][c0], ah[mt][1], al[mt][1]);
                split_tf32(sm.xs[slot][bx][mt * 16 + g][c1], ah[mt][2], al[mt][2]);
                split_tf32(sm.xs[slot][bx][mt * 16 + g + 8][c1], ah[mt][3], al[mt][3]);
              }
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) mma_tf32(step[ks & 1][mt], al[mt], bh);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) mma_tf32(step[ks & 1][mt], ah[mt], bl);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) mma_tf32(step[ks & 1][mt], ah[mt], bh);
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc1[mt][q] = __fadd_rn(acc1[mt][q], __fadd_rn(step[0][mt][q], step[1][mt][q]));
            }
        }
      }
      ring_used += nst;
      // each row's partial to the block of the cluster that reduces it
      if (live) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mt * 16 + g + 8 * h;
            float2* dst = cluster.map_shared_rank(reinterpret_cast<float2*>(
                &sm.recv[rank][row % kSliceRows][warp * 8 + 2 * t]), row / kSliceRows);
            *dst = make_float2(acc1[mt][2 * h], acc1[mt][2 * h + 1]);
          }
        }
      }
    }

    // B's tile for this block's first pass of stage 2, copied in while the
    // cluster reduces (every warp is done with bs from the last rank tile).
    __syncthreads();
    const int64_t jend0 = slice0 + kOutChunk < slice_end ? slice0 + kOutChunk : slice_end;
    if (npass > 0) {
      issue_b(sm, b, k0, rt, rt8, n_out, slice0, static_cast<int>(jend0 - slice0), vec_out != 0,
              (bf16 & kB16) != 0);
    }

    // The chunks' partials meet: this block's rows of T, summed in chunk
    // order and scaled by s, go to every block of the cluster.
    cluster.sync();
    for (int i = threadIdx.x; i < kSliceRows * (kRankTile / 4); i += kThreads) {
      const int lr = i / (kRankTile / 4), c = (i % (kRankTile / 4)) * 4;
      if (c >= rt8) continue;
      float4 sum = *reinterpret_cast<const float4*>(&sm.recv[0][lr][c]);
      for (int ch = 1; ch < chunks; ++ch) {
        const float4 p = *reinterpret_cast<const float4*>(&sm.recv[ch][lr][c]);
        sum = make_float4(__fadd_rn(sum.x, p.x), __fadd_rn(sum.y, p.y), __fadd_rn(sum.z, p.z),
                          __fadd_rn(sum.w, p.w));
      }
      float sk[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) sk[q] = k0 + c + q < r ? __ldg(s + k0 + c + q) : 0.f;
      const float4 tv = make_float4(__fmul_rn(sum.x, sk[0]), __fmul_rn(sum.y, sk[1]),
                                    __fmul_rn(sum.z, sk[2]), __fmul_rn(sum.w, sk[3]));
      float4* mine = reinterpret_cast<float4*>(&sm.ts[rank * kSliceRows + lr][c]);
#pragma unroll
      for (int dst = 0; dst < kCluster; ++dst) *cluster.map_shared_rank(mine, dst) = tv;
    }
    cluster.sync();

    // Stage 2: out[:, this block's columns] += T B, 8 ranks a step.
    for (int pass = 0; pass < npass; ++pass) {
      const int64_t jbeg = slice0 + static_cast<int64_t>(pass) * kOutChunk;
      const int64_t jend = jbeg + kOutChunk < slice_end ? jbeg + kOutChunk : slice_end;
      const int ntiles = (static_cast<int>(jend - jbeg) + 7) / 8;
      if (pass > 0) {
        __syncthreads();  // every warp is done with bs
        issue_b(sm, b, k0, rt, rt8, n_out, jbeg, static_cast<int>(jend - jbeg), vec_out != 0,
                (bf16 & kB16) != 0);
      }
      cp_async_wait<0>();
      __syncthreads();
      // even and odd 8-rank steps into two accumulators
      float acc2[2][MT][kOutTiles][4];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < kOutTiles; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc2[e][mt][j][q] = 0.f;
      for (int ks = 0; ks < rt8 / 8; ks += 2) {
        stage2_step(sm, acc2[0], ks * 8, ntiles);
        if (ks + 1 < rt8 / 8) stage2_step(sm, acc2[1], ks * 8 + 8, ntiles);
      }
      write_out<MT>(acc2, out, k0 > 0, row0, bt, n_out, jbeg, jend, ntiles);
    }
  }
}

constexpr int kMapFailed = 100000;  // + CUresult: a tensor map was refused

template <int MT>
int launch(const void* x, const void* a, const float* s, const void* b, float* out,
           int64_t bt, int64_t n_in, int64_t r, int64_t n_out, int chunks, int64_t chunk_width,
           int64_t out_cols, int vec_in, int vec_out, int bf16, int device, cudaStream_t stream) {
  static uint64_t smem_set = 0;  // devices whose attribute is set
  const size_t smem = sizeof(Smem<MT>) + 1024;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!(smem_set >> device & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        factor_matvec_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const cudaError_t err16 = cudaFuncSetAttribute(
        factor_matvec_kernel<MT>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err16 != cudaSuccess) return err16;
    smem_set |= uint64_t{1} << device;
  }
  // X and A through the copy engine where both are f32 and their rows are
  // 16-byte aligned
  CUtensorMap tx{}, ta{};
  const int tma = vec_in && n_in > 0 && (bf16 & (kX16 | kA16)) == 0;
  if (tma) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    CUresult res = tensor_map(encode, &tx, static_cast<const float*>(x), bt, n_in, 16 * MT);
    if (res == CUDA_SUCCESS) {
      res = tensor_map(encode, &ta, static_cast<const float*>(a), r, n_in, kRankTile);
    }
    if (res != CUDA_SUCCESS) return kMapFailed + static_cast<int>(res);
  }
  const int64_t tiles = (bt + 16 * MT - 1) / (16 * MT);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, static_cast<unsigned>(tiles), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, factor_matvec_kernel<MT>, tx, ta, x, a, s, b,
                                             out, bt, n_in, r, n_out, chunks, chunk_width,
                                             out_cols, tma, vec_in, vec_out, bf16));
}

}  // namespace

extern "C" {

const char* fm_error_string(int code) {
  if (code >= kMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (bt, n_out) = ((x (bt, n_in) @ a (r, n_in)^T) * s (r,)) @ b (r, n_out),
// by the launch plan of kernels/factor_matvec/kernel.py: m_tiles (1, 2 or 4)
// 16-row MMA tiles per batch tile; stage 1 in `chunks` (<= 16) chunks of
// chunk_width columns of n_in (a multiple of 8); stage 2 in out_cols (a
// multiple of 8) columns of n_out per block. bf16 says which of x (1), a (2)
// and b (4) hold bf16 elements (the others f32; s and out are f32). vec_in
// is 1 when n_in % 4 == 0 and x and a start on boundaries of four elements
// (16 bytes f32, 8 bytes bf16; two f32 operands then go through the copy
// engine), vec_out when n_out % 4 == 0 and b does. Needs bt, r >= 1 and
// bt / (16 m_tiles) < 65536 batch tiles.
int fm_factor_matvec(const void* x, const void* a, const float* s, const void* b,
                     float* out, int64_t bt, int64_t n_in, int64_t r, int64_t n_out,
                     int m_tiles, int chunks, int64_t chunk_width, int64_t out_cols,
                     int vec_in, int vec_out, int bf16, int device, void* stream) {
  if (chunks < 1 || chunks > kCluster || chunk_width < 8 || chunk_width % 8 != 0 ||
      out_cols < 8 || out_cols % 8 != 0 || (chunks - 1) * chunk_width >= (n_in > 0 ? n_in : 1) ||
      chunks * chunk_width < n_in || kCluster * out_cols < n_out || n_in >= (int64_t{1} << 31) ||
      bt >= (int64_t{1} << 31) || r >= (int64_t{1} << 31) || bf16 < 0 ||
      bf16 > (kX16 | kA16 | kB16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int res;
  switch (m_tiles) {
    case 1: res = launch<1>(x, a, s, b, out, bt, n_in, r, n_out, chunks, chunk_width, out_cols,
                            vec_in, vec_out, bf16, device, st); break;
    case 2: res = launch<2>(x, a, s, b, out, bt, n_in, r, n_out, chunks, chunk_width, out_cols,
                            vec_in, vec_out, bf16, device, st); break;
    case 4: res = launch<4>(x, a, s, b, out, bt, n_in, r, n_out, chunks, chunk_width, out_cols,
                            vec_in, vec_out, bf16, device, st); break;
    default: res = static_cast<int>(cudaErrorInvalidValue);
  }
  if (res != 0) return res;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
