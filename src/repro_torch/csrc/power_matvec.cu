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
// Bound: bytes. At k = 32 on X (1,281,167 x 2048) A is 10.50 GB, 3.13 ms at
// 3.35 TB/s, and the 2 n m k = 168 GFLOP take 2.51 ms at the CUDA cores' 67
// TFLOP/s: an FFMA kernel would have to hold DRAM and the FMA pipe near
// their peaks at once (the first design, PR 22, a register-tiled FFMA
// product loaded through shared memory by the threads that then computed,
// reached 52% of its bound on X and 41% on R). On the tensor cores in 3xTF32
// the same products are about 1.0 ms at 495 / 3 TFLOP/s, a third of the
// bytes bound.
//
// Design (both, PR 23):
// - Persistent blocks, one an SM, of 8 consumer warps and one producer warp.
//   A work item is a tile of 256 rows of A (matmat) or 256 columns of one
//   slab of rows (rmatmat); block b takes items b, b + G, b + 2G, ... of G
//   blocks, and the producer runs on into its next item while the consumers
//   finish one, so an item's first loads are already in flight.
// - A ring of 4 stages in dynamic shared memory, each 32 columns (matmat) or
//   32 rows (rmatmat) of the tile (32 KB) with its 32 x k slab of V or U.
//   Where A's rows are 16-byte aligned (m % 4 == 0 and an aligned base), A
//   comes by TMA from a 2-D tensor map (one 32 x 256 box or eight 32 x 32
//   boxes a stage, 128-byte swizzle, zeros past every edge); otherwise, and
//   V and U always, by the producer warp's cp.async copies (16 bytes where k
//   % 4 == 0 and V or U is 16-byte aligned, else 4) into the same layout,
//   zero-filled past the edges. A slot's "full" mbarrier counts the copy
//   engine's bytes and each producer lane's cp.async arrive; a consumer warp
//   done with a slot arrives on its "empty" mbarrier, which the producer
//   waits on before it refills the slot.
// - Products on the tensor cores, mma.sync m16n8k8 TF32 in 3xTF32 (each f32
//   operand split into a TF32 hi and lo part, lo*hi + hi*lo + hi*hi into an
//   f32 accumulator), as factor_matvec.cu does; plain TF32 errs by about
//   1e-3. A warp owns 32 rows (matmat) or columns (rmatmat) of the tile and
//   the group's up to 32 output columns: 2 x (k / 8) MMA tiles. wgmma's TF32
//   form takes only K-major operands from shared memory, which rmatmat's A
//   (K = A's rows) is not; mma.sync loads its fragments in either layout.
// - Accuracy: the tensor cores' f32 accumulation truncates, so each stage's
//   products start from a zero accumulator and the stage sums are added in
//   f32, rounded to nearest: at most 12 truncating adds per rounded one.
// - Fragment reads hit 32 banks: the rows g and g + 8 of an MMA tile share
//   the swizzle's XOR (matmat); rmatmat reads its A box transposed and takes
//   the k-slots t and t + 4 of an MMA step from stage rows 2t and 2t + 1, so
//   the XOR spreads the lanes; V's stage rows are padded to 8 or 24 mod 32
//   floats, U's to 4 mod 16.
// - rmatmat: two fixed-order stages, as rmatvec: the items, slab-major (the
//   column tiles of one slab run together and share U's rows in L2), write
//   per-slab partials (slabs, m, kc); then one thread per output sums its
//   slabs in order. The wrapper picks the slab height so that the item
//   count is a multiple of G (kernels/power_matvec/ops.py): every block
//   takes the same number of items, with no partial last round.
// - Bits: every output is summed in one fixed order (k-steps and stages in
//   ascending order, then the slabs in order), whichever block takes an
//   item; no atomics, the same bits on every call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_async.cuh"

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

constexpr int kTile = 256;       // A rows (matmat) or columns (rmatmat) of a work item
constexpr int kStageK = 32;      // A columns (matmat) or rows (rmatmat) of a ring stage
constexpr int kConsumers = 8;    // consumer warps, 32 of the tile's rows or columns each
constexpr int kRing = 4;         // ring depth
constexpr int kRingThreads = (kConsumers + 1) * kWarp;  // and one producer warp
constexpr int kStageFloats = kTile * kStageK;
constexpr int kMMGroup = 32;     // output columns per pass over A
static_assert(kTile == kConsumers * 32 && kStageK == kSwizzleBox, "one box column a warp");

// Row stride (floats) of a stage of V (matmat: rows t and t + 4 of a k-step
// read together, 8 or 24 mod 32) or U (rmatmat: rows 2t and 2t + 1, 4 mod
// 16), so that a warp's fragment reads hit 32 banks; rows stay 16-byte
// aligned.
template <int KT, bool TRANS>
__host__ __device__ constexpr int stage_ld() {
  return TRANS ? KT + 4 : (KT == 8 ? 8 : KT + 8);
}

template <int KT, bool TRANS>
struct Ring {
  float a[kRing][kStageFloats];  // swizzled boxes (the base is 1024-byte aligned)
  float b[kRing][kStageK * stage_ld<KT, TRANS>()];
  uint64_t full[kRing];   // the slot's copies have landed
  uint64_t empty[kRing];  // every consumer warp is done with the slot
};

// Where work item `item` reads: matmat's tile of A rows origin.. over all m
// columns; rmatmat's tile of A columns origin.. over the rows k0..k_end of
// its slab. A stage st covers A columns (matmat) or rows (rmatmat) k0 + 32 st.
struct Item {
  int64_t origin, k0, k_end, slab;
  int stages;
};

template <bool TRANS>
__device__ __forceinline__ Item item_at(int64_t item, int64_t n, int64_t m,
                                        int64_t rows_per_slab) {
  Item it;
  if (!TRANS) {
    it.origin = item * kTile;
    it.k0 = 0;
    it.k_end = m;
    it.slab = 0;
  } else {
    const int64_t tiles = (m + kTile - 1) / kTile;
    it.slab = item / tiles;
    it.origin = (item % tiles) * kTile;
    it.k0 = it.slab * rows_per_slab;
    it.k_end = it.k0 + rows_per_slab < n ? it.k0 + rows_per_slab : n;
  }
  it.stages = static_cast<int>((it.k_end - it.k0 + kStageK - 1) / kStageK);
  return it;
}

// The producer warp: for every stage of every item of this block, wait for
// the slot to be free, then fill it (A by TMA or cp.async, the B slab by
// cp.async) and count the copies on the slot's full barrier.
template <int KT, bool TRANS>
__device__ __forceinline__ void produce(Ring<KT, TRANS>& sm, const CUtensorMap* map,
                                        const float* __restrict__ a,
                                        const float* __restrict__ b, int64_t n, int64_t m,
                                        int64_t k, int col0, int kc, int64_t rows_per_slab,
                                        int64_t items, bool tma, bool bvec) {
  constexpr int kLd = stage_ld<KT, TRANS>();
  const int lane = threadIdx.x % kWarp;
  int64_t q = 0;  // stages filled so far: slot and phase of the next
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = item_at<TRANS>(item, n, m, rows_per_slab);
    for (int st = 0; st < it.stages; ++st, ++q) {
      const int slot = static_cast<int>(q % kRing);
      if (q >= kRing) mbar_wait(&sm.empty[slot], static_cast<uint32_t>((q / kRing - 1) & 1));
      const int64_t ks = it.k0 + static_cast<int64_t>(st) * kStageK;
      float* as = sm.a[slot];
      if (tma) {
        if (lane == 0) {
          if (!TRANS) {
            mbar_expect_tx(&sm.full[slot], kStageFloats * sizeof(float));
            tma_load(as, map, &sm.full[slot], ks, it.origin);
          } else {
            // the boxes that start inside A (the consumers skip the others'
            // columns)
            const int64_t left = (m - it.origin + kSwizzleBox - 1) / kSwizzleBox;
            const int boxes = left < kTile / kSwizzleBox ? static_cast<int>(left)
                                                         : kTile / kSwizzleBox;
            mbar_expect_tx(&sm.full[slot], boxes * kSwizzleBox * kStageK * sizeof(float));
            for (int bx = 0; bx < boxes; ++bx) {
              tma_load(as + bx * kSwizzleBox * kStageK, map, &sm.full[slot],
                       it.origin + bx * kSwizzleBox, ks);
            }
          }
        }
      } else {
        if (lane == 0) mbar_arrive(&sm.full[slot]);
        if (!TRANS) {  // lane c copies column ks + c of the tile's 256 rows
          const int64_t col = ks + lane;
          for (int r = 0; r < kTile; ++r) {
            const int64_t row = it.origin + r;
            const bool ok = row < n && col < m;
            cp_async4(as + r * kSwizzleBox + swz(r, lane), ok ? a + row * m + col : a, ok);
          }
        } else {  // lane c copies column c of each box of rows ks..ks+31
          for (int r = 0; r < kStageK; ++r) {
            const int64_t row = ks + r;
#pragma unroll
            for (int bx = 0; bx < kTile / kSwizzleBox; ++bx) {
              const int64_t col = it.origin + bx * kSwizzleBox + lane;
              const bool ok = row < it.k_end && col < m;
              cp_async4(as + (bx * kStageK + r) * kSwizzleBox + swz(r, lane),
                        ok ? a + row * m + col : a, ok);
            }
          }
        }
      }
      // the B slab: rows ks..ks+31 (V's for matmat, U's for rmatmat) of the
      // group's columns, zero past k_end and kc
      float* bs = sm.b[slot];
      if (bvec) {
        for (int i = lane; i < kStageK * KT / 4; i += kWarp) {
          const int r = i / (KT / 4), c = 4 * (i % (KT / 4));
          const bool ok = ks + r < it.k_end && c < kc;
          cp_async16(bs + r * kLd + c, ok ? b + (ks + r) * k + col0 + c : b, ok);
        }
      } else {
        for (int i = lane; i < kStageK * KT; i += kWarp) {
          const int r = i / KT, c = i % KT;
          const bool ok = ks + r < it.k_end && c < kc;
          cp_async4(bs + r * kLd + c, ok ? b + (ks + r) * k + col0 + c : b, ok);
        }
      }
      cp_async_mbar_arrive(&sm.full[slot]);
    }
  }
  cp_async_wait_all();
}

// One stage's products of a consumer warp into st (zeroed by the caller):
// four 8-deep k-steps, each lo*hi, hi*lo, then hi*hi for every MMA tile of
// the warp before the next product.
template <int KT, bool TRANS>
__device__ __forceinline__ void stage_products(const float* __restrict__ as,
                                               const float* __restrict__ bs,
                                               float (&st)[2][KT / 8][4], int warp, int g,
                                               int t) {
  constexpr int NT = KT / 8;
  constexpr int kLd = stage_ld<KT, TRANS>();
#pragma unroll
  for (int kk = 0; kk < kStageK; kk += 8) {
    uint32_t ah[2][4], al[2][4], bh[NT][2], bl[NT][2];
    if (!TRANS) {
      // A rows warp*32 + mt*16 + g (+ 8), stage columns kk + t (+ 4); both
      // rows are g mod 8, so they share the swizzle
      const int c0 = swz(g, kk + t), c1 = swz(g, kk + t + 4);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* r0 = as + (warp * 32 + mt * 16 + g) * kSwizzleBox;
        const float* r1 = r0 + 8 * kSwizzleBox;
        split_tf32(r0[c0], ah[mt][0], al[mt][0]);
        split_tf32(r1[c0], ah[mt][1], al[mt][1]);
        split_tf32(r0[c1], ah[mt][2], al[mt][2]);
        split_tf32(r1[c1], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        split_tf32(bs[(kk + t) * kLd + nt * 8 + g], bh[nt][0], bl[nt][0]);
        split_tf32(bs[(kk + t + 4) * kLd + nt * 8 + g], bh[nt][1], bl[nt][1]);
      }
    } else {
      // A^T: the warp's box (its 32 columns), k-slots t and t + 4 from
      // stage rows kk + 2t and kk + 2t + 1
      const float* box = as + warp * kSwizzleBox * kStageK;
      const int ra = kk + 2 * t, rb = ra + 1;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int i0 = mt * 16 + g, i1 = i0 + 8;
        split_tf32(box[ra * kSwizzleBox + swz(ra, i0)], ah[mt][0], al[mt][0]);
        split_tf32(box[ra * kSwizzleBox + swz(ra, i1)], ah[mt][1], al[mt][1]);
        split_tf32(box[rb * kSwizzleBox + swz(rb, i0)], ah[mt][2], al[mt][2]);
        split_tf32(box[rb * kSwizzleBox + swz(rb, i1)], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        split_tf32(bs[ra * kLd + nt * 8 + g], bh[nt][0], bl[nt][0]);
        split_tf32(bs[rb * kLd + nt * 8 + g], bh[nt][1], bl[nt][1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(st[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(st[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(st[mt][nt], ah[mt], bh[nt]);
  }
}

// A consumer warp: for every item of this block, the stage sums of its 32
// rows (columns) x the group's columns, added in order; then its outputs:
// out[row, col0 + c] (matmat) or out[(slab m + col) kc + c] (rmatmat's
// partials).
template <int KT, bool TRANS>
__device__ __forceinline__ void consume(Ring<KT, TRANS>& sm, float* __restrict__ out, int64_t n,
                                        int64_t m, int64_t k, int col0, int kc,
                                        int64_t rows_per_slab, int64_t items) {
  constexpr int NT = KT / 8;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane / 4, t = lane % 4;
  int64_t q = 0;  // stages consumed so far: slot and phase of the next
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = item_at<TRANS>(item, n, m, rows_per_slab);
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int s = 0; s < it.stages; ++s, ++q) {
      const int slot = static_cast<int>(q % kRing);
      mbar_wait(&sm.full[slot], static_cast<uint32_t>((q / kRing) & 1));
      float st[2][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[mt][nt][e] = 0.f;
      // (an rmatmat warp whose columns lie past A's last one has no box)
      if (!TRANS || it.origin + warp * 32 < m) {
        stage_products<KT, TRANS>(sm.a[slot], sm.b[slot], st, warp, g, t);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[slot]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], st[mt][nt][e]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t i = it.origin + warp * 32 + mt * 16 + g + (e >= 2 ? 8 : 0);
        if (i >= (TRANS ? m : n)) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = nt * 8 + 2 * t + (e & 1);
          if (c >= kc) continue;
          if (TRANS) {
            out[(it.slab * m + i) * kc + c] = acc[mt][nt][e];
          } else {
            out[i * k + col0 + c] = acc[mt][nt][e];
          }
        }
      }
    }
  }
}

// KT (8, 16 or 32) output columns of a group at col0, kc of them live.
// matmat: out (n, k) = A V over row tiles; rmatmat: out = the partials
// (slabs, m, kc) of A^T U over (slab, column tile) items, slab-major.
template <int KT, bool TRANS>
__global__ void __launch_bounds__(kRingThreads, 1)
ring_matmat_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ a,
                   const float* __restrict__ b, float* __restrict__ out, int64_t n, int64_t m,
                   int64_t k, int col0, int kc, int64_t rows_per_slab, int64_t items, int tma,
                   int bvec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled boxes need a 1024-byte-aligned base (the launch asks for
  // 1 KB more than Ring takes)
  Ring<KT, TRANS>& sm = *reinterpret_cast<Ring<KT, TRANS>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&sm.full[s], kWarp + 1);  // the producer's lanes' cp.async arrives + lane 0's
      mbar_init(&sm.empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x / kWarp == kConsumers) {
    produce<KT, TRANS>(sm, &map, a, b, n, m, k, col0, kc, rows_per_slab, items, tma != 0,
                       bvec != 0);
  } else {
    consume<KT, TRANS>(sm, out, n, m, k, col0, kc, rows_per_slab, items);
  }
}

// Stage 2 of rmatmat: out[col, col0 + c] = sum over slabs of partial[slab,
// col, c], in order.
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

constexpr int kMapFailed = 100000;  // + CUresult: a tensor map was refused

int sm_count(int device) {
  static int count[64] = {};
  if (count[device] == 0) {
    int c = 0;
    if (cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
    count[device] = c;
  }
  return count[device];
}

// One pass over A for the group of KT columns at col0: items work items on
// min(items, SMs) persistent blocks.
template <int KT, bool TRANS>
int launch_ring(const float* a, const float* b, float* out, int64_t n, int64_t m, int64_t k,
                int col0, int kc, int64_t rows_per_slab, int64_t items, bool tma, bool bvec,
                int device, cudaStream_t s) {
  static uint64_t smem_set = 0;  // devices whose attribute is set
  const size_t smem = sizeof(Ring<KT, TRANS>) + 1024;
  if (!(smem_set >> device & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_matmat_kernel<KT, TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set |= uint64_t{1} << device;
  }
  CUtensorMap map{};
  if (tma) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    // matmat reads 128 bytes of each of 256 rows a stage: 256-byte L2 fills
    // bring the next stage's bytes of a row with the same DRAM page; rmatmat
    // reads 1 KB runs of a row and gained from no promotion (on R the runs
    // start off 128-byte lines). Both measured against 128-byte fills with
    // tools/torch_matmat_bench.py.
    const CUresult res = tensor_map(encode, &map, a, n, m, TRANS ? kStageK : kTile,
                                    TRANS ? CU_TENSOR_MAP_L2_PROMOTION_NONE
                                          : CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
    if (res != CUDA_SUCCESS) return kMapFailed + static_cast<int>(res);
  }
  const int sms = sm_count(device);
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  ring_matmat_kernel<KT, TRANS><<<grid, kRingThreads, smem, s>>>(
      map, a, b, out, n, m, k, col0, kc, rows_per_slab, items, tma ? 1 : 0, bvec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The group's pass with the narrowest KT that holds kc columns.
template <bool TRANS>
int launch_group(const float* a, const float* b, float* out, int64_t n, int64_t m, int64_t k,
                 int col0, int kc, int64_t rows_per_slab, int64_t items, bool tma, bool bvec,
                 int device, cudaStream_t s) {
  if (kc <= 8) {
    return launch_ring<8, TRANS>(a, b, out, n, m, k, col0, kc, rows_per_slab, items, tma, bvec,
                                 device, s);
  }
  if (kc <= 16) {
    return launch_ring<16, TRANS>(a, b, out, n, m, k, col0, kc, rows_per_slab, items, tma, bvec,
                                  device, s);
  }
  return launch_ring<32, TRANS>(a, b, out, n, m, k, col0, kc, rows_per_slab, items, tma, bvec,
                                device, s);
}

}  // namespace

extern "C" {

const char* pm_error_string(int code) {
  if (code >= kMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
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
// each). vec is 4 (rows of A 16-byte aligned, m % 4 == 0: A by TMA) or 1.
// Needs n, m < 2^31.
int pm_matmat_f32(const float* a, const float* v, float* out, int64_t n, int64_t m, int64_t k,
                  int vec, int device, void* stream) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n >= INT32_MAX || m >= INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bvec = k % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  for (int64_t col0 = 0; col0 < k; col0 += kMMGroup) {
    const int kc = static_cast<int>(k - col0 < kMMGroup ? k - col0 : kMMGroup);
    const int res = launch_group<false>(a, v, out, n, m, k, static_cast<int>(col0), kc, 0, tiles,
                                        vec == 4, bvec, device, s);
    if (res != 0) return res;
  }
  return 0;
}

// out (m, k) = A (n, m)^T @ U (n, k) through partial (ceil(n / rows_per_slab),
// m, min(k, 32)), in groups of 32 columns. rows_per_slab is a multiple of 32
// (a slab is whole stages). Needs n, m < 2^31.
int pm_rmatmat_f32(const float* a, const float* u, float* partial, float* out, int64_t n,
                   int64_t m, int64_t k, int64_t rows_per_slab, int vec, int device,
                   void* stream) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n >= INT32_MAX || m >= INT32_MAX || rows_per_slab <= 0 || rows_per_slab % kStageK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bvec = k % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  const int64_t slabs = (n + rows_per_slab - 1) / rows_per_slab;
  const int64_t items = slabs * ((m + kTile - 1) / kTile);
  for (int64_t col0 = 0; col0 < k; col0 += kMMGroup) {
    const int kc = static_cast<int>(k - col0 < kMMGroup ? k - col0 : kMMGroup);
    const int res = launch_group<true>(a, u, partial, n, m, k, static_cast<int>(col0), kc,
                                       rows_per_slab, items, vec == 4, bvec, device, s);
    if (res != 0) return res;
    rmatmat_finish_kernel<<<static_cast<unsigned>((m * kc + 255) / 256), 256, 0, s>>>(
        partial, out, slabs, m, k, static_cast<int>(col0), kc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
