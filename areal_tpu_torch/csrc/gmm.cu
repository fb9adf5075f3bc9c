// Grouped matrix multiply (the dropless MoE FFN's GEMM) for Hopper (sm_90a),
// called through ctypes.
//
// Replaces the TPU kernel jax.experimental.pallas.ops.tpu.megablox.gmm as
// areal_tpu/models/moe.py calls it (imported at :146; the three calls at
// :227, :228 and :230), with preferred_element_type=f32 and
// transpose_rhs=False. The function: the rows of lhs [M, k] come sorted by
// group, group g owning the group_sizes[g] rows after the rows of groups
// 0..g-1; each row is multiplied by its group's matrix rhs[g] [k, n] (n
// contiguous: the JAX package's [E, in, out] expert stacks as they are) and
// out [M, n] is f32. Rows at or past sum(group_sizes) are written as exact
// zeros (megablox leaves them uninitialized and the caller masks them).
//
// What bounds it. At decode (M = 256 routed rows of 32 slots x top-8 over
// 128 experts, ~112 experts touched, ~2 rows each) each call reads ~112 x k
// x n x 2 bytes of weights for 2 x 256 x k x n flops: ~1 flop per byte,
// bytes-bound (0.107 ms at 3.35 TB/s at Qwen3-30B-A3B's widths). At a
// prefill group of 8 x 512 tokens (M = 32,768, ~256 rows a group) 103 GFLOP
// (0.10 ms at the bf16 tensor-core peak) against ~0.64 GB moved (0.19 ms),
// bytes-bound at the card's peaks; in training (M = 49,152 and 8,192)
// likewise. In practice the copies into shared memory hold it: each 128 x
// 128 tile reads its rows and its expert's [k, 128] slice again (~2.4 GB
// through L2 at prefill), and with the MMAs skipped it keeps 85-99% of its
// time at every shape.
//
// Work items (every path): (group, row tile), each group tiled from its own
// first row, so no tile straddles two groups and no two blocks write one
// row: no atomics, the same bits on every call. There are at most M / tile
// + E + 1 such items, which the host knows without reading group_sizes, so
// the grid is sized with no host sync: blockIdx.y is the item, blockIdx.x
// the tile of output columns. Every block scans group_sizes (one warp,
// prefix sums of rows and of tiles in shared memory) and binary-searches
// its item; the items past the last real one zero the rows past
// sum(group_sizes), the rest exit. ops/gmm.py fwd_schedule is the plain
// twin of this walk, gmm_tiled the product it drives.
//
// bf16 (the model's path): wgmma with the f32 accumulators in registers, 8
// warps (two warpgroups) a block, 128 output columns a block, the reduction
// in 64-wide k steps over a cp.async ring into the 128-byte-swizzled layout
// the tensor cores read (both operands as they lie in memory: lhs rows
// K-major, rhs[g] [k, n] MN-major through the descriptor's transpose bit;
// rows past the group's end and columns past k or n zero-filled by the copy
// and never stored), the f32 result staged in shared memory and stored 16
// bytes a thread. One kernel, gmm_fwd_kernel<kTile>, in two regimes picked
// by the wrapper (ops/gmm.py pick_bf16_tile) from M and E:
//   - tiles (kTile 128 or 64, the groups average 16 rows or more: prefill
//     and training): output tiles of 128 rows where the groups average 64
//     or more, else 64; each warpgroup m64n128k16 on 64 of 128 rows
//     (m64n64k16 on 64 of the 128 columns of a 64-row tile); a 3-stage
//     ring, two blocks an SM;
//   - roles swapped (kTile 16, the groups average fewer than 16
//     rows: decode): out[a:b]^T = rhs[g]^T lhs[a:b]^T, so n takes the
//     instruction's 64-row side (rhs[g] read MN-major as A, each warpgroup
//     64 of the block's columns) and the item's 16 rows its n side
//     (m64n16k16; m64n8k16 for an item of 8 rows or fewer: a group of 2
//     rows wastes 6 of 8 columns, not 62 of 64); a 4-stage ring of 64 k x
//     128 n weights (16 KB a stage), so two blocks an SM keep ~96 KB of
//     weights in flight.
// Measured on an H100 80GB HBM3 at 700 W by CUDA-graph replay
// (chip_smoke.py kernel_gmm and --gmm-times, Qwen3-30B-A3B's experts, gate
// / up and down): decode (M = 256) ~0.121 / 0.122 ms, 89% of the bytes
// bound (m16n8k16 mma.sync with the roles swapped: 0.131 / 0.130); prefill
// (M = 32,768) 0.29 / 0.33 ms, train (M = 49,152) 0.39 / 0.45 ms, 1.5x its
// bound at prefill (mma.sync on 128 x 128 tiles: 0.41 / 0.45 and 0.57 /
// 0.62; on 128 x 256 tiles, one block an SM: 0.45 / 0.49). The output's
// bits equal the WMMA kernel's it replaced (the same k16 summation order).
// f32 (the f32 twins: gmm_fwd_f32_kernel): output tiles of kTM (16, 32 or
// 64) x 64, a 2-stage ring of 128-byte-wide k tiles, the products on the
// CUDA cores in f32 (thread t owns column t % 64 of every other row).
// What it does not do yet: TMA, warp specialisation (the MMAs of a step are
// waited for before the next), a persistent tile scheduler.
//
// lhs and rhs are both bf16 or both f32; k and n multiples of 8; E <= 512.
//
// The same file holds the backward (gmm_bwd_lhs and tgmm, below, on
// mma.sync). It shares the forward's group scan and work-item search; its
// f32 path also shares the forward's f32 tile stores (store_tile), and its
// bf16 path the forward's epilogue, a 128-wide tile staged in shared memory
// and stored 16 bytes a thread (stage_acc, store_out).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// bf16, kThreads (the f32 paths' 4 warps), kFull, the cp.async copies,
// ldmatrix, mma16816 and pack_bf16
#include "flash_mma.cuh"

namespace {

constexpr int kTN = 64;        // output columns per block
constexpr int kMaxE = 512;     // groups a block scans in shared memory

template <typename T>
struct Tile {
  static constexpr int kV = 16 / sizeof(T);   // values per 16-byte copy
  static constexpr int kTK = 128 / sizeof(T); // k per stage: 128-byte rows
  static constexpr int kPad = kV;             // row padding: keeps rows 16-byte aligned
  static constexpr int kLdA = kTK + kPad;
  static constexpr int kLdB = kTN + kPad;
  static constexpr int kLdC = kTN + 4;        // f32 staging of the output tile
};

// Prefix sums of rows and of row tiles of kTM rows, one warp: lane l sums a
// run of groups, a shuffle scan gives each run its start. s_off[g] is the
// first row of group g (s_off[E] = rows in all), s_tile[g] its first work
// item (s_tile[E] = items in all).
template <int kTM>
__device__ __forceinline__ void scan_groups(const int* __restrict__ group_sizes, int E, int* s_off,
                                            int* s_tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp != 0) return;
  const int per = (E + 31) / 32;
  const int g0 = min(lane * per, E), g1 = min(g0 + per, E);
  int rows = 0, tiles = 0;
  for (int g = g0; g < g1; ++g) {
    const int s = max(group_sizes[g], 0);
    rows += s;
    tiles += (s + kTM - 1) / kTM;
  }
  int r_inc = rows, t_inc = tiles;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int r = __shfl_up_sync(kFull, r_inc, d), t = __shfl_up_sync(kFull, t_inc, d);
    if (lane >= d) {
      r_inc += r;
      t_inc += t;
    }
  }
  int r = r_inc - rows, t = t_inc - tiles;
  for (int g = g0; g < g1; ++g) {
    s_off[g] = r;
    s_tile[g] = t;
    const int s = max(group_sizes[g], 0);
    r += s;
    t += (s + kTM - 1) / kTM;
  }
  if (lane == 31) {
    s_off[E] = r_inc;
    s_tile[E] = t_inc;
  }
}

// The rows [r0, r_end) of work item `item` of the (group, row tile) list
// and its group; -1 for an item past the real ones, whose rows are the
// next kTM past sum(group_sizes) (to be zeroed). r0 >= r_end: nothing to do.
template <int kTM>
__device__ __forceinline__ int find_item(int item, int M, int E, const int* s_off, const int* s_tile, int& r0,
                                         int& r_end) {
  if (item >= s_tile[E]) {
    r0 = min(s_off[E], M) + (item - s_tile[E]) * kTM;
    r_end = min(r0 + kTM, M);
    return -1;
  }
  // the group of this item: the first g with s_tile[g + 1] > item
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (s_tile[mid + 1] > item) hi = mid;
    else lo = mid + 1;
  }
  r0 = s_off[lo] + (item - s_tile[lo]) * kTM;
  r_end = min(min(s_off[lo + 1], r0 + kTM), M);  // r0 >= r_end only where sum(group_sizes) > M
  return lo;
}

__device__ __forceinline__ void store4(float* dst, float4 v) { *reinterpret_cast<float4*>(dst) = v; }

__device__ __forceinline__ void store4(bf16* dst, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(dst) = u;
}

// Zeros into rows [r0, r_end) x columns [c0, c0 + kTN) of a [*, ld] output.
template <typename TO, int kRows>
__device__ __forceinline__ void store_zeros(TO* out, int r0, int r_end, int c0, int ld) {
  for (int i = threadIdx.x; i < kRows * kTN / 4; i += kThreads) {
    const int r = i / (kTN / 4), c = (i % (kTN / 4)) * 4;
    if (r0 + r < r_end && c0 + c < ld)
      store4(out + static_cast<int64_t>(r0 + r) * ld + c0 + c, make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// An f32 tile Cs [kRows, ldc] into rows [r0, r_end) x columns [c0, c0 + kTN)
// of a [*, ld] output of type TO (f32, or bf16 rounded to nearest).
template <typename TO, int kRows>
__device__ __forceinline__ void store_tile(TO* out, const float* Cs, int ldc, int r0, int r_end, int c0, int ld) {
  for (int i = threadIdx.x; i < kRows * kTN / 4; i += kThreads) {
    const int r = i / (kTN / 4), c = (i % (kTN / 4)) * 4;
    if (r0 + r < r_end && c0 + c < ld)
      store4(out + static_cast<int64_t>(r0 + r) * ld + c0 + c, *reinterpret_cast<const float4*>(Cs + r * ldc + c));
  }
}

template <typename T, int kTM>
struct Smem {
  static constexpr int kStageA = kTM * Tile<T>::kLdA;
  static constexpr int kStageB = Tile<T>::kTK * Tile<T>::kLdB;
  static constexpr size_t kAB = sizeof(T) * 2 * (kStageA + kStageB);
  static constexpr size_t kC = sizeof(float) * kTM * Tile<T>::kLdC;
  static constexpr size_t kBytes = kAB > kC ? kAB : kC;  // the output tile reuses the stages
};

// One stage: the [kTM, kTK] lhs tile of rows r0.. (rows >= r_end zero) and
// the [kTK, kTN] tile of rhs[g] at (k0, n0).
template <typename T, int kTM>
__device__ __forceinline__ void load_stage(T* As, T* Bs, const T* lhs, const T* rhs_g, int r0,
                                           int r_end, int k0, int n0, int k, int n) {
  using TL = Tile<T>;
  constexpr int kVecRowA = TL::kTK / TL::kV;  // 8
  constexpr int kVecA = kTM * kVecRowA;
#pragma unroll
  for (int i = threadIdx.x; i < kVecA; i += kThreads) {
    const int r = i / kVecRowA, c = (i % kVecRowA) * TL::kV;
    const bool ok = r0 + r < r_end && k0 + c < k;
    const T* src = ok ? lhs + static_cast<int64_t>(r0 + r) * k + k0 + c : lhs;
    cp_async16(As + r * TL::kLdA + c, src, ok);
  }
  constexpr int kVecRowB = kTN / TL::kV;
  constexpr int kVecB = TL::kTK * kVecRowB;
#pragma unroll
  for (int i = threadIdx.x; i < kVecB; i += kThreads) {
    const int r = i / kVecRowB, c = (i % kVecRowB) * TL::kV;
    const bool ok = k0 + r < k && n0 + c < n;
    const T* src = ok ? rhs_g + static_cast<int64_t>(k0 + r) * n + n0 + c : rhs_g;
    cp_async16(Bs + r * TL::kLdB + c, src, ok);
  }
}

// The f32 path: thread t owns column t % 64 of rows t / 64, t / 64 + 2, ...
template <int kTM>
struct Fma {
  static constexpr int kRows = kTM * kTN / kThreads;
  float acc[kRows];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
  }
  __device__ __forceinline__ void step(const float* As, const float* Bs, int) {
    using TL = Tile<float>;
    const int col = threadIdx.x % kTN, r0 = threadIdx.x / kTN;
#pragma unroll 8
    for (int kk = 0; kk < TL::kTK; ++kk) {
      const float b = Bs[kk * TL::kLdB + col];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = fmaf(As[(r0 + j * (kThreads / kTN)) * TL::kLdA + kk], b, acc[j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs, int) {
    const int col = threadIdx.x % kTN, r0 = threadIdx.x / kTN;
#pragma unroll
    for (int j = 0; j < kRows; ++j) Cs[(r0 + j * (kThreads / kTN)) * Tile<float>::kLdC + col] = acc[j];
  }
};

// the f32 forward (the f32 twins): Fma<kTM> on tiles of kTM x 64
template <int kTM>
__global__ void __launch_bounds__(kThreads)
gmm_fwd_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs, const int* __restrict__ group_sizes,
                   float* __restrict__ out, int M, int k, int n, int E) {
  using T = float;
  using TL = Tile<T>;
  using SM = Smem<T, kTM>;
  __shared__ __align__(128) unsigned char smem[SM::kBytes];
  __shared__ int s_off[kMaxE + 1];   // first row of each group (s_off[E] = rows in all)
  __shared__ int s_tile[kMaxE + 1];  // first work item of each group (s_tile[E] = items)
  const int warp = threadIdx.x / 32;

  scan_groups<kTM>(group_sizes, E, s_off, s_tile);
  __syncthreads();

  const int n0 = blockIdx.x * kTN;
  float* Cs = reinterpret_cast<float*>(smem);
  int r0, r_end;
  const int g = find_item<kTM>(blockIdx.y, M, E, s_off, s_tile, r0, r_end);
  if (r0 >= r_end) return;
  if (g < 0) {  // past the real items: zero the rows past sum(group_sizes)
    store_zeros<float, kTM>(out, r0, r_end, n0, n);
    return;
  }

  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + 2 * SM::kStageA;
  const T* rhs_g = rhs + static_cast<int64_t>(g) * k * n;
  Fma<kTM> acc;
  acc.zero();
  const int nk = (k + TL::kTK - 1) / TL::kTK;
  if (nk > 0) {
    load_stage<T, kTM>(As, Bs, lhs, rhs_g, r0, r_end, 0, n0, k, n);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk)
      load_stage<T, kTM>(As + (cur ^ 1) * SM::kStageA, Bs + (cur ^ 1) * SM::kStageB, lhs, rhs_g, r0, r_end,
                         (kt + 1) * TL::kTK, n0, k, n);
    cp_async_commit();  // an empty group on the last step keeps the count
    cp_async_wait<1>();  // stage `cur` has landed
    __syncthreads();
    acc.step(As + cur * SM::kStageA, Bs + cur * SM::kStageB, warp);
    __syncthreads();  // before the next step's copy overwrites `cur`
  }
  cp_async_wait<0>();
  __syncthreads();
  acc.store(Cs, warp);
  __syncthreads();
  store_tile<float, kTM>(out, Cs, TL::kLdC, r0, r_end, n0, n);
}

// ---------------------------------------------------------------------------
// The backward: megablox's custom VJP (jax/experimental/pallas/ops/tpu/
// megablox/ops.py:63 _gmm_bwd) runs two Pallas kernels, each ported here.
//
// Mixed precision. The forward returns f32, so the cotangent `grad` arrives
// in f32 while lhs and rhs are bf16; megablox then multiplies in f32
// (common.py:54 select_input_dtype widens the bf16 operand). A bf16 MMA on
// bf16(grad) would drop ~8 bits of every grad element. Instead each grad
// value is split into hi = bf16(grad) and lo = bf16(grad - hi), and two
// bf16 MMAs (lo, then hi, times the same exact bf16 operand) accumulate into
// one f32 fragment: each product is exact in f32, and what the split drops
// is at most 2^-16 |grad| an element (u = 2^-8 of bf16, squared). That is
// twice the MMA work of a bf16 product, still on the tensor cores. With f32
// operands (the f32 twins) the tiles are multiplied on the CUDA cores in
// f32, as the forward does.
//
// What bounds them: 2 M k n flops (twice that in split MMAs) against the
// f32 cotangent, the bf16 operand and the output. At the training shapes
// (M = T x top-8 ~ 50k rows, ~400 rows a group) the bytes at the card's
// peaks (tgmm's bf16 output alone is 403 MB at Qwen3-30B-A3B's gate / up);
// in practice the work around the MMAs. Timed by chip_smoke.py's
// kernel_gmm_bwd on an H100 80GB HBM3 at 700 W, by graph replay at M =
// 49,152 (bf16 out): 0.99-1.04 ms each, 30-31% of the bf16 peak, ~4x the
// bound. With the global copies skipped they take 71-81% of that, with the
// MMAs skipped 58-74%: the MMAs and the copies, fragment reads and split
// around them each hold about as much. The same function as one
// torch._grouped_mm on hi and lo side by side (wgmma, TMA) takes 0.54-0.60.
//
// The bf16-operand path of both kernels (flash_mma.cuh's helpers):
//   - 8 warps a block on an output tile of 128 (dLHS also 64) x 128, each
//     warp a 16 x 128 (dLHS) or 128 x 16 (tgmm) piece of it in m16n8k16
//     mma.sync fragments, its f32 accumulators in registers: no two warps
//     share cotangent values (dLHS's 64-row tiles: two), so each is split
//     once a block;
//   - the reduction in steps of kRS = 64 over a 2-stage cp.async ring with
//     one barrier a step: step t + 1's copy goes out while step t is
//     multiplied. Two blocks an SM matter most: every shape of ring that
//     left one block an SM (a deeper ring, wider tiles, more registers) was
//     slower on the H100 (PERF.md);
//   - the cotangent is split in registers: each warp reads the f32 values of
//     its fragments from the staged tile and rounds them to packed hi / lo
//     pairs right before its MMAs (split2); there is no split pass through
//     shared memory and no barrier for one. The bf16 operand comes by
//     ldmatrix;
//   - the output tile goes through shared memory (the ring's space) and out
//     as 16-byte stores, rounded once to the output dtype.
// What they do not do yet: wgmma, TMA, warp specialisation, a persistent
// schedule.
// ---------------------------------------------------------------------------

constexpr int kTR = 32;        // reduction step of the f32 path: n (dLHS), rows (tgmm)
constexpr int kLdC = kTN + 4;  // the f32 path's staging of an output tile

// the rows [a, b) of group g, clamped to M: warp 0 sums group_sizes[0..g)
__device__ __forceinline__ void group_rows(const int* __restrict__ group_sizes, int g, int M, int* s_rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp != 0) return;
  int s = 0;
  for (int i = lane; i < g; i += 32) s += max(group_sizes[i], 0);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
  if (lane == 0) {
    s_rows[0] = min(s, M);
    s_rows[1] = min(s + max(group_sizes[g], 0), M);
  }
}

// ---------------------------------------------------------------------------
// gmm_bwd_lhs: dLHS of the grouped matmul, megablox gmm.py:314 gmm called
// with transpose_rhs=True. For each group g and each of its rows r:
//   out[r, :k] = grad[r, :n] @ rhs[g]^T      (rhs[g] [k, n], n contiguous)
// out in f32 or bf16 (lhs's dtype, as _gmm_bwd passes lhs[0].dtype), rows
// at or past sum(group_sizes) exact zeros.
//
// Both paths keep the forward's work items, (group, row tile): M / tile +
// E + 1 of them, sized from the shapes (no host sync) and found by the same
// scan and binary search, so no tile straddles two groups; spare items zero
// the rows past the groups. The reduction over n runs inside the block, and
// rhs[g] as it lies in memory ([k, n], n contiguous) is already the "col" B
// operand, so no transposed copy of the weight stack is ever made.
//
// bf16 rhs (gmm_bwd_lhs_kernel): a block owns kBM rows x 128 columns (of
// k). The row tile is 128 where the groups average 128 rows or more (the
// training shapes: ~384), else 64 (a 128-row tile would be mostly the
// zero rows past a group's end). Measured on the H100 at M = 8,192 over 128
// groups (64 rows a group on average), 64-row tiles take 0.267 / 0.270 ms
// at gate/up / down against 0.300 / 0.294 on 128-row tiles (chip_smoke.py
// --gmm-bwd-times, PERF.md). Warp w owns 16 rows and all 128 columns
// (64-row tiles: 16 rows, 64 columns); its grad fragment values are float2
// reads of a row (the stage's rows padded to 8 mod 32 words: conflict-free),
// its rhs fragments ldmatrix reads of rhs[g]'s rows. The grad rows are
// read once for each 128 output columns (16 times at gate / up's k =
// 2,048).
// f32 rhs (gmm_bwd_lhs_f32_kernel, the f32 twins): output tiles of kTM x
// 64, two cp.async stages of the grad [kTM, 32] and rhs[g] [64, 32], thread
// t owning output column t % 64 of every other row.
// ---------------------------------------------------------------------------

struct LhsTile {  // the f32 path's stages
  static constexpr int kLdB = kTR + 4;  // staged rhs rows (k) of kTR n-values
  static constexpr int kLdG = kTR + 4;  // staged grad rows
};

template <int kTM>
struct LhsSmem {
  static constexpr int kStageG = kTM * LhsTile::kLdG;  // floats
  static constexpr int kStageB = kTN * LhsTile::kLdB;  // floats
  static constexpr size_t kAB = sizeof(float) * 2 * (kStageG + kStageB);
  static constexpr size_t kC = sizeof(float) * kTM * kLdC;
  static constexpr size_t kBytes = kAB > kC ? kAB : kC;  // the output tile reuses the stages
};

template <int kTM>
__device__ __forceinline__ void load_lhs_stage(float* Gs, float* Bs, const float* grad, const float* rhs_g, int r0,
                                               int r_end, int j0, int c0, int k, int n) {
  constexpr int kVecRow = kTR / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kTM * kVecRow; i += kThreads) {
    const int r = i / kVecRow, j = (i % kVecRow) * 4;
    const bool ok = r0 + r < r_end && j0 + j < n;
    const float* src = ok ? grad + static_cast<int64_t>(r0 + r) * n + j0 + j : grad;
    cp_async16(Gs + r * LhsTile::kLdG + j, src, ok);
  }
#pragma unroll
  for (int i = threadIdx.x; i < kTN * kVecRow; i += kThreads) {
    const int c = i / kVecRow, j = (i % kVecRow) * 4;
    const bool ok = c0 + c < k && j0 + j < n;
    const float* src = ok ? rhs_g + static_cast<int64_t>(c0 + c) * n + j0 + j : rhs_g;
    cp_async16(Bs + c * LhsTile::kLdB + j, src, ok);
  }
}

// thread t owns output column t % 64 of rows t / 64, t / 64 + 2, ...
template <int kTM>
struct LhsFma {
  static constexpr int kRows = kTM * kTN / kThreads;
  float acc[kRows];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
  }
  __device__ __forceinline__ void step(const float* Gs, const float* Bs) {
    const int col = threadIdx.x % kTN, r0 = threadIdx.x / kTN;
#pragma unroll 8
    for (int jj = 0; jj < kTR; ++jj) {
      const float b = Bs[col * LhsTile::kLdB + jj];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        acc[j] = fmaf(Gs[(r0 + j * (kThreads / kTN)) * LhsTile::kLdG + jj], b, acc[j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs) {
    const int col = threadIdx.x % kTN, r0 = threadIdx.x / kTN;
#pragma unroll
    for (int j = 0; j < kRows; ++j) Cs[(r0 + j * (kThreads / kTN)) * kLdC + col] = acc[j];
  }
};

template <typename TO, int kTM>
__global__ void __launch_bounds__(kThreads)
gmm_bwd_lhs_f32_kernel(const float* __restrict__ grad, const float* __restrict__ rhs,
                       const int* __restrict__ group_sizes, TO* __restrict__ out, int M, int k, int n, int E) {
  using SM = LhsSmem<kTM>;
  __shared__ __align__(128) unsigned char smem[SM::kBytes];
  __shared__ int s_off[kMaxE + 1];
  __shared__ int s_tile[kMaxE + 1];

  scan_groups<kTM>(group_sizes, E, s_off, s_tile);
  __syncthreads();

  const int c0 = blockIdx.x * kTN;  // output columns: a tile of k
  int r0, r_end;
  const int g = find_item<kTM>(blockIdx.y, M, E, s_off, s_tile, r0, r_end);
  if (r0 >= r_end) return;
  if (g < 0) {  // past the real items: zero the rows past sum(group_sizes)
    store_zeros<TO, kTM>(out, r0, r_end, c0, k);
    return;
  }

  float* Gs = reinterpret_cast<float*>(smem);
  float* Bs = Gs + 2 * SM::kStageG;
  const float* rhs_g = rhs + static_cast<int64_t>(g) * k * n;
  LhsFma<kTM> acc;
  acc.zero();
  const int nt = (n + kTR - 1) / kTR;
  if (nt > 0) {
    load_lhs_stage<kTM>(Gs, Bs, grad, rhs_g, r0, r_end, 0, c0, k, n);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    if (t + 1 < nt)
      load_lhs_stage<kTM>(Gs + (cur ^ 1) * SM::kStageG, Bs + (cur ^ 1) * SM::kStageB, grad, rhs_g, r0, r_end,
                          (t + 1) * kTR, c0, k, n);
    cp_async_commit();
    cp_async_wait<1>();  // stage `cur` has landed
    __syncthreads();
    acc.step(Gs + cur * SM::kStageG, Bs + cur * SM::kStageB);
    __syncthreads();  // before the next copy overwrites what this step read
  }
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  acc.store(Cs);
  __syncthreads();
  store_tile<TO, kTM>(out, Cs, kLdC, r0, r_end, c0, k);
}

// ---------------------------------------------------------------------------
// tgmm: dRHS of the grouped matmul, megablox gmm.py:573 tgmm (with
// num_actual_groups = E and visit_empty_groups). For each group g:
//   out[g] [k, n] = lhs[a:b]^T @ grad[a:b]   over the group's rows [a, b)
// out in f32 or bf16 (rhs's dtype); an empty group's matrix is zeros.
//
// Both paths: one block per (n tile, k tile, group), from the shapes. Each
// block finds its group's rows (a warp sums group_sizes[0..g)) and loops
// over them, so the whole reduction over rows stays in one block: no
// atomics, no second pass, a deterministic result, and an empty group
// writes zeros. The n tiles of one group's k tile run side by side, so
// they share the group's rows in L2.
//
// bf16 lhs (tgmm_kernel): 128 x 128 output tiles, warp w owning all 128
// rows (of k) and 16 columns (of n). The reduction runs over rows, which is
// the strided direction of both stages: lhs[a:b]^T comes by ldmatrix.trans
// from the row-major stage, and the cotangent's fragment pairs (two rows,
// one column) are gathered as single f32 reads. The f32 stage's rows are
// padded to 4 mod 32 words, so a warp's gather (rows 2 t4 + {0, 1, 8, 9},
// columns g8) hits 32 distinct banks, and each value is split in
// registers, once a block (no two warps share a column). The other
// choice, a split pass writing hi / lo once for all 8 warps and read by
// ldmatrix.trans, reads the f32 stage as often, then writes and reads 4
// bytes of halves a value more through shared memory, and needs a second
// barrier a step; the gathers cost each warp 8 shared reads and 4 split
// pairs a 16-row step, beside its 32 MMAs. Measured on the H100 (chip_smoke.py
// --gmm-bwd-times, PERF.md): a split pass in place (each thread's 8 f32
// values rewritten as 16 bytes of hi then 16 of lo) takes 1.26 ms at the
// train shapes against 0.99-1.00 for the gathers, 19-27% slower at every
// shape; and this grid is 5-6% faster than 2 x 4 warps of 64 x 32, which
// split each value twice.
// f32 lhs (tgmm_f32_kernel, the f32 twins): 64 x 64 output tiles in two
// cp.async stages of 32 rows, thread t owning output column t % 64 of
// every other row.
// ---------------------------------------------------------------------------

constexpr int kTKo = 64;  // the f32 path's output rows (of k) a block

struct TgTile {  // the f32 path's stages
  static constexpr int kLdA = kTKo + 4;  // staged lhs rows of 64 k-values
  static constexpr int kLdG = kTN + 4;   // staged grad rows
};

struct TgSmem {
  static constexpr int kStageA = kTR * TgTile::kLdA;  // floats
  static constexpr int kStageG = kTR * TgTile::kLdG;  // floats
  static constexpr size_t kAB = sizeof(float) * 2 * (kStageA + kStageG);
  static constexpr size_t kC = sizeof(float) * kTKo * kLdC;
  static constexpr size_t kBytes = kAB > kC ? kAB : kC;
};

__device__ __forceinline__ void load_tgmm_stage(float* As, float* Gs, const float* lhs, const float* grad, int r0,
                                                int r_end, int c0, int j0, int k, int n) {
  constexpr int kVecRowA = kTKo / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kTR * kVecRowA; i += kThreads) {
    const int r = i / kVecRowA, c = (i % kVecRowA) * 4;
    const bool ok = r0 + r < r_end && c0 + c < k;
    const float* src = ok ? lhs + static_cast<int64_t>(r0 + r) * k + c0 + c : lhs;
    cp_async16(As + r * TgTile::kLdA + c, src, ok);
  }
  constexpr int kVecRowG = kTN / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kTR * kVecRowG; i += kThreads) {
    const int r = i / kVecRowG, j = (i % kVecRowG) * 4;
    const bool ok = r0 + r < r_end && j0 + j < n;
    const float* src = ok ? grad + static_cast<int64_t>(r0 + r) * n + j0 + j : grad;
    cp_async16(Gs + r * TgTile::kLdG + j, src, ok);
  }
}

// thread t owns output column t % 64 of rows t / 64, t / 64 + 2, ...
struct TgFma {
  static constexpr int kRows = kTKo * kTN / kThreads;
  float acc[kRows];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
  }
  __device__ __forceinline__ void step(const float* As, const float* Gs) {
    const int col = threadIdx.x % kTN, c0 = threadIdx.x / kTN;
#pragma unroll 4
    for (int rr = 0; rr < kTR; ++rr) {
      const float gv = Gs[rr * TgTile::kLdG + col];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        acc[j] = fmaf(As[rr * TgTile::kLdA + c0 + j * (kThreads / kTN)], gv, acc[j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs) {
    const int col = threadIdx.x % kTN, c0 = threadIdx.x / kTN;
#pragma unroll
    for (int j = 0; j < kRows; ++j) Cs[(c0 + j * (kThreads / kTN)) * kLdC + col] = acc[j];
  }
};

template <typename TO>
__global__ void __launch_bounds__(kThreads)
tgmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ grad, const int* __restrict__ group_sizes,
                TO* __restrict__ out, int M, int k, int n, int E) {
  __shared__ __align__(128) unsigned char smem[TgSmem::kBytes];
  __shared__ int s_rows[2];
  const int g = blockIdx.z, c0 = blockIdx.y * kTKo, j0 = blockIdx.x * kTN;
  group_rows(group_sizes, g, M, s_rows);
  __syncthreads();
  const int a = s_rows[0], b = s_rows[1];

  float* As = reinterpret_cast<float*>(smem);
  float* Gs = As + 2 * TgSmem::kStageA;
  TgFma acc;
  acc.zero();
  const int nt = (b - a + kTR - 1) / kTR;  // 0 for an empty group: zeros out
  if (nt > 0) {
    load_tgmm_stage(As, Gs, lhs, grad, a, b, c0, j0, k, n);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    if (t + 1 < nt)
      load_tgmm_stage(As + (cur ^ 1) * TgSmem::kStageA, Gs + (cur ^ 1) * TgSmem::kStageG, lhs, grad,
                      a + (t + 1) * kTR, b, c0, j0, k, n);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    acc.step(As + cur * TgSmem::kStageA, Gs + cur * TgSmem::kStageG);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  acc.store(Cs);
  __syncthreads();
  store_tile<TO, kTKo>(out + static_cast<int64_t>(g) * k * n, Cs, kLdC, c0, k, j0, n);
}

// ---------------------------------------------------------------------------
// The bf16-operand path: mma.sync on 128-wide tiles, the cotangent split in
// registers.
// ---------------------------------------------------------------------------

constexpr int kMWarps = 8;
constexpr int kMThreads = kMWarps * 32;
constexpr int kBN = 128;       // output columns of a block
constexpr int kLdO = kBN + 8;  // staged output rows: 8 mod 32 words, a half-warp's float2 writes conflict-free

// a pair of f32 values -> hi = bf16(x) and lo = bf16(x - hi) of each, packed
// as two MMA fragment registers (the first value in the low half)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x, y);
  lo = pack_bf16(x - __uint_as_float(hi << 16), y - __uint_as_float(hi & 0xffff0000u));
}

// 16 bytes of output from 4 (f32) or 8 (bf16) staged f32 values, zeros for
// a null source
__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = src ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void store16(bf16* dst, const float* src) {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (src) {
    const float4 a = *reinterpret_cast<const float4*>(src), b = *reinterpret_cast<const float4*>(src + 4);
    u = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
  *reinterpret_cast<uint4*>(dst) = u;
}

// rows [r0, r_end) x columns [c0, c0 + kBN) of a [*, ld] output from the
// staged tile Cs [kRows, kLdO] (zeros for a null Cs), 16 bytes a thread
template <typename TO, int kRows>
__device__ __forceinline__ void store_out(TO* out, const float* Cs, int r0, int r_end, int c0, int ld) {
  constexpr int kV = 16 / sizeof(TO);
  constexpr int kPerRow = kBN / kV;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kMThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kV;
    if (r0 + r < r_end && c0 + c < ld)
      store16(out + static_cast<int64_t>(r0 + r) * ld + c0 + c, Cs ? Cs + r * kLdO + c : nullptr);
  }
}

// a warp's accumulators, kF row fragments of 16 x kN column tiles of 8, into
// the staged tile at (row0, col0)
template <int kF, int kN>
__device__ __forceinline__ void stage_acc(float* Cs, float (&acc)[kF][kN][4], int row0, int col0) {
  const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int f = 0; f < kF; ++f)
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      float* p = Cs + (row0 + 16 * f + gid) * kLdO + col0 + 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(p) = make_float2(acc[f][j][0], acc[f][j][1]);
      *reinterpret_cast<float2*>(p + 8 * kLdO) = make_float2(acc[f][j][2], acc[f][j][3]);
    }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  // cheap, and per device: set before every launch rather than cached
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

// A thread's share of one operand's stage copy. The stage holds kRows rows
// of kVec 16-byte chunks; thread t copies chunks t, t + kMThreads, ...,
// which lie in one column (kMThreads is a multiple of kVec), kStep rows
// apart. So its column and first row are fixed for the whole loop, and a
// stage costs it one pointer step and one row test a chunk.
template <typename T, int kRows, int kVec, int kLd>
struct CopyPlan {
  static constexpr int kStep = kMThreads / kVec;         // rows between a thread's chunks
  static constexpr int kPer = kRows * kVec / kMThreads;  // chunks a thread
  static_assert(kMThreads % kVec == 0 && kRows % kStep == 0, "whole chunks a thread");
  const int row = threadIdx.x / kVec, col = (threadIdx.x % kVec) * (16 / sizeof(T));

  // rows [0, kRows) of the tile at src (a row every ld elements) into dst;
  // rows at or past rows_ok, and the thread's column unless col_ok, are
  // zero-filled (base: a valid address to name when nothing is read)
  __device__ __forceinline__ void copy(T* dst, const T* src, int64_t ld, int rows_ok, bool col_ok,
                                       const T* base) const {
    const T* p = src + row * ld + col;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const bool ok = col_ok && row + u * kStep < rows_ok;
      cp_async16(dst + (row + u * kStep) * kLd + col, ok ? p + u * kStep * ld : base, ok);
    }
  }
};

template <int kBM>
struct LhsCfg {
  static constexpr int kWR = kBM / 16;          // warps down the rows
  static constexpr int kWM = kBM / kWR;         // rows a warp: 16
  static constexpr int kFM = kWM / 16;          // its row fragments
  static constexpr int kWC = kMWarps / kWR;     // warps across the columns
  static constexpr int kWN = kBN / kWC;         // columns a warp: 128 (kBM 128) or 64 (kBM 64)
  static constexpr int kRS = 64;                // reduction step (of n)
  static constexpr int kStages = 2;             // the cp.async ring: two stages keep two blocks an SM
  static constexpr int kLdG = kRS + 8;          // grad rows (f32): 8 mod 32 words
  static constexpr int kLdB = kRS + 8;          // rhs rows (bf16): 144 bytes, ldmatrix conflict-free
  static constexpr int kStageG = kBM * kLdG;    // floats
  static constexpr int kStageB = kBN * kLdB;    // bf16 values
  static constexpr size_t kStage = sizeof(float) * kStageG + sizeof(bf16) * kStageB;
  static constexpr size_t kRing = kStages * kStage;
  static constexpr size_t kOut = sizeof(float) * kBM * kLdO;
  static constexpr size_t kBytes = kRing > kOut ? kRing : kOut;  // the output tile reuses the ring
  static_assert(kWR * kWC == kMWarps && kWN % 16 == 0, "the warp grid");
};

// one stage: grad [kBM rows, kRS] at (r0, j0) (rows >= r_end zero) and
// rhs[g] [kBN, kRS] at (c0, j0), both as they lie in memory
template <int kBM>
__device__ __forceinline__ void load_lhs_mma_stage(unsigned char* st, const float* grad, const bf16* rhs_g, int r0,
                                                   int r_end, int j0, int c0, int k, int n) {
  using C = LhsCfg<kBM>;
  const CopyPlan<float, kBM, C::kRS / 4, C::kLdG> pg{};
  const CopyPlan<bf16, kBN, C::kRS / 8, C::kLdB> pb{};
  pg.copy(reinterpret_cast<float*>(st), grad + static_cast<int64_t>(r0) * n + j0, n, r_end - r0, j0 + pg.col < n,
          grad);
  pb.copy(reinterpret_cast<bf16*>(st + sizeof(float) * C::kStageG), rhs_g + static_cast<int64_t>(c0) * n + j0, n,
          k - c0, j0 + pb.col < n, rhs_g);
}

// one stage into a warp's accumulators: kFM row fragments of 16 x kWN / 8
// column tiles of 8, each product as lo then hi
template <int kBM>
__device__ __forceinline__ void lhs_mma_step(const unsigned char* st,
                                             float (&acc)[LhsCfg<kBM>::kFM][LhsCfg<kBM>::kWN / 8][4], int row0,
                                             int col0) {
  using C = LhsCfg<kBM>;
  const float* Gs = reinterpret_cast<const float*>(st);
  const bf16* Bs = reinterpret_cast<const bf16*>(st + sizeof(float) * C::kStageG);
  const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < C::kRS / 16; ++kk) {
    uint32_t b[C::kWN / 16][4];  // rhs[g]^T: per 16 columns, the B fragments of two n8 tiles
#pragma unroll
    for (int jj = 0; jj < C::kWN / 16; ++jj)
      ldsm_x4(b[jj], Bs + (col0 + 16 * jj + (lane & 7) + ((lane >> 4) << 3)) * C::kLdB + 16 * kk +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int f = 0; f < C::kFM; ++f) {
      const float* g0 = Gs + (row0 + 16 * f + gid) * C::kLdG + 16 * kk + 2 * tig;
      const float2 v0 = *reinterpret_cast<const float2*>(g0);
      const float2 v1 = *reinterpret_cast<const float2*>(g0 + 8 * C::kLdG);
      const float2 v2 = *reinterpret_cast<const float2*>(g0 + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(g0 + 8 * C::kLdG + 8);
      uint32_t hi[4], lo[4];
      split2(v0.x, v0.y, hi[0], lo[0]);
      split2(v1.x, v1.y, hi[1], lo[1]);
      split2(v2.x, v2.y, hi[2], lo[2]);
      split2(v3.x, v3.y, hi[3], lo[3]);
#pragma unroll
      for (int jj = 0; jj < C::kWN / 16; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma16816(acc[f][2 * jj + h], lo, b[jj][2 * h], b[jj][2 * h + 1]);
          mma16816(acc[f][2 * jj + h], hi, b[jj][2 * h], b[jj][2 * h + 1]);
        }
    }
  }
}

template <typename TO, int kBM>
__global__ void __launch_bounds__(kMThreads, 2)
gmm_bwd_lhs_kernel(const float* __restrict__ grad, const bf16* __restrict__ rhs, const int* __restrict__ group_sizes,
                   TO* __restrict__ out, int M, int k, int n, int E) {
  using C = LhsCfg<kBM>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_off[kMaxE + 1];
  __shared__ int s_tile[kMaxE + 1];

  scan_groups<kBM>(group_sizes, E, s_off, s_tile);
  __syncthreads();

  const int c0 = blockIdx.x * kBN;  // output columns: a tile of k
  int r0, r_end;
  const int g = find_item<kBM>(blockIdx.y, M, E, s_off, s_tile, r0, r_end);
  if (r0 >= r_end) return;
  if (g < 0) {  // past the real items: zero the rows past sum(group_sizes)
    store_out<TO, kBM>(out, nullptr, r0, r_end, c0, k);
    return;
  }

  const int warp = threadIdx.x / 32;
  const int row0 = C::kWM * (warp / C::kWC), col0 = C::kWN * (warp % C::kWC);
  const bf16* rhs_g = rhs + static_cast<int64_t>(g) * k * n;
  float acc[C::kFM][C::kWN / 8][4];
#pragma unroll
  for (int f = 0; f < C::kFM; ++f)
#pragma unroll
    for (int j = 0; j < C::kWN / 8; ++j) acc[f][j][0] = acc[f][j][1] = acc[f][j][2] = acc[f][j][3] = 0.f;

  const int nt = (n + C::kRS - 1) / C::kRS;
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < nt) load_lhs_mma_stage<kBM>(smem + s * C::kStage, grad, rhs_g, r0, r_end, s * C::kRS, c0, k, n);
    cp_async_commit();
  }
  int cur = 0;  // the ring slot of step t
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<C::kStages - 2>();  // this thread's copies of step t have landed
    __syncthreads();               // everyone's; and step t - 1's slot, written next, is free
    const int nx = t + C::kStages - 1, slot = cur == 0 ? C::kStages - 1 : cur - 1;
    if (nx < nt) load_lhs_mma_stage<kBM>(smem + slot * C::kStage, grad, rhs_g, r0, r_end, nx * C::kRS, c0, k, n);
    cp_async_commit();
    lhs_mma_step<kBM>(smem + cur * C::kStage, acc, row0, col0);
    cur = cur + 1 == C::kStages ? 0 : cur + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // the output tile overwrites the ring
  float* Cs = reinterpret_cast<float*>(smem);
  stage_acc(Cs, acc, row0, col0);
  __syncthreads();
  store_out<TO, kBM>(out, Cs, r0, r_end, c0, k);
}

struct TgCfg {
  static constexpr int kBK = 128;             // output rows (of k) a block
  static constexpr int kWJ = 8;               // warps across the columns
  static constexpr int kWK = kMWarps / kWJ;   // warps down the rows
  static constexpr int kWM = kBK / kWK;       // rows a warp: 128
  static constexpr int kFM = kWM / 16;        // its row fragments
  static constexpr int kWN = kBN / kWJ;       // columns a warp: 16
  static constexpr int kNJ = kWN / 8;         // its column tiles
  static constexpr int kLdA = kBK + 8;        // lhs rows (bf16): 272 bytes, ldmatrix.trans conflict-free
  static constexpr int kLdG = kBN + 4;        // grad rows (f32): 4 mod 32 words, the row-pair gathers conflict-free
  static constexpr int kRS = 64;              // reduction step (of rows)
  static constexpr int kStages = 2;           // the cp.async ring: two stages keep two blocks an SM
  static constexpr int kStageA = kRS * kLdA;  // bf16 values
  static constexpr int kStageG = kRS * kLdG;  // floats
  static constexpr size_t kStage = sizeof(bf16) * kStageA + sizeof(float) * kStageG;
  static constexpr size_t kRing = kStages * kStage;
  static constexpr size_t kOut = sizeof(float) * kBK * kLdO;
  static constexpr size_t kBytes = kRing > kOut ? kRing : kOut;
};

// one stage: lhs [kRS rows, kBK] at (r0, c0) and grad [kRS rows, kBN] at
// (r0, j0), rows >= r_end zero
__device__ __forceinline__ void load_tgmm_mma_stage(unsigned char* st, const bf16* lhs, const float* grad, int r0,
                                                    int r_end, int c0, int j0, int k, int n) {
  const CopyPlan<bf16, TgCfg::kRS, TgCfg::kBK / 8, TgCfg::kLdA> pa{};
  const CopyPlan<float, TgCfg::kRS, kBN / 4, TgCfg::kLdG> pg{};
  pa.copy(reinterpret_cast<bf16*>(st), lhs + static_cast<int64_t>(r0) * k + c0, k, r_end - r0, c0 + pa.col < k, lhs);
  pg.copy(reinterpret_cast<float*>(st + sizeof(bf16) * TgCfg::kStageA), grad + static_cast<int64_t>(r0) * n + j0, n,
          r_end - r0, j0 + pg.col < n, grad);
}

// one stage into a warp's accumulators: kFM row fragments (of k) of 16 x
// kNJ column tiles (of n) of 8, each product as lo then hi
__device__ __forceinline__ void tgmm_mma_step(const unsigned char* st, float (&acc)[TgCfg::kFM][TgCfg::kNJ][4],
                                              int row0, int col0) {
  const bf16* As = reinterpret_cast<const bf16*>(st);
  const float* Gs = reinterpret_cast<const float*>(st + sizeof(bf16) * TgCfg::kStageA);
  const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < TgCfg::kRS / 16; ++kk) {
    uint32_t hi[TgCfg::kNJ][2], lo[TgCfg::kNJ][2];  // grad's B fragments: rows 16 kk + 2 tig + {0, 1}, + {8, 9}
#pragma unroll
    for (int j = 0; j < TgCfg::kNJ; ++j) {
      const float* g0 = Gs + (16 * kk + 2 * tig) * TgCfg::kLdG + col0 + 8 * j + gid;
      split2(g0[0], g0[TgCfg::kLdG], hi[j][0], lo[j][0]);
      split2(g0[8 * TgCfg::kLdG], g0[9 * TgCfg::kLdG], hi[j][1], lo[j][1]);
    }
#pragma unroll
    for (int f = 0; f < TgCfg::kFM; ++f) {
      uint32_t a[4];  // lhs^T: the row-major stage read transposed
      ldsm_x4_t(a, As + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * TgCfg::kLdA + row0 + 16 * f +
                       ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < TgCfg::kNJ; ++j) {
        mma16816(acc[f][j], a, lo[j][0], lo[j][1]);
        mma16816(acc[f][j], a, hi[j][0], hi[j][1]);
      }
    }
  }
}

template <typename TO>
__global__ void __launch_bounds__(kMThreads, 2)
tgmm_kernel(const bf16* __restrict__ lhs, const float* __restrict__ grad, const int* __restrict__ group_sizes,
            TO* __restrict__ out, int M, int k, int n, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_rows[2];
  const int g = blockIdx.z, c0 = blockIdx.y * TgCfg::kBK, j0 = blockIdx.x * kBN;
  group_rows(group_sizes, g, M, s_rows);
  __syncthreads();
  const int a = s_rows[0], b = s_rows[1];

  const int warp = threadIdx.x / 32;
  const int row0 = TgCfg::kWM * (warp / TgCfg::kWJ), col0 = TgCfg::kWN * (warp % TgCfg::kWJ);
  float acc[TgCfg::kFM][TgCfg::kNJ][4];
#pragma unroll
  for (int f = 0; f < TgCfg::kFM; ++f)
#pragma unroll
    for (int j = 0; j < TgCfg::kNJ; ++j) acc[f][j][0] = acc[f][j][1] = acc[f][j][2] = acc[f][j][3] = 0.f;

  const int nt = (b - a + TgCfg::kRS - 1) / TgCfg::kRS;  // 0 for an empty group: zeros out
#pragma unroll
  for (int s = 0; s < TgCfg::kStages - 1; ++s) {
    if (s < nt) load_tgmm_mma_stage(smem + s * TgCfg::kStage, lhs, grad, a + s * TgCfg::kRS, b, c0, j0, k, n);
    cp_async_commit();
  }
  int cur = 0;
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<TgCfg::kStages - 2>();
    __syncthreads();
    const int nx = t + TgCfg::kStages - 1, slot = cur == 0 ? TgCfg::kStages - 1 : cur - 1;
    if (nx < nt) load_tgmm_mma_stage(smem + slot * TgCfg::kStage, lhs, grad, a + nx * TgCfg::kRS, b, c0, j0, k, n);
    cp_async_commit();
    tgmm_mma_step(smem + cur * TgCfg::kStage, acc, row0, col0);
    cur = cur + 1 == TgCfg::kStages ? 0 : cur + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  stage_acc(Cs, acc, row0, col0);
  __syncthreads();
  store_out<TO, TgCfg::kBK>(out + static_cast<int64_t>(g) * k * n, Cs, c0, k, j0, n);
}

// ---------------------------------------------------------------------------
// The bf16 forward (the model's path), in two regimes (the header comment).
// It keeps the f32 path's work items and grid (group, row tile) x (column
// tile of kBN), the backward's staging and 16-byte stores, and a cp.async
// ring with one barrier a step.
// ---------------------------------------------------------------------------

constexpr int kFRS = 64;  // the bf16 forward's reduction step (of k): one 128-byte row of bf16

// The three instantiations by kTile, the rows of a work item: 64 and 128
// (tiles) and 16 (the roles swapped). A stage holds the item's lhs rows
// [kTile, 64 k] K-major, then rhs[g]'s [64 k, 128 n] tile MN-major (n
// contiguous, as it lies in memory) as two halves of 64 columns, both in the
// 128-byte-swizzled layout the tensor cores read: 128-byte rows, 16-byte
// chunk c of row r at c ^ (r % 8), 8-row atoms of 1,024 bytes. Warpgroup w
// of the two: on 128-row tiles, rows 64w.. and all 128 columns (lhs as A,
// m64n128k16); on 64-row tiles, all rows and columns 64w.. (m64n64k16);
// with the roles swapped, columns 64w.. as A's rows (rhs[g] read through
// the transpose bit) and the item's rows as its n side (m64n16k16, m64n8k16
// for 8 rows or fewer).
template <int kTile>
struct FwdCfg {
  static constexpr bool kSwap = kTile == 16;
  static constexpr int kStages = kSwap ? 4 : 3;  // swapped: 16 KB of weights a stage; two blocks an SM
  static constexpr int kHalfW = kFRS * 128;      // bytes: rhs[g]'s 64 k rows of 64 columns
  static constexpr int kStageL = kTile * 128;   // bytes: the lhs rows, a multiple of 1,024
  static constexpr int kStage = kStageL + 2 * kHalfW;
  static constexpr int kN = kSwap ? kTile : kTile == 128 ? kBN : kBN / 2;  // a warpgroup's instruction: m64 x kN
  static constexpr int kAcc = kN / 2;            // its f32 accumulators a thread
  static constexpr size_t kRing = static_cast<size_t>(kStages) * kStage;
  static constexpr size_t kOut = sizeof(float) * kTile * kLdO;
  // the output tile reuses the ring; 1,024 bytes to align the atoms
  static constexpr size_t kBytes = (kRing > kOut ? kRing : kOut) + 1024;
};

// a wgmma shared-memory descriptor: 128-byte swizzle, byte offsets between
// atoms along the leading (lbo) and strided (sbo) dimensions
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d[64 x N] += A[64 x 16] B[16 x N] by descriptors, d as m16n8 fragments:
// lhs as A (K-major) and rhs[g] as B (MN-major, the transpose bit) ...
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// ... or, the roles swapped, rhs[g] as A (MN-major) and lhs as B (K-major);
// N = 8 fills d[0..3]
__device__ __forceinline__ void wgmma_m64n16k16_ta(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n8k16_ta(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs
template <int kAcc>
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// one stage: lhs [kTile rows, 64] at (r0, k0) (rows >= r_end zero) and
// rhs[g] [64, kBN] at (k0, n0), into the swizzled layout
template <int kTile>
__device__ __forceinline__ void load_fwd_stage(unsigned char* st, const bf16* lhs, const bf16* rhs_g, int r0,
                                               int r_end, int k0, int n0, int k, int n) {
  using C = FwdCfg<kTile>;
  if (kTile >= 32 || threadIdx.x < kTile * 8) {  // lhs: 8 chunks a row, rows t / 8 + 32 u
    const int row = threadIdx.x / 8, c = threadIdx.x % 8;
    const bool col_ok = k0 + 8 * c < k;
#pragma unroll
    for (int u = 0; u < (kTile + 31) / 32; ++u) {
      const int r = row + 32 * u;
      const bool ok = col_ok && r0 + r < r_end;
      cp_async16(st + r * 128 + ((c ^ (r & 7)) << 4), ok ? lhs + static_cast<int64_t>(r0 + r) * k + k0 + 8 * c : lhs,
                 ok);
    }
  }
  {  // rhs[g]: 16 chunks a row (8 a half), rows t / 16 + 16 u
    const int row = threadIdx.x / 16, c16 = threadIdx.x % 16, c = c16 % 8;
    const bool col_ok = n0 + 8 * c16 < n;
    unsigned char* w = st + C::kStageL + (c16 / 8) * C::kHalfW;
#pragma unroll
    for (int u = 0; u < kFRS / 16; ++u) {
      const int r = row + 16 * u;
      const bool ok = col_ok && k0 + r < k;
      cp_async16(w + r * 128 + ((c ^ (r & 7)) << 4),
                 ok ? rhs_g + static_cast<int64_t>(k0 + r) * n + n0 + 8 * c16 : rhs_g, ok);
    }
  }
}

template <int kTile>
__global__ void __launch_bounds__(kMThreads, 2)
gmm_fwd_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs, const int* __restrict__ group_sizes,
               float* __restrict__ out, int M, int k, int n, int E) {
  using C = FwdCfg<kTile>;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int s_off[kMaxE + 1];
  __shared__ int s_tile[kMaxE + 1];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // the atoms' alignment

  scan_groups<kTile>(group_sizes, E, s_off, s_tile);
  __syncthreads();

  const int n0 = blockIdx.x * kBN;
  int r0, r_end;
  const int g = find_item<kTile>(blockIdx.y, M, E, s_off, s_tile, r0, r_end);
  if (r0 >= r_end) return;
  if (g < 0) {  // past the real items: zero the rows past sum(group_sizes)
    store_out<float, kTile>(out, nullptr, r0, r_end, n0, n);
    return;
  }

  const int wg = threadIdx.x / 128;
  // the warpgroup's piece of the output: its first row of the tile and
  // first of the block's columns
  const int row0 = kTile == 128 ? 64 * wg : 0, col0 = kTile == 128 ? 0 : 64 * wg;
  const bool two = r_end - r0 > 8;  // swapped: the item's rows 8-15 exist, n16 (else n8)
  const bf16* rhs_g = rhs + static_cast<int64_t>(g) * k * n;
  float acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;

  const int nt = (k + kFRS - 1) / kFRS;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load_fwd_stage<kTile>(smem + s * C::kStage, lhs, rhs_g, r0, r_end, s * kFRS, n0, k, n);
    cp_async_commit();
  }
  int cur = 0;  // the ring slot of step t
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();                                   // this thread's copies of step t have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // and the tensor cores see them
    __syncthreads();  // everyone's; and step t - 1's slot, written next, is free (its MMAs waited for)
    const int nx = t + kStages - 1, slot = cur == 0 ? kStages - 1 : cur - 1;
    if (nx < nt) load_fwd_stage<kTile>(smem + slot * C::kStage, lhs, rhs_g, r0, r_end, nx * kFRS, n0, k, n);
    cp_async_commit();
    const uint32_t a0 = smem_u32(smem + cur * C::kStage) + row0 * 128;
    const uint32_t w0 = smem_u32(smem + cur * C::kStage) + C::kStageL + (col0 / 64) * C::kHalfW;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kFRS / 16; ++kk) {  // rhs[g]: 16 k rows further a step; lhs: 32 bytes further
      const uint64_t dw = wgmma_desc(w0 + kk * 16 * 128, C::kHalfW, 1024);
      const uint64_t dl = wgmma_desc(a0 + 32 * kk, 16, 1024);
      if constexpr (kTile == 128) wgmma_m64n128k16(acc, dl, dw);
      else if constexpr (kTile == 64) wgmma_m64n64k16(acc, dl, dw);
      else if (two) wgmma_m64n16k16_ta(acc, dw, dl);
      else wgmma_m64n8k16_ta(acc, dw, dl);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    cur = cur + 1 == kStages ? 0 : cur + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // the output tile overwrites the ring
  // the accumulators: m16n8 fragments, warp w % 4 of the warpgroup on rows
  // 16 (w % 4) .. + 15 of the instruction's 64
  float* Cs = reinterpret_cast<float*>(smem);
  const int warp_row = 16 * ((threadIdx.x / 32) % 4);
  if constexpr (C::kSwap) {  // out^T's [columns, rows]: staged back as rows
    const int lane = threadIdx.x % 32, col = col0 + warp_row + lane / 4;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) Cs[(8 * j + 2 * (lane % 4) + q % 2) * kLdO + col + 8 * (q / 2)] = acc[4 * j + q];
  } else {
    stage_acc(Cs, *reinterpret_cast<float(*)[1][C::kN / 8][4]>(acc), row0 + warp_row, col0);
  }
  __syncthreads();
  store_out<float, kTile>(out, Cs, r0, r_end, n0, n);
}

// grid: (column tiles, work items); -1 past the grid's limit
template <typename T, typename Kernel>
int launch_fwd(Kernel kernel, int tile, int cols, size_t bytes, unsigned threads, const T* lhs, const T* rhs,
               const void* gs, void* out, int M, int k, int n, int E, cudaStream_t stream) {
  const long items = static_cast<long>(M) / tile + E + 1;
  if (items > 65535) return -1;
  if (bytes > 0) {
    const int rc = set_smem(kernel, bytes);
    if (rc != 0) return rc;
  }
  dim3 grid((n + cols - 1) / cols, static_cast<unsigned>(items));
  kernel<<<grid, threads, bytes, stream>>>(lhs, rhs, static_cast<const int*>(gs), static_cast<float*>(out), M, k,
                                           n, E);
  return static_cast<int>(cudaGetLastError());
}

// the f32 path: kTM rows (16, 32, 64) x 64 columns
int fwd_f32(int tm, const void* lhs, const void* rhs, const void* gs, void* out, int M, int k, int n, int E,
            cudaStream_t st) {
  const float* a = static_cast<const float*>(lhs);
  const float* b = static_cast<const float*>(rhs);
  switch (tm) {
    case 16: return launch_fwd(gmm_fwd_f32_kernel<16>, 16, kTN, 0, kThreads, a, b, gs, out, M, k, n, E, st);
    case 32: return launch_fwd(gmm_fwd_f32_kernel<32>, 32, kTN, 0, kThreads, a, b, gs, out, M, k, n, E, st);
    case 64: return launch_fwd(gmm_fwd_f32_kernel<64>, 64, kTN, 0, kThreads, a, b, gs, out, M, k, n, E, st);
    default: return -1;
  }
}

// the bf16 path: 16 rows an item with the roles swapped (decode), or tiles
// of 64 or 128 rows
int fwd_bf16(int tile, const void* lhs, const void* rhs, const void* gs, void* out, int M, int k, int n, int E,
             cudaStream_t st) {
  const bf16* a = static_cast<const bf16*>(lhs);
  const bf16* b = static_cast<const bf16*>(rhs);
  switch (tile) {
    case 16:
      return launch_fwd(gmm_fwd_kernel<16>, 16, kBN, FwdCfg<16>::kBytes, kMThreads, a, b, gs, out, M, k, n, E, st);
    case 64:
      return launch_fwd(gmm_fwd_kernel<64>, 64, kBN, FwdCfg<64>::kBytes, kMThreads, a, b, gs, out, M, k, n, E, st);
    case 128:
      return launch_fwd(gmm_fwd_kernel<128>, 128, kBN, FwdCfg<128>::kBytes, kMThreads, a, b, gs, out, M, k, n, E,
                        st);
    default: return -1;
  }
}

template <typename TO, int kTM>
int launch_bwd_lhs_f32(const void* grad, const void* rhs, const void* gs, void* out, int M, int k, int n, int E,
                       cudaStream_t stream) {
  const long items = static_cast<long>(M) / kTM + E + 1;
  if (items > 65535) return -1;
  dim3 grid((k + kTN - 1) / kTN, static_cast<unsigned>(items));
  gmm_bwd_lhs_f32_kernel<TO, kTM><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(grad), static_cast<const float*>(rhs), static_cast<const int*>(gs),
      static_cast<TO*>(out), M, k, n, E);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int bwd_lhs_f32_by_tile(int tm, const void* grad, const void* rhs, const void* gs, void* out, int M, int k, int n,
                        int E, cudaStream_t st) {
  switch (tm) {
    case 16: return launch_bwd_lhs_f32<TO, 16>(grad, rhs, gs, out, M, k, n, E, st);
    case 32: return launch_bwd_lhs_f32<TO, 32>(grad, rhs, gs, out, M, k, n, E, st);
    case 64: return launch_bwd_lhs_f32<TO, 64>(grad, rhs, gs, out, M, k, n, E, st);
    default: return -1;
  }
}

template <typename TO, int kBM>
int launch_bwd_lhs_mma(const void* grad, const void* rhs, const void* gs, void* out, int M, int k, int n, int E,
                       cudaStream_t stream) {
  const long items = static_cast<long>(M) / kBM + E + 1;
  if (items > 65535) return -1;
  const size_t bytes = LhsCfg<kBM>::kBytes;
  const int rc = set_smem(gmm_bwd_lhs_kernel<TO, kBM>, bytes);
  if (rc != 0) return rc;
  dim3 grid((k + kBN - 1) / kBN, static_cast<unsigned>(items));
  gmm_bwd_lhs_kernel<TO, kBM><<<grid, kMThreads, bytes, stream>>>(
      static_cast<const float*>(grad), static_cast<const bf16*>(rhs), static_cast<const int*>(gs),
      static_cast<TO*>(out), M, k, n, E);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 path's row tile: 128 where the groups average 128 rows or more
template <typename TO>
int bwd_lhs_mma(const void* grad, const void* rhs, const void* gs, void* out, int M, int k, int n, int E,
                cudaStream_t st) {
  return static_cast<long>(M) >= 128L * E ? launch_bwd_lhs_mma<TO, 128>(grad, rhs, gs, out, M, k, n, E, st)
                                          : launch_bwd_lhs_mma<TO, 64>(grad, rhs, gs, out, M, k, n, E, st);
}

template <typename TO>
int launch_tgmm_f32(const void* lhs, const void* grad, const void* gs, void* out, int M, int k, int n, int E,
                    cudaStream_t stream) {
  if ((k + kTKo - 1) / kTKo > 65535) return -1;
  dim3 grid((n + kTN - 1) / kTN, (k + kTKo - 1) / kTKo, E);
  tgmm_f32_kernel<TO><<<grid, kThreads, 0, stream>>>(static_cast<const float*>(lhs), static_cast<const float*>(grad),
                                                     static_cast<const int*>(gs), static_cast<TO*>(out), M, k, n, E);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int launch_tgmm_mma(const void* lhs, const void* grad, const void* gs, void* out, int M, int k, int n, int E,
                    cudaStream_t stream) {
  if ((k + TgCfg::kBK - 1) / TgCfg::kBK > 65535) return -1;
  const int rc = set_smem(tgmm_kernel<TO>, TgCfg::kBytes);
  if (rc != 0) return rc;
  dim3 grid((n + kBN - 1) / kBN, (k + TgCfg::kBK - 1) / TgCfg::kBK, E);
  tgmm_kernel<TO><<<grid, kMThreads, TgCfg::kBytes, stream>>>(static_cast<const bf16*>(lhs),
                                                              static_cast<const float*>(grad),
                                                              static_cast<const int*>(gs), static_cast<TO*>(out), M,
                                                              k, n, E);
  return static_cast<int>(cudaGetLastError());
}

// a kernel's registers a thread, shared memory a block (static and
// dynamic), blocks an SM and local (spill) bytes a thread -> info[0..3]
template <typename Kernel>
int occupancy_of(Kernel kernel, size_t bytes, int* info) {
  int rc = set_smem(kernel, bytes);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  rc = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  if (rc != 0) return rc;
  int blocks = 0;
  rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kMThreads, bytes));
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes + bytes);
  info[2] = blocks;
  info[3] = static_cast<int>(attr.localSizeBytes);
  return rc;
}

}  // namespace

// dtype: 0 f32, 1 bf16 (lhs and rhs alike); tm: rows per work item, 16, 32
// or 64 for f32, 16 (the roles swapped), 64 or 128 for bf16. Returns 0, a
// CUDA error code, or -1 for arguments it does not take.
extern "C" int gmm_forward(const void* lhs, const void* rhs, const void* group_sizes, void* out, int M, int k,
                           int n, int E, int dtype, int tm, void* stream) {
  if (M < 0 || k < 0 || n < 0 || E <= 0 || E > kMaxE || k % 8 != 0 || n % 8 != 0) return -1;
  if (M == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return fwd_f32(tm, lhs, rhs, group_sizes, out, M, k, n, E, st);
    case 1: return fwd_bf16(tm, lhs, rhs, group_sizes, out, M, k, n, E, st);
    default: return -1;
  }
}

// dLHS = gmm(grad, rhs, transpose_rhs=True): grad [M, n] f32, rhs [E, k, n]
// (rhs_dtype 0 f32, 1 bf16), out [M, k] (out_dtype 0 f32, 1 bf16); tm (16,
// 32, 64): the f32 path's rows per work item, not read by the bf16 path
// (128 rows where the groups average 128 or more, else 64). Returns 0, a
// CUDA error code, or -1 for arguments it does not take.
extern "C" int gmm_bwd_lhs(const void* grad, const void* rhs, const void* group_sizes, void* out, int M, int k,
                           int n, int E, int rhs_dtype, int out_dtype, int tm, void* stream) {
  if (M < 0 || k < 0 || n < 0 || E <= 0 || E > kMaxE || k % 8 != 0 || n % 8 != 0) return -1;
  if (rhs_dtype < 0 || rhs_dtype > 1 || out_dtype < 0 || out_dtype > 1) return -1;
  if (M == 0 || k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rhs_dtype * 2 + out_dtype) {
    case 0: return bwd_lhs_f32_by_tile<float>(tm, grad, rhs, group_sizes, out, M, k, n, E, st);
    case 1: return bwd_lhs_f32_by_tile<bf16>(tm, grad, rhs, group_sizes, out, M, k, n, E, st);
    case 2: return bwd_lhs_mma<float>(grad, rhs, group_sizes, out, M, k, n, E, st);
    case 3: return bwd_lhs_mma<bf16>(grad, rhs, group_sizes, out, M, k, n, E, st);
    default: return -1;
  }
}

// dRHS = tgmm(lhs^T, grad): lhs [M, k] (lhs_dtype 0 f32, 1 bf16), grad
// [M, n] f32, out [E, k, n] (out_dtype 0 f32, 1 bf16), every group's matrix
// written (zeros for an empty one).
extern "C" int tgmm(const void* lhs, const void* grad, const void* group_sizes, void* out, int M, int k, int n,
                    int E, int lhs_dtype, int out_dtype, void* stream) {
  if (M < 0 || k < 0 || n < 0 || E <= 0 || k % 8 != 0 || n % 8 != 0) return -1;
  if (lhs_dtype < 0 || lhs_dtype > 1 || out_dtype < 0 || out_dtype > 1) return -1;
  if (k == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lhs_dtype * 2 + out_dtype) {
    case 0: return launch_tgmm_f32<float>(lhs, grad, group_sizes, out, M, k, n, E, st);
    case 1: return launch_tgmm_f32<bf16>(lhs, grad, group_sizes, out, M, k, n, E, st);
    case 2: return launch_tgmm_mma<float>(lhs, grad, group_sizes, out, M, k, n, E, st);
    case 3: return launch_tgmm_mma<bf16>(lhs, grad, group_sizes, out, M, k, n, E, st);
    default: return -1;
  }
}

// The bf16-operand backward kernels with a bf16 output (the training
// path's): registers a thread, shared memory a block, blocks an SM and
// local (spill) bytes a thread of gmm_bwd_lhs at 128-row tiles (info[0..3])
// and 64-row tiles (info[4..7]) and of tgmm (info[8..11]).
extern "C" int gmm_bwd_occupancy(int* info) {
  int rc = occupancy_of(gmm_bwd_lhs_kernel<bf16, 128>, LhsCfg<128>::kBytes, info);
  if (rc == 0) rc = occupancy_of(gmm_bwd_lhs_kernel<bf16, 64>, LhsCfg<64>::kBytes, info + 4);
  if (rc == 0) rc = occupancy_of(tgmm_kernel<bf16>, TgCfg::kBytes, info + 8);
  return rc;
}

// The bf16 forward kernels: registers a thread, shared memory a block,
// blocks an SM and local (spill) bytes a thread with the roles swapped
// (info[0..3]) and on 64- and 128-row tiles (info[4..7], info[8..11]).
extern "C" int gmm_fwd_occupancy(int* info) {
  int rc = occupancy_of(gmm_fwd_kernel<16>, FwdCfg<16>::kBytes, info);
  if (rc == 0) rc = occupancy_of(gmm_fwd_kernel<64>, FwdCfg<64>::kBytes, info + 4);
  if (rc == 0) rc = occupancy_of(gmm_fwd_kernel<128>, FwdCfg<128>::kBytes, info + 8);
  return rc;
}
