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
// What bounds it: the expert weights. At decode (M = 256 routed rows of 32
// slots x top-8 over 128 experts, ~112 experts touched) each call reads
// ~112 x k x n x 2 bytes of weights for 2 x 256 x k x n flops: ~1 flop per
// byte, bytes-bound. At a prefill group of 8 x 512 tokens (M = 32,768) each
// expert's rows (~256) share its weights: 103 GFLOP (0.10 ms at the bf16
// tensor-core peak) against ~0.64 GB moved (0.19 ms at 3.35 TB/s), still
// bytes-bound at the card's peaks; but WMMA fed from shared memory runs
// well below the tensor-core peak, so there this kernel is bound by its
// own MMA rate.
//
// The design (simple and correct first):
//   - work items are (group, row tile of kTM rows), each group tiled from its
//     own first row, so no tile straddles two groups and no two blocks write
//     one row: no atomics. There are at most M / kTM + E such items, which
//     the host knows without reading group_sizes, so the grid is sized with
//     no host sync: blockIdx.y is the item, blockIdx.x the tile of kTN = 64
//     output columns. Every block scans group_sizes (one warp, prefix sums
//     of rows and of tiles in shared memory) and binary-searches its item;
//     the items past the last real one zero the rows past sum(group_sizes),
//     the rest exit;
//   - n tiles vary fastest, so the blocks in flight together share their
//     lhs rows, and the row tiles of one group follow each other and find
//     its weights in L2: each touched expert's [k, 64] slice is read from
//     memory about once per row tile of its group, and at decode (a group
//     of ~2 rows, one tile) once;
//   - a k loop over 128-byte-wide tiles (64 bf16 / 32 f32 values) staged in
//     shared memory by cp.async, two stages, so one tile loads while the
//     other is multiplied; rows past the group's end and columns past k or
//     n are zero-filled by the copy and never stored;
//   - bf16: 4 warps, warp w owning output columns 16w..16w+15 of every
//     16-row fragment, WMMA 16x16x16 with f32 accumulators; f32 (the f32
//     twins): the same tiles multiplied on the CUDA cores in f32;
//   - the f32 result goes through shared memory and out as 16-byte stores.
// kTM is a template parameter (16, 32 or 64). Timed by chip_smoke.py's
// kernel_gmm at the serving shapes on an H100 80GB HBM3 at 700 W (gate/up,
// kTM 16 / 32 / 64: decode 0.147 / 0.159 / 0.173 ms, prefill 1.52 / 0.97 /
// 0.82 ms), no one tile is best at both: at decode (~2 rows a group, so one
// tile a group whatever kTM) 16 is fastest, since the unused rows of a
// larger tile cost MMA and shared-memory time for nothing; at prefill (~256
// rows a group) 64 is fastest, since each tile re-reads its expert's
// [k, 64] slice and 64 rows a tile read it a quarter as often as 16. The
// wrapper (ops/gmm.py pick_tile) takes 16 when the groups average fewer
// than 16 rows and 64 otherwise.
// What it does not do yet: TMA, wgmma, warp specialisation, a persistent
// tile scheduler, split-k for the decode shape's few tiles per expert.
//
// lhs and rhs are both bf16 or both f32; k and n multiples of 8; E <= 512.
//
// The same file holds the backward (gmm_bwd_lhs and tgmm, below), which
// shares the forward's group scan, work-item search and tile stores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kTN = 64;        // output columns per block
constexpr int kWarps = 4;      // warp w owns columns 16w..16w+15
constexpr int kThreads = kWarps * 32;
constexpr int kMaxE = 512;     // groups a block scans in shared memory
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Tile {
  static constexpr int kV = 16 / sizeof(T);   // values per 16-byte copy
  static constexpr int kTK = 128 / sizeof(T); // k per stage: 128-byte rows
  static constexpr int kPad = kV;             // row padding: keeps rows 16-byte aligned
  static constexpr int kLdA = kTK + kPad;
  static constexpr int kLdB = kTN + kPad;
  static constexpr int kLdC = kTN + 4;        // f32 staging of the output tile
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: no bytes read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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

// Multiply one stage into the accumulators.
template <int kTM>
struct Mma {
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  FragC acc[kTM / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int f = 0; f < kTM / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);
  }
  __device__ __forceinline__ void step(const bf16* As, const bf16* Bs, int warp) {
    using TL = Tile<bf16>;
#pragma unroll
    for (int kk = 0; kk < TL::kTK; kk += 16) {
      FragB b;
      wmma::load_matrix_sync(b, Bs + kk * TL::kLdB + warp * 16, TL::kLdB);
#pragma unroll
      for (int f = 0; f < kTM / 16; ++f) {
        FragA a;
        wmma::load_matrix_sync(a, As + f * 16 * TL::kLdA + kk, TL::kLdA);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }
  __device__ __forceinline__ void store(float* Cs, int warp) {
#pragma unroll
    for (int f = 0; f < kTM / 16; ++f)
      wmma::store_matrix_sync(Cs + f * 16 * Tile<bf16>::kLdC + warp * 16, acc[f], Tile<bf16>::kLdC,
                              wmma::mem_row_major);
  }
};

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

template <typename T, int kTM>
struct Acc;
template <int kTM>
struct Acc<bf16, kTM> : Mma<kTM> {};
template <int kTM>
struct Acc<float, kTM> : Fma<kTM> {};

template <typename T, int kTM>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs, const int* __restrict__ group_sizes,
           float* __restrict__ out, int M, int k, int n, int E) {
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
  Acc<T, kTM> acc;
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
// bf16(grad) would drop ~8 bits of every grad element. Instead each staged
// grad tile is split into hi = bf16(grad) and lo = bf16(grad - hi), and two
// bf16 MMAs (hi and lo, times the same exact bf16 operand) accumulate into
// one f32 fragment: each product is exact in f32, and what the split drops
// is at most 2^-16 |grad| an element (u = 2^-8 of bf16, squared). That is
// twice the MMA work of a bf16 product, still on the tensor cores. With f32
// operands (the f32 twins) the tiles are multiplied on the CUDA cores in
// f32, as the forward does.
//
// Timed by chip_smoke.py's kernel_gmm_bwd on an H100 80GB HBM3 at 700 W, at
// Qwen3-30B-A3B's expert shapes and M = 49,152 routed rows (bf16 out): 3.1-
// 3.3 ms each, ~14x the bound (the WMMA rate, doubled by the split, and a
// split-and-sync per reduction step); torch._grouped_mm on bf16 operands
// (another function) took 0.35 ms. What they do not do yet: wgmma, TMA, the
// split in registers, a persistent schedule.
// ---------------------------------------------------------------------------

constexpr int kTR = 32;        // reduction step of both backward kernels: n (dLHS), rows (tgmm)
constexpr int kLdC = kTN + 4;  // f32 staging of an output tile

template <typename T>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<bf16> {
  static constexpr bool value = true;
};

// hi / lo halves of an f32 tile [rows, cols] (ld ldg) into two bf16 tiles (ld ldh)
__device__ __forceinline__ void split_tile(const float* Gs, int ldg, bf16* Hs, bf16* Ls, int ldh, int rows,
                                           int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, c = i % cols;
    const float v = Gs[r * ldg + c];
    const bf16 h = __float2bfloat16_rn(v);
    Hs[r * ldh + c] = h;
    Ls[r * ldh + c] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

// ---------------------------------------------------------------------------
// gmm_bwd_lhs: dLHS of the grouped matmul, megablox gmm.py:314 gmm called
// with transpose_rhs=True. For each group g and each of its rows r:
//   out[r, :k] = grad[r, :n] @ rhs[g]^T      (rhs[g] [k, n], n contiguous)
// out in f32 or bf16 (lhs's dtype, as _gmm_bwd passes lhs[0].dtype), rows
// at or past sum(group_sizes) exact zeros.
//
// What bounds it: the same as the forward (2 M k n flops against the
// touched experts' weights and the M x (k + n) activations): at the
// training shapes (M = T x top-8 ~ 50-100k rows, ~400-800 rows a group)
// the bytes at the card's peaks, but the WMMA rate of this kernel, doubled
// by the hi / lo split, in practice.
//
// The design is the forward's, transposed in B: work items (group, row tile
// of kTM rows), M / kTM + E + 1 of them, sized from the shapes (no host
// sync) and found by the same scan and binary search; spare items zero the
// rows past the groups. blockIdx.x is a tile of kTN = 64 output columns
// (of k). The reduction over n runs inside the block in steps of kTR = 32:
// two cp.async stages hold the f32 grad tile [kTM, 32] and the [64, 32]
// slice rhs[g][c0.., j0..] as it lies in memory (k rows, n contiguous),
// which is B^T: it is read by a col_major WMMA fragment, so no transposed
// copy of the weight stack is ever made. The grad tile is split into hi /
// lo in shared memory, then warp w multiplies output columns 16w..16w+15.
// ---------------------------------------------------------------------------

template <typename TB>
struct LhsTile {
  static constexpr int kV = 16 / sizeof(TB);   // values per 16-byte copy
  static constexpr int kLdB = kTR + kV;        // staged rhs rows (k) of kTR n-values
  static constexpr int kLdG = kTR + 4;         // staged f32 grad rows
  static constexpr int kLdH = kTR + 8;         // hi / lo bf16 rows
};

template <typename TB, int kTM>
struct LhsSmem {
  static constexpr int kStageG = kTM * LhsTile<TB>::kLdG;  // floats
  static constexpr int kStageB = kTN * LhsTile<TB>::kLdB;  // TB values
  static constexpr size_t kG = sizeof(float) * 2 * kStageG;
  static constexpr size_t kB = sizeof(TB) * 2 * kStageB;
  static constexpr size_t kHL = IsBf16<TB>::value ? sizeof(bf16) * 2 * kTM * LhsTile<TB>::kLdH : 0;
  static constexpr size_t kAB = kG + kB + kHL;
  static constexpr size_t kC = sizeof(float) * kTM * kLdC;
  static constexpr size_t kBytes = kAB > kC ? kAB : kC;  // the output tile reuses the stages
};

template <typename TB, int kTM>
__device__ __forceinline__ void load_lhs_stage(float* Gs, TB* Bs, const float* grad, const TB* rhs_g, int r0,
                                               int r_end, int j0, int c0, int k, int n) {
  using TL = LhsTile<TB>;
  constexpr int kVecRowG = kTR / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kTM * kVecRowG; i += kThreads) {
    const int r = i / kVecRowG, j = (i % kVecRowG) * 4;
    const bool ok = r0 + r < r_end && j0 + j < n;
    const float* src = ok ? grad + static_cast<int64_t>(r0 + r) * n + j0 + j : grad;
    cp_async16(Gs + r * TL::kLdG + j, src, ok);
  }
  constexpr int kVecRowB = kTR / TL::kV;
#pragma unroll
  for (int i = threadIdx.x; i < kTN * kVecRowB; i += kThreads) {
    const int c = i / kVecRowB, j = (i % kVecRowB) * TL::kV;
    const bool ok = c0 + c < k && j0 + j < n;
    const TB* src = ok ? rhs_g + static_cast<int64_t>(c0 + c) * n + j0 + j : rhs_g;
    cp_async16(Bs + c * TL::kLdB + j, src, ok);
  }
}

template <int kTM>
struct LhsMma {
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragB;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  using TL = LhsTile<bf16>;
  FragC acc[kTM / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int f = 0; f < kTM / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);
  }
  // Gs [kTM, kTR] f32 grad, Bs [kTN, kTR] = rhs[g] rows; Hs / Ls scratch
  __device__ __forceinline__ void step(const float* Gs, const bf16* Bs, bf16* Hs, bf16* Ls, int warp) {
    split_tile(Gs, TL::kLdG, Hs, Ls, TL::kLdH, kTM, kTR);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTR; kk += 16) {
      FragB b;  // element (j, c) at Bs[c * kLdB + j]: rhs[g]^T
      wmma::load_matrix_sync(b, Bs + warp * 16 * TL::kLdB + kk, TL::kLdB);
#pragma unroll
      for (int f = 0; f < kTM / 16; ++f) {
        FragA lo, hi;
        wmma::load_matrix_sync(lo, Ls + f * 16 * TL::kLdH + kk, TL::kLdH);
        wmma::load_matrix_sync(hi, Hs + f * 16 * TL::kLdH + kk, TL::kLdH);
        wmma::mma_sync(acc[f], lo, b, acc[f]);
        wmma::mma_sync(acc[f], hi, b, acc[f]);
      }
    }
  }
  __device__ __forceinline__ void store(float* Cs, int warp) {
#pragma unroll
    for (int f = 0; f < kTM / 16; ++f)
      wmma::store_matrix_sync(Cs + f * 16 * kLdC + warp * 16, acc[f], kLdC, wmma::mem_row_major);
  }
};

// f32 operands: thread t owns output column t % 64 of rows t / 64, t / 64 + 2, ...
template <int kTM>
struct LhsFma {
  static constexpr int kRows = kTM * kTN / kThreads;
  using TL = LhsTile<float>;
  float acc[kRows];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
  }
  __device__ __forceinline__ void step(const float* Gs, const float* Bs, bf16*, bf16*, int) {
    const int col = threadIdx.x % kTN, r0 = threadIdx.x / kTN;
#pragma unroll 8
    for (int jj = 0; jj < kTR; ++jj) {
      const float b = Bs[col * TL::kLdB + jj];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = fmaf(Gs[(r0 + j * (kThreads / kTN)) * TL::kLdG + jj], b, acc[j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs, int) {
    const int col = threadIdx.x % kTN, r0 = threadIdx.x / kTN;
#pragma unroll
    for (int j = 0; j < kRows; ++j) Cs[(r0 + j * (kThreads / kTN)) * kLdC + col] = acc[j];
  }
};

template <typename TB, int kTM>
struct LhsAcc;
template <int kTM>
struct LhsAcc<bf16, kTM> : LhsMma<kTM> {};
template <int kTM>
struct LhsAcc<float, kTM> : LhsFma<kTM> {};

template <typename TB, typename TO, int kTM>
__global__ void __launch_bounds__(kThreads)
gmm_bwd_lhs_kernel(const float* __restrict__ grad, const TB* __restrict__ rhs, const int* __restrict__ group_sizes,
                   TO* __restrict__ out, int M, int k, int n, int E) {
  using SM = LhsSmem<TB, kTM>;
  __shared__ __align__(128) unsigned char smem[SM::kBytes];
  __shared__ int s_off[kMaxE + 1];
  __shared__ int s_tile[kMaxE + 1];
  const int warp = threadIdx.x / 32;

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
  TB* Bs = reinterpret_cast<TB*>(smem + SM::kG);
  bf16* Hs = reinterpret_cast<bf16*>(smem + SM::kG + SM::kB);
  bf16* Ls = Hs + kTM * LhsTile<TB>::kLdH;
  const TB* rhs_g = rhs + static_cast<int64_t>(g) * k * n;
  LhsAcc<TB, kTM> acc;
  acc.zero();
  const int nt = (n + kTR - 1) / kTR;
  if (nt > 0) {
    load_lhs_stage<TB, kTM>(Gs, Bs, grad, rhs_g, r0, r_end, 0, c0, k, n);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    if (t + 1 < nt)
      load_lhs_stage<TB, kTM>(Gs + (cur ^ 1) * SM::kStageG, Bs + (cur ^ 1) * SM::kStageB, grad, rhs_g, r0, r_end,
                              (t + 1) * kTR, c0, k, n);
    cp_async_commit();
    cp_async_wait<1>();  // stage `cur` has landed
    __syncthreads();
    acc.step(Gs + cur * SM::kStageG, Bs + cur * SM::kStageB, Hs, Ls, warp);
    __syncthreads();  // before the next copy (and split) overwrites what this step read
  }
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  acc.store(Cs, warp);
  __syncthreads();
  store_tile<TO, kTM>(out, Cs, kLdC, r0, r_end, c0, k);
}

// ---------------------------------------------------------------------------
// tgmm: dRHS of the grouped matmul, megablox gmm.py:573 tgmm (with
// num_actual_groups = E and visit_empty_groups). For each group g:
//   out[g] [k, n] = lhs[a:b]^T @ grad[a:b]   over the group's rows [a, b)
// out in f32 or bf16 (rhs's dtype); an empty group's matrix is zeros.
//
// What bounds it: 2 M k n flops against lhs (M k), grad (M n) and the E k n
// output; at the training shapes the output and activations' bytes at the
// card's peaks, the WMMA rate (doubled by the split) in practice.
//
// The design: one block per (n tile of 64, k tile of 64, group): E x
// ceil(k / 64) x ceil(n / 64) blocks, from the shapes. Each block finds its
// group's rows (a warp sums group_sizes[0..g)) and loops over them in steps
// of kTR = 32 rows, so the whole reduction over rows stays in one block: no
// atomics, no second pass, a deterministic result, and an empty group
// writes zeros. Two cp.async stages hold lhs [32 rows, 64 k] (read by a
// col_major fragment as lhs^T) and the f32 grad [32 rows, 64 n], split into
// hi / lo; warp w owns output rows 16w..16w+15 (of k), all 64 columns. The
// n tiles of one group's k tile run side by side, so they share the
// group's rows in L2.
// ---------------------------------------------------------------------------

constexpr int kTKo = 64;  // output rows (of k) per tgmm block

template <typename TA>
struct TgTile {
  static constexpr int kV = 16 / sizeof(TA);
  static constexpr int kLdA = kTKo + kV;  // staged lhs rows of 64 k-values
  static constexpr int kLdG = kTN + 4;    // staged f32 grad rows
  static constexpr int kLdH = kTN + 8;    // hi / lo bf16 rows
};

template <typename TA>
struct TgSmem {
  static constexpr int kStageA = kTR * TgTile<TA>::kLdA;  // TA values
  static constexpr int kStageG = kTR * TgTile<TA>::kLdG;  // floats
  static constexpr size_t kA = sizeof(TA) * 2 * kStageA;
  static constexpr size_t kG = sizeof(float) * 2 * kStageG;
  static constexpr size_t kHL = IsBf16<TA>::value ? sizeof(bf16) * 2 * kTR * TgTile<TA>::kLdH : 0;
  static constexpr size_t kAB = kA + kG + kHL;
  static constexpr size_t kC = sizeof(float) * kTKo * kLdC;
  static constexpr size_t kBytes = kAB > kC ? kAB : kC;
};

template <typename TA>
__device__ __forceinline__ void load_tgmm_stage(TA* As, float* Gs, const TA* lhs, const float* grad, int r0,
                                                int r_end, int c0, int j0, int k, int n) {
  using TL = TgTile<TA>;
  constexpr int kVecRowA = kTKo / TL::kV;
#pragma unroll
  for (int i = threadIdx.x; i < kTR * kVecRowA; i += kThreads) {
    const int r = i / kVecRowA, c = (i % kVecRowA) * TL::kV;
    const bool ok = r0 + r < r_end && c0 + c < k;
    const TA* src = ok ? lhs + static_cast<int64_t>(r0 + r) * k + c0 + c : lhs;
    cp_async16(As + r * TL::kLdA + c, src, ok);
  }
  constexpr int kVecRowG = kTN / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kTR * kVecRowG; i += kThreads) {
    const int r = i / kVecRowG, j = (i % kVecRowG) * 4;
    const bool ok = r0 + r < r_end && j0 + j < n;
    const float* src = ok ? grad + static_cast<int64_t>(r0 + r) * n + j0 + j : grad;
    cp_async16(Gs + r * TL::kLdG + j, src, ok);
  }
}

struct TgMma {
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  using TL = TgTile<bf16>;
  FragC acc[kTN / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int f = 0; f < kTN / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);
  }
  // As [kTR rows, 64 k] lhs, Gs [kTR rows, 64 n] f32 grad; Hs / Ls scratch
  __device__ __forceinline__ void step(const bf16* As, const float* Gs, bf16* Hs, bf16* Ls, int warp) {
    split_tile(Gs, TL::kLdG, Hs, Ls, TL::kLdH, kTR, kTN);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTR; kk += 16) {
      FragA a;  // element (c, r) at As[r * kLdA + c]: lhs^T
      wmma::load_matrix_sync(a, As + kk * TL::kLdA + warp * 16, TL::kLdA);
#pragma unroll
      for (int f = 0; f < kTN / 16; ++f) {
        FragB lo, hi;
        wmma::load_matrix_sync(lo, Ls + kk * TL::kLdH + f * 16, TL::kLdH);
        wmma::load_matrix_sync(hi, Hs + kk * TL::kLdH + f * 16, TL::kLdH);
        wmma::mma_sync(acc[f], a, lo, acc[f]);
        wmma::mma_sync(acc[f], a, hi, acc[f]);
      }
    }
  }
  __device__ __forceinline__ void store(float* Cs, int warp) {
#pragma unroll
    for (int f = 0; f < kTN / 16; ++f)
      wmma::store_matrix_sync(Cs + warp * 16 * kLdC + f * 16, acc[f], kLdC, wmma::mem_row_major);
  }
};

// f32 operands: thread t owns output column t % 64 of rows t / 64, t / 64 + 2, ...
struct TgFma {
  static constexpr int kRows = kTKo * kTN / kThreads;
  using TL = TgTile<float>;
  float acc[kRows];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
  }
  __device__ __forceinline__ void step(const float* As, const float* Gs, bf16*, bf16*, int) {
    const int col = threadIdx.x % kTN, c0 = threadIdx.x / kTN;
#pragma unroll 4
    for (int rr = 0; rr < kTR; ++rr) {
      const float gv = Gs[rr * TL::kLdG + col];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = fmaf(As[rr * TL::kLdA + c0 + j * (kThreads / kTN)], gv, acc[j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs, int) {
    const int col = threadIdx.x % kTN, c0 = threadIdx.x / kTN;
#pragma unroll
    for (int j = 0; j < kRows; ++j) Cs[(c0 + j * (kThreads / kTN)) * kLdC + col] = acc[j];
  }
};

template <typename TA>
struct TgAcc;
template <>
struct TgAcc<bf16> : TgMma {};
template <>
struct TgAcc<float> : TgFma {};

template <typename TA, typename TO>
__global__ void __launch_bounds__(kThreads)
tgmm_kernel(const TA* __restrict__ lhs, const float* __restrict__ grad, const int* __restrict__ group_sizes,
            TO* __restrict__ out, int M, int k, int n, int E) {
  using SM = TgSmem<TA>;
  __shared__ __align__(128) unsigned char smem[SM::kBytes];
  __shared__ int s_rows[2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.z, c0 = blockIdx.y * kTKo, j0 = blockIdx.x * kTN;

  // the group's rows [a, b): a warp sums group_sizes[0..g)
  if (warp == 0) {
    int s = 0;
    for (int i = lane; i < g; i += 32) s += max(group_sizes[i], 0);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
    if (lane == 0) {
      s_rows[0] = min(s, M);
      s_rows[1] = min(s + max(group_sizes[g], 0), M);
    }
  }
  __syncthreads();
  const int a = s_rows[0], b = s_rows[1];

  TA* As = reinterpret_cast<TA*>(smem);
  float* Gs = reinterpret_cast<float*>(smem + SM::kA);
  bf16* Hs = reinterpret_cast<bf16*>(smem + SM::kA + SM::kG);
  bf16* Ls = Hs + kTR * TgTile<TA>::kLdH;
  TgAcc<TA> acc;
  acc.zero();
  const int nt = (b - a + kTR - 1) / kTR;  // 0 for an empty group: zeros out
  if (nt > 0) {
    load_tgmm_stage<TA>(As, Gs, lhs, grad, a, b, c0, j0, k, n);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    if (t + 1 < nt)
      load_tgmm_stage<TA>(As + (cur ^ 1) * SM::kStageA, Gs + (cur ^ 1) * SM::kStageG, lhs, grad, a + (t + 1) * kTR,
                          b, c0, j0, k, n);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    acc.step(As + cur * SM::kStageA, Gs + cur * SM::kStageG, Hs, Ls, warp);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  acc.store(Cs, warp);
  __syncthreads();
  store_tile<TO, kTKo>(out + static_cast<int64_t>(g) * k * n, Cs, kLdC, c0, k, j0, n);
}

template <typename T, int kTM>
int launch(const void* lhs, const void* rhs, const void* group_sizes, void* out, int M, int k, int n, int E,
           cudaStream_t stream) {
  const long items = static_cast<long>(M) / kTM + E + 1;
  if (items > 65535) return -1;
  dim3 grid((n + kTN - 1) / kTN, static_cast<unsigned>(items));
  gmm_kernel<T, kTM><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(lhs), static_cast<const T*>(rhs),
                                                     static_cast<const int*>(group_sizes),
                                                     static_cast<float*>(out), M, k, n, E);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_tile(int tm, const void* lhs, const void* rhs, const void* gs, void* out, int M, int k, int n, int E,
            cudaStream_t st) {
  switch (tm) {
    case 16: return launch<T, 16>(lhs, rhs, gs, out, M, k, n, E, st);
    case 32: return launch<T, 32>(lhs, rhs, gs, out, M, k, n, E, st);
    case 64: return launch<T, 64>(lhs, rhs, gs, out, M, k, n, E, st);
    default: return -1;
  }
}


template <typename TB, typename TO, int kTM>
int launch_bwd_lhs(const void* grad, const void* rhs, const void* gs, void* out, int M, int k, int n, int E,
                   cudaStream_t stream) {
  const long items = static_cast<long>(M) / kTM + E + 1;
  if (items > 65535) return -1;
  dim3 grid((k + kTN - 1) / kTN, static_cast<unsigned>(items));
  gmm_bwd_lhs_kernel<TB, TO, kTM><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(grad), static_cast<const TB*>(rhs), static_cast<const int*>(gs),
      static_cast<TO*>(out), M, k, n, E);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB, typename TO>
int bwd_lhs_by_tile(int tm, const void* grad, const void* rhs, const void* gs, void* out, int M, int k, int n,
                    int E, cudaStream_t st) {
  switch (tm) {
    case 16: return launch_bwd_lhs<TB, TO, 16>(grad, rhs, gs, out, M, k, n, E, st);
    case 32: return launch_bwd_lhs<TB, TO, 32>(grad, rhs, gs, out, M, k, n, E, st);
    case 64: return launch_bwd_lhs<TB, TO, 64>(grad, rhs, gs, out, M, k, n, E, st);
    default: return -1;
  }
}

template <typename TA, typename TO>
int launch_tgmm(const void* lhs, const void* grad, const void* gs, void* out, int M, int k, int n, int E,
                cudaStream_t stream) {
  if ((k + kTKo - 1) / kTKo > 65535) return -1;
  dim3 grid((n + kTN - 1) / kTN, (k + kTKo - 1) / kTKo, E);
  tgmm_kernel<TA, TO><<<grid, kThreads, 0, stream>>>(static_cast<const TA*>(lhs), static_cast<const float*>(grad),
                                                     static_cast<const int*>(gs), static_cast<TO*>(out), M, k, n, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 f32, 1 bf16 (lhs and rhs alike); tm: rows per work item (16, 32,
// 64). Returns 0, a CUDA error code, or -1 for arguments it does not take.
extern "C" int gmm_forward(const void* lhs, const void* rhs, const void* group_sizes, void* out, int M, int k,
                           int n, int E, int dtype, int tm, void* stream) {
  if (M < 0 || k < 0 || n < 0 || E <= 0 || E > kMaxE || k % 8 != 0 || n % 8 != 0) return -1;
  if (M == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_tile<float>(tm, lhs, rhs, group_sizes, out, M, k, n, E, st);
    case 1: return by_tile<bf16>(tm, lhs, rhs, group_sizes, out, M, k, n, E, st);
    default: return -1;
  }
}

// dLHS = gmm(grad, rhs, transpose_rhs=True): grad [M, n] f32, rhs [E, k, n]
// (rhs_dtype 0 f32, 1 bf16), out [M, k] (out_dtype 0 f32, 1 bf16); tm rows
// per work item (16, 32, 64). Returns 0, a CUDA error code, or -1 for
// arguments it does not take.
extern "C" int gmm_bwd_lhs(const void* grad, const void* rhs, const void* group_sizes, void* out, int M, int k,
                           int n, int E, int rhs_dtype, int out_dtype, int tm, void* stream) {
  if (M < 0 || k < 0 || n < 0 || E <= 0 || E > kMaxE || k % 8 != 0 || n % 8 != 0) return -1;
  if (rhs_dtype < 0 || rhs_dtype > 1 || out_dtype < 0 || out_dtype > 1) return -1;
  if (M == 0 || k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rhs_dtype * 2 + out_dtype) {
    case 0: return bwd_lhs_by_tile<float, float>(tm, grad, rhs, group_sizes, out, M, k, n, E, st);
    case 1: return bwd_lhs_by_tile<float, bf16>(tm, grad, rhs, group_sizes, out, M, k, n, E, st);
    case 2: return bwd_lhs_by_tile<bf16, float>(tm, grad, rhs, group_sizes, out, M, k, n, E, st);
    case 3: return bwd_lhs_by_tile<bf16, bf16>(tm, grad, rhs, group_sizes, out, M, k, n, E, st);
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
    case 0: return launch_tgmm<float, float>(lhs, grad, group_sizes, out, M, k, n, E, st);
    case 1: return launch_tgmm<float, bf16>(lhs, grad, group_sizes, out, M, k, n, E, st);
    case 2: return launch_tgmm<bf16, float>(lhs, grad, group_sizes, out, M, k, n, E, st);
    case 3: return launch_tgmm<bf16, bf16>(lhs, grad, group_sizes, out, M, k, n, E, st);
    default: return -1;
  }
}
