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
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // prefix sums of rows and of row tiles, one warp: lane l sums a run of
  // groups, a shuffle scan gives each run its start
  if (warp == 0) {
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
  __syncthreads();

  const int item = blockIdx.y, n0 = blockIdx.x * kTN;
  float* Cs = reinterpret_cast<float*>(smem);
  int r0, r_end;
  if (item >= s_tile[E]) {
    // past the real items: zero the rows past sum(group_sizes)
    const int tot = min(s_off[E], M);
    r0 = tot + (item - s_tile[E]) * kTM;
    r_end = min(r0 + kTM, M);
    if (r0 >= r_end) return;
    for (int i = threadIdx.x; i < kTM * kTN / 4; i += kThreads) {
      const int r = i / (kTN / 4), c = (i % (kTN / 4)) * 4;
      if (r0 + r < r_end && n0 + c < n)
        *reinterpret_cast<float4*>(out + static_cast<int64_t>(r0 + r) * n + n0 + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  // the group of this item: the first g with s_tile[g + 1] > item
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (s_tile[mid + 1] > item) hi = mid;
    else lo = mid + 1;
  }
  const int g = lo;
  r0 = s_off[g] + (item - s_tile[g]) * kTM;
  r_end = min(min(s_off[g + 1], r0 + kTM), M);
  if (r0 >= r_end) return;  // only where sum(group_sizes) > M

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
  for (int i = threadIdx.x; i < kTM * kTN / 4; i += kThreads) {
    const int r = i / (kTN / 4), c = (i % (kTN / 4)) * 4;
    if (r0 + r < r_end && n0 + c < n)
      *reinterpret_cast<float4*>(out + static_cast<int64_t>(r0 + r) * n + n0 + c) =
          *reinterpret_cast<const float4*>(Cs + r * TL::kLdC + c);
  }
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
