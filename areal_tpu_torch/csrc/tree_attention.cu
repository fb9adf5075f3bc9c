// Block-sparse ancestor-mask attention over packed trie nodes for Hopper
// (sm_90a): forward and backward, called through ctypes.
//
// Replaces, on the tree-training path:
//   - #4 tree_attention_fwd: areal_tpu/ops/tree_attention.py:_fwd_pallas
//     (_tree_attn_kernel), which also emits the per-row logsumexp;
//   - #5 tree_attention_bwd_dq: the dQ pallas_call of _tree_attn_bwd
//     (_tree_bwd_dq_kernel);
//   - #6 tree_attention_bwd_dkv: the dK / dV pallas_call of _tree_attn_bwd
//     (_tree_bwd_dkv_kernel).
// The function: q, k, v [N, H, HD] bf16 (KV heads already repeated to H, N a
// multiple of 128), the ancestor relation as packed bits words [N, N/32]
// (bit j % 32 of word j / 32 of row i set when node i attends node j) and a
// skip map block_any [N/128, N/128] (nonzero where any bit of the 128 x 128
// tile is set). Softmax scale 1/sqrt(HD). Nodes come parent before child, so
// no bit lies above the diagonal. Rows with no set bit (padding) output
// zeros and a logsumexp of 0; they take and give no gradient. The backward
// takes delta = rowsum(dO * O) [N, H] from the caller, as the JAX custom VJP
// computes it outside its kernels.
//
// What bounds it: the trie decides. The forward does 2 * HD * H flops per
// set bit for each of its two products (q.k and p.v) on 8 * N * H * HD bytes
// of q, k, v, o plus N^2 / 8 bytes of words. A GRPO forest of prompts of a
// few hundred tokens with 128-token branches sets a few hundred bits per row
// (~n / 4 flop/byte for rows of depth n), under the ~295 flop/byte at which
// the H100's tensor cores and not its memory are the limit, so its bound is
// the bytes; deep agentic tries of thousands of nodes are bound by the
// operations. The backward is the same with 3.5x the flops of the forward
// (#6's four products and #5's three, each recomputing S and dP).
//
// The design (simple and correct first; K2-K4's structure in
// csrc/flash_attention.cu with the ancestor bit in place of the
// segment-causal predicate):
//   - tiles of 64 query rows x 64 key rows; every product runs on the tensor
//     cores through WMMA 16x16x16 bf16 fragments with f32 accumulation, from
//     shared memory;
//   - the mask is read from the packed words inside the kernel, one 32-bit
//     word per (row, 32 columns): a 64 x 64 tile needs 128 words (512
//     bytes), never an [N, N] byte mask;
//   - tiles are skipped three ways, all uniform across the block: above the
//     diagonal (ancestors precede their nodes), where block_any of the
//     enclosing 128 x 128 tile is 0 (read as block_any[i / 2][j / 2], which
//     is conservative for 64-row tiles), and where the tile's own 128 words
//     are all 0 (one __syncthreads_or, which is also the barrier before the
//     tile's loads);
//   - #4: one block per (query tile, head), 4 warps, warp w owning query rows
//     16w..16w+15; a loop over key tiles replaces the TPU's sequential grid
//     axis; the online softmax (running max and sum per row, f32) and the
//     f32 output accumulator live in shared memory (a WMMA accumulator's
//     element-to-row map is unspecified and the rescale is per row). Each
//     lane pair owns a row, each lane 32 of the tile's columns: exactly one
//     mask word;
//   - #6: one block per (key tile, head), 8 warps, looping over the query
//     tiles at or after it (block_any read transposed: [iq / 2][jk / 2]);
//     dK and dV stay in WMMA accumulators. #5: one block per (query tile,
//     head), looping over the key tiles at or before it; dQ stays in
//     accumulators. Both recompute P = exp(S * scale - lse) and take
//     dS = P * (dP - delta). No atomics, so a checkpointed recompute
//     reproduces the forward bit for bit.
// What it does not do yet: TMA / cp.async double buffering, wgmma, keeping S
// and P in registers, GQA inside the kernel (K and V arrive repeated to H),
// or a work list of the nonzero tiles in place of the per-block scan.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kB = 64;         // rows per query tile and per key tile
constexpr int kSkip = 128;     // tile edge of block_any
constexpr int kWordsPerRow = kB / 32;  // mask words per row of a tile
constexpr int kFwdWarps = 4;   // #4: warp w owns query rows 16w..16w+15
constexpr int kBwdWarps = 8;   // #5, #6
constexpr int kPadH = 8;       // bf16 row padding (elements): ldm % 8 == 0
constexpr int kPadF = 4;       // f32 row padding: ldm % 4 == 0
constexpr int kStageLd = 20;   // f32 staging tile [16][20] for the backward stores
constexpr unsigned kFull = 0xffffffffu;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ constexpr size_t align32(size_t n) { return (n + 31) / 32 * 32; }

// Copy rows [r0, r0 + kB) of one head of an [N, H, HD] tensor into a
// [kB][HD + kPadH] shared tile. `base` points at (0, h, 0); consecutive rows
// are `rs` elements apart. N is a multiple of kB, so every row exists.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ base, int r0,
                                          size_t rs, int tid, int nthr) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int LD = HD + kPadH;
  for (int c = tid; c < kB * kChunks; c += nthr) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + col) =
        *reinterpret_cast<const uint4*>(base + (size_t)(r0 + r) * rs + col);
  }
}

// Is the tile (query tile qt, key tile kt) inside a nonzero 128 x 128 tile
// of the skip map? Uniform in the block.
__device__ __forceinline__ bool tile_live(const int* __restrict__ block_any, int nB, int qt,
                                          int kt) {
  return block_any[(size_t)(qt * kB / kSkip) * nB + kt * kB / kSkip] != 0;
}

// ---------------------------------------------------------------------------
// #4: forward
// ---------------------------------------------------------------------------

template <int HD>
struct FwdSmem {
  static constexpr int LDH = HD + kPadH;   // q/k/v tiles (bf16)
  static constexpr int LDS = kB + kPadF;   // S (f32)
  static constexpr int LDP = 2 * LDS;      // P (bf16) written over S's rows
  static constexpr int LDO = HD + kPadF;   // O accumulator (f32)
  static constexpr size_t q = 0;
  static constexpr size_t k = align32(q + sizeof(bf16) * kB * LDH);
  static constexpr size_t v = align32(k + sizeof(bf16) * kB * LDH);
  static constexpr size_t s = align32(v + sizeof(bf16) * kB * LDH);
  static constexpr size_t o = align32(s + sizeof(float) * kB * LDS);
  static constexpr size_t m = align32(o + sizeof(float) * kB * LDO);
  static constexpr size_t l = m + sizeof(float) * kB;
  static constexpr size_t bytes = l + sizeof(float) * kB;
};

template <int HD>
__global__ void __launch_bounds__(kFwdWarps * 32) tree_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const unsigned* __restrict__ words, const int* __restrict__ block_any, bf16* __restrict__ o,
    float* __restrict__ lse, int N, int H, float scale) {
  typedef FwdSmem<HD> SM;
  constexpr int LDH = SM::LDH, LDS = SM::LDS, LDP = SM::LDP, LDO = SM::LDO;
  constexpr int kThreads = kFwdWarps * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + SM::q);
  bf16* k_s = reinterpret_cast<bf16*>(smem + SM::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + SM::v);
  float* s_s = reinterpret_cast<float*>(smem + SM::s);
  bf16* p_s = reinterpret_cast<bf16*>(smem + SM::s);  // aliases S row by row
  float* o_s = reinterpret_cast<float*>(smem + SM::o);
  float* m_s = reinterpret_cast<float*>(smem + SM::m);
  float* l_s = reinterpret_cast<float*>(smem + SM::l);

  const int qt = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rs = (size_t)H * HD;  // elements between consecutive rows of one head
  const size_t head0 = (size_t)h * HD;
  const int W = N / 32, nB = N / kSkip;
  const int q0 = qt * kB;

  load_tile<HD>(q_s, q + head0, q0, rs, tid, kThreads);
  for (int r = tid; r < kB; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < kB * LDO; i += kThreads) o_s[i] = 0.f;
  // (the first live tile's __syncthreads_or publishes these)

  const int r = 16 * warp + (lane >> 1);  // the row this lane pair owns
  const int half = lane & 1;              // which 32 of the tile's columns
  const int qi = q0 + r;
  const unsigned* wrow = words + (size_t)qi * W;

  for (int kt = 0; kt <= qt; ++kt) {  // later tiles lie above the diagonal
    if (!tile_live(block_any, nB, qt, kt)) continue;
    // this lane's mask word: columns kt * 64 + 32 * half .. + 31
    const unsigned w = wrow[kt * kWordsPerRow + half];
    // the barrier also orders the previous tile's reads of k_s / v_s
    if (!__syncthreads_or(w != 0u)) continue;
    const int k0 = kt * kB;
    load_tile<HD>(k_s, k + head0, k0, rs, tid, kThreads);
    load_tile<HD>(v_s, v + head0, k0, rs, tid, kThreads);
    __syncthreads();

    // S[rows of this warp][64] = Q K^T (raw dot products, f32)
#pragma unroll
    for (int j = 0; j < kB / 16; ++j) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int d = 0; d < HD; d += 16) {
        FragARow a;
        FragBCol b;
        wmma::load_matrix_sync(a, q_s + 16 * warp * LDH + d, LDH);
        wmma::load_matrix_sync(b, k_s + 16 * j * LDH + d, LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(s_s + 16 * warp * LDS + 16 * j, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of row r over this tile's 64 columns, two lanes per row
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const bool ok = (w >> c) & 1u;
      sv[c] = ok ? s_s[r * LDS + half * 32 + c] * scale : -INFINITY;
      mx = fmaxf(mx, sv[c]);
    }
    // the shuffle also orders every lane's reads of S before P overwrites it
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    float alpha = 1.f, psum = 0.f;
    if (m_new != -INFINITY) {
      alpha = __expf(m_old - m_new);  // 0 while the row had no set bit
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float p = __expf(sv[c] - m_new);  // masked: exp(-inf) = 0
        psum += p;
        p_s[r * LDP + half * 32 + c] = __float2bfloat16(p);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 32; ++c) p_s[r * LDP + half * 32 + c] = __float2bfloat16(0.f);
    }
    psum += __shfl_xor_sync(kFull, psum, 1);
    if (half == 0) {
      m_s[r] = m_new;
      l_s[r] = l_s[r] * alpha + psum;
    }
    if (alpha != 1.f) {
#pragma unroll 8
      for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); ++d) o_s[r * LDO + d] *= alpha;
    }
    __syncwarp();

    // O[rows of this warp] += P V
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      FragC acc;
      wmma::load_matrix_sync(acc, o_s + 16 * warp * LDO + 16 * j, LDO, wmma::mem_row_major);
#pragma unroll
      for (int s = 0; s < kB / 16; ++s) {
        FragARow a;
        FragBRow b;
        wmma::load_matrix_sync(a, p_s + 16 * warp * LDP + 16 * s, LDP);
        wmma::load_matrix_sync(b, v_s + 16 * s * LDH + 16 * j, LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(o_s + 16 * warp * LDO + 16 * j, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  __syncthreads();  // o_s / m_s / l_s initialised by other threads when no tile was live
  const float lr = l_s[r];
  const float inv = lr > 0.f ? 1.f / lr : 0.f;  // padding rows: zeros
  bf16* orow = o + head0 + (size_t)qi * rs;
#pragma unroll 4
  for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); d += 2) {
    *reinterpret_cast<__nv_bfloat162*>(orow + d) =
        __floats2bfloat162_rn(o_s[r * LDO + d] * inv, o_s[r * LDO + d + 1] * inv);
  }
  if (lse != nullptr && half == 0) lse[(size_t)qi * H + h] = lr > 0.f ? m_s[r] + logf(lr) : 0.f;
}

// ---------------------------------------------------------------------------
// #5 / #6: backward
// ---------------------------------------------------------------------------

template <int HD>
struct BwdSmem {
  static constexpr int LDH = HD + kPadH;  // q/do/k/v tiles (bf16)
  static constexpr int LDS = kB + kPadF;  // S and dP (f32)
  static constexpr int LDP = 2 * LDS;     // P over S's rows, dS over dP's rows (bf16)
  static constexpr size_t q = 0;
  static constexpr size_t dout = align32(q + sizeof(bf16) * kB * LDH);
  static constexpr size_t k = align32(dout + sizeof(bf16) * kB * LDH);
  static constexpr size_t v = align32(k + sizeof(bf16) * kB * LDH);
  static constexpr size_t s = align32(v + sizeof(bf16) * kB * LDH);
  static constexpr size_t dp = align32(s + sizeof(float) * kB * LDS);
  static constexpr size_t lse = align32(dp + sizeof(float) * kB * LDS);
  static constexpr size_t delta = lse + sizeof(float) * kB;
  static constexpr size_t wt = delta + sizeof(float) * kB;
  static constexpr size_t bytes = wt + sizeof(unsigned) * kB * kWordsPerRow;
};

// Load the 128 mask words of tile (query rows q0.., key tile kt) into
// shared memory; returns whether any is nonzero. A block-wide barrier.
template <int HD>
__device__ __forceinline__ bool load_words(unsigned char* smem, const unsigned* __restrict__ words,
                                           int q0, int kt, int W, int tid) {
  unsigned* wt_s = reinterpret_cast<unsigned*>(smem + BwdSmem<HD>::wt);
  unsigned w = 0u;
  if (tid < kB * kWordsPerRow) {
    w = words[(size_t)(q0 + tid / kWordsPerRow) * W + kt * kWordsPerRow + tid % kWordsPerRow];
    wt_s[tid] = w;
  }
  return __syncthreads_or(w != 0u);
}

// One (query tile, key tile) pair of the backward: S = Q K^T and dP = dO V^T
// on the tensor cores, then P = exp(S * scale - lse) under the mask bits and
// dS = P * (dP - delta), written as bf16 over S's rows (P) and dP's rows (dS).
template <int HD>
__device__ __forceinline__ void bwd_p_ds(unsigned char* smem, float scale, int tid, int warp) {
  typedef BwdSmem<HD> SM;
  constexpr int LDH = SM::LDH, LDS = SM::LDS, LDP = SM::LDP;
  constexpr int kThreads = kBwdWarps * 32;
  const bf16* q_s = reinterpret_cast<const bf16*>(smem + SM::q);
  const bf16* do_s = reinterpret_cast<const bf16*>(smem + SM::dout);
  const bf16* k_s = reinterpret_cast<const bf16*>(smem + SM::k);
  const bf16* v_s = reinterpret_cast<const bf16*>(smem + SM::v);
  float* s_s = reinterpret_cast<float*>(smem + SM::s);
  float* dp_s = reinterpret_cast<float*>(smem + SM::dp);
  bf16* p_s = reinterpret_cast<bf16*>(smem + SM::s);
  bf16* ds_s = reinterpret_cast<bf16*>(smem + SM::dp);
  const float* lse_s = reinterpret_cast<const float*>(smem + SM::lse);
  const float* delta_s = reinterpret_cast<const float*>(smem + SM::delta);
  const unsigned* wt_s = reinterpret_cast<const unsigned*>(smem + SM::wt);

  // 16 tiles of 16 x 16 in S and in dP; warp w takes tiles w and w + 8
#pragma unroll
  for (int t = warp; t < 16; t += kBwdWarps) {
    const int ti = t / 4, tj = t % 4;
    FragC acc_s, acc_dp;
    wmma::fill_fragment(acc_s, 0.f);
    wmma::fill_fragment(acc_dp, 0.f);
#pragma unroll
    for (int d = 0; d < HD; d += 16) {
      FragARow a;
      FragBCol b;
      wmma::load_matrix_sync(a, q_s + 16 * ti * LDH + d, LDH);
      wmma::load_matrix_sync(b, k_s + 16 * tj * LDH + d, LDH);
      wmma::mma_sync(acc_s, a, b, acc_s);
      wmma::load_matrix_sync(a, do_s + 16 * ti * LDH + d, LDH);
      wmma::load_matrix_sync(b, v_s + 16 * tj * LDH + d, LDH);
      wmma::mma_sync(acc_dp, a, b, acc_dp);
    }
    wmma::store_matrix_sync(s_s + 16 * ti * LDS + 16 * tj, acc_s, LDS, wmma::mem_row_major);
    wmma::store_matrix_sync(dp_s + 16 * ti * LDS + 16 * tj, acc_dp, LDS, wmma::mem_row_major);
  }
  __syncthreads();
  // 4096 elements over 256 threads: read all, sync, then overwrite in place
  constexpr int kPer = kB * kB / kThreads;
  float pv[kPer], dsv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kB, c = e % kB;
    const bool ok = (wt_s[r * kWordsPerRow + c / 32] >> (c % 32)) & 1u;
    const float p = ok ? __expf(s_s[r * LDS + c] * scale - lse_s[r]) : 0.f;
    pv[i] = p;
    dsv[i] = p * (dp_s[r * LDS + c] - delta_s[r]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kB, c = e % kB;
    p_s[r * LDP + c] = __float2bfloat16(pv[i]);
    ds_s[r * LDP + c] = __float2bfloat16(dsv[i]);
  }
  __syncthreads();
}

// load lse and delta of query rows [q0, q0 + kB)
template <int HD>
__device__ __forceinline__ void load_row_stats(unsigned char* smem, const float* __restrict__ lse,
                                               const float* __restrict__ delta, int h, int q0,
                                               int H, int tid) {
  float* lse_s = reinterpret_cast<float*>(smem + BwdSmem<HD>::lse);
  float* delta_s = reinterpret_cast<float*>(smem + BwdSmem<HD>::delta);
  for (int r = tid; r < kB; r += kBwdWarps * 32) {
    const size_t idx = (size_t)(q0 + r) * H + h;
    lse_s[r] = lse[idx];
    delta_s[r] = delta[idx];
  }
}

// write a warp's 16 x 16 accumulator tile, times `mul`, as bf16 rows
// [row0, row0 + 16) x cols [col0, col0 + 16) of one head
__device__ __forceinline__ void store_acc(const FragC& acc, float* stage, bf16* __restrict__ base,
                                          int row0, int col0, size_t rs, float mul, int lane) {
  wmma::store_matrix_sync(stage, acc, kStageLd, wmma::mem_row_major);
  __syncwarp();
  const int rr = lane >> 1, c0 = (lane & 1) * 8;
  bf16* dst = base + (size_t)(row0 + rr) * rs + col0 + c0;
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
        stage[rr * kStageLd + c0 + c] * mul, stage[rr * kStageLd + c0 + c + 1] * mul);
  }
  __syncwarp();
}

template <int HD>
__global__ void __launch_bounds__(kBwdWarps * 32) tree_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const unsigned* __restrict__ words, const int* __restrict__ block_any,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int H, float scale) {
  typedef BwdSmem<HD> SM;
  constexpr int LDH = SM::LDH, LDP = SM::LDP;
  constexpr int kThreads = kBwdWarps * 32;
  constexpr int kFr = HD / 32;  // accumulator tiles per warp (of dK and of dV)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + SM::q);
  bf16* do_s = reinterpret_cast<bf16*>(smem + SM::dout);
  bf16* k_s = reinterpret_cast<bf16*>(smem + SM::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + SM::v);
  const bf16* p_s = reinterpret_cast<const bf16*>(smem + SM::s);
  const bf16* ds_s = reinterpret_cast<const bf16*>(smem + SM::dp);

  const int kt = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rs = (size_t)H * HD;
  const size_t head0 = (size_t)h * HD;
  const int W = N / 32, nB = N / kSkip, nt = N / kB;
  const int k0 = kt * kB;
  const int rstrip = warp % 4;             // key rows 16*rstrip.. of the tile
  const int col0 = (warp / 4) * (HD / 2);  // head-dim columns this warp owns

  load_tile<HD>(k_s, k + head0, k0, rs, tid, kThreads);
  load_tile<HD>(v_s, v + head0, k0, rs, tid, kThreads);

  FragC acc_dk[kFr], acc_dv[kFr];
#pragma unroll
  for (int j = 0; j < kFr; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }
  for (int qt = kt; qt < nt; ++qt) {  // earlier query tiles see none of these keys
    if (!tile_live(block_any, nB, qt, kt)) continue;  // the transposed walk
    const int q0 = qt * kB;
    if (!load_words<HD>(smem, words, q0, kt, W, tid)) continue;
    load_tile<HD>(q_s, q + head0, q0, rs, tid, kThreads);
    load_tile<HD>(do_s, dout + head0, q0, rs, tid, kThreads);
    load_row_stats<HD>(smem, lse, delta, h, q0, H, tid);
    __syncthreads();
    bwd_p_ds<HD>(smem, scale, tid, warp);
    // dV += P^T dO ; dK += dS^T Q  (P^T, dS^T read as column-major)
#pragma unroll
    for (int j = 0; j < kFr; ++j) {
      const int c = col0 + 16 * j;
#pragma unroll
      for (int s = 0; s < kB / 16; ++s) {
        FragACol a;
        FragBRow b;
        wmma::load_matrix_sync(a, p_s + 16 * s * LDP + 16 * rstrip, LDP);
        wmma::load_matrix_sync(b, do_s + 16 * s * LDH + c, LDH);
        wmma::mma_sync(acc_dv[j], a, b, acc_dv[j]);
        wmma::load_matrix_sync(a, ds_s + 16 * s * LDP + 16 * rstrip, LDP);
        wmma::load_matrix_sync(b, q_s + 16 * s * LDH + c, LDH);
        wmma::mma_sync(acc_dk[j], a, b, acc_dk[j]);
      }
    }
    __syncthreads();  // q_s / do_s / P / dS / the words are reloaded next iteration
  }

  // staging: a [16][kStageLd] f32 tile per warp over the (now free) S region
  float* stage = reinterpret_cast<float*>(smem + SM::s) + warp * 16 * kStageLd;
#pragma unroll
  for (int j = 0; j < kFr; ++j) {
    const int c = col0 + 16 * j;
    store_acc(acc_dk[j], stage, dk + head0, k0 + 16 * rstrip, c, rs, scale, lane);
    store_acc(acc_dv[j], stage, dv + head0, k0 + 16 * rstrip, c, rs, 1.f, lane);
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdWarps * 32) tree_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const unsigned* __restrict__ words, const int* __restrict__ block_any,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int N, int H, float scale) {
  typedef BwdSmem<HD> SM;
  constexpr int LDH = SM::LDH, LDP = SM::LDP;
  constexpr int kThreads = kBwdWarps * 32;
  constexpr int kFr = HD / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + SM::q);
  bf16* do_s = reinterpret_cast<bf16*>(smem + SM::dout);
  bf16* k_s = reinterpret_cast<bf16*>(smem + SM::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + SM::v);
  const bf16* ds_s = reinterpret_cast<const bf16*>(smem + SM::dp);

  const int qt = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rs = (size_t)H * HD;
  const size_t head0 = (size_t)h * HD;
  const int W = N / 32, nB = N / kSkip;
  const int q0 = qt * kB;
  const int rstrip = warp % 4;  // query rows 16*rstrip.. of the tile
  const int col0 = (warp / 4) * (HD / 2);

  load_tile<HD>(q_s, q + head0, q0, rs, tid, kThreads);
  load_tile<HD>(do_s, dout + head0, q0, rs, tid, kThreads);
  load_row_stats<HD>(smem, lse, delta, h, q0, H, tid);

  FragC acc_dq[kFr];
#pragma unroll
  for (int j = 0; j < kFr; ++j) wmma::fill_fragment(acc_dq[j], 0.f);
  for (int kt = 0; kt <= qt; ++kt) {
    if (!tile_live(block_any, nB, qt, kt)) continue;
    if (!load_words<HD>(smem, words, q0, kt, W, tid)) continue;
    const int k0 = kt * kB;
    load_tile<HD>(k_s, k + head0, k0, rs, tid, kThreads);
    load_tile<HD>(v_s, v + head0, k0, rs, tid, kThreads);
    __syncthreads();
    bwd_p_ds<HD>(smem, scale, tid, warp);
    // dQ += dS K
#pragma unroll
    for (int j = 0; j < kFr; ++j) {
      const int c = col0 + 16 * j;
#pragma unroll
      for (int s = 0; s < kB / 16; ++s) {
        FragARow a;
        FragBRow b;
        wmma::load_matrix_sync(a, ds_s + 16 * rstrip * LDP + 16 * s, LDP);
        wmma::load_matrix_sync(b, k_s + 16 * s * LDH + c, LDH);
        wmma::mma_sync(acc_dq[j], a, b, acc_dq[j]);
      }
    }
    __syncthreads();  // k_s / v_s / dS / the words are reloaded next iteration
  }

  float* stage = reinterpret_cast<float*>(smem + SM::s) + warp * 16 * kStageLd;
#pragma unroll
  for (int j = 0; j < kFr; ++j) {
    store_acc(acc_dq[j], stage, dq + head0, q0 + 16 * rstrip, col0 + 16 * j, rs, scale, lane);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr size_t kMaxSmem = 232448;  // per block on sm_90 (opt-in)

// 1/sqrt(hd) rounded once from double, as the JAX package's d**-0.5
float softmax_scale(int hd) { return static_cast<float>(1.0 / sqrt(static_cast<double>(hd))); }

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return -2;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, const void* words,
               const void* block_any, void* o, void* lse, int N, int H, cudaStream_t stream) {
  const size_t bytes = FwdSmem<HD>::bytes;
  int rc = set_smem(tree_fwd_kernel<HD>, bytes);
  if (rc != 0) return rc;
  dim3 grid(N / kB, H);
  tree_fwd_kernel<HD><<<grid, kFwdWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned*>(words), static_cast<const int*>(block_any),
      static_cast<bf16*>(o), static_cast<float*>(lse), N, H, softmax_scale(HD));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* words,
               const void* block_any, const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int N, int H, cudaStream_t stream) {
  const size_t bytes = BwdSmem<HD>::bytes;
  int rc = set_smem(tree_bwd_dkv_kernel<HD>, bytes);
  if (rc != 0) return rc;
  dim3 grid(N / kB, H);
  tree_bwd_dkv_kernel<HD><<<grid, kBwdWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned*>(words), static_cast<const int*>(block_any),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, H,
      softmax_scale(HD));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* words,
              const void* block_any, const void* dout, const void* lse, const void* delta,
              void* dq, int N, int H, cudaStream_t stream) {
  const size_t bytes = BwdSmem<HD>::bytes;
  int rc = set_smem(tree_bwd_dq_kernel<HD>, bytes);
  if (rc != 0) return rc;
  dim3 grid(N / kB, H);
  tree_bwd_dq_kernel<HD><<<grid, kBwdWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned*>(words), static_cast<const int*>(block_any),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), N, H, softmax_scale(HD));
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int N, int H) { return N > 0 && N % kSkip == 0 && H > 0 && H <= 65535; }

}  // namespace

// q, k, v, o, dout, dq, dk, dv: contiguous [N, H, hd] bf16; words [N, N/32]
// and block_any [N/128, N/128] int32; lse, delta [N, H] f32 (lse may be null
// in the forward). hd is 64 or 128. Each returns cudaGetLastError() after its
// launch, -1 for an unsupported head dim or shape.
extern "C" int tree_attention_fwd(const void* q, const void* k, const void* v, const void* words,
                                  const void* block_any, void* o, void* lse, int N, int H, int hd,
                                  void* stream) {
  if (!shape_ok(N, H)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_fwd<64>(q, k, v, words, block_any, o, lse, N, H, st);
    case 128: return launch_fwd<128>(q, k, v, words, block_any, o, lse, N, H, st);
    default: return -1;
  }
}

extern "C" int tree_attention_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* words, const void* block_any, const void* dout,
                                     const void* lse, const void* delta, void* dq, int N, int H,
                                     int hd, void* stream) {
  if (!shape_ok(N, H)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_dq<64>(q, k, v, words, block_any, dout, lse, delta, dq, N, H, st);
    case 128: return launch_dq<128>(q, k, v, words, block_any, dout, lse, delta, dq, N, H, st);
    default: return -1;
  }
}

extern "C" int tree_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* words, const void* block_any, const void* dout,
                                      const void* lse, const void* delta, void* dk, void* dv,
                                      int N, int H, int hd, void* stream) {
  if (!shape_ok(N, H)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_dkv<64>(q, k, v, words, block_any, dout, lse, delta, dk, dv, N, H, st);
    case 128:
      return launch_dkv<128>(q, k, v, words, block_any, dout, lse, delta, dk, dv, N, H, st);
    default: return -1;
  }
}
