// Packed segment-causal flash attention for Hopper (sm_90a): forward and
// backward, called through ctypes.
//
// Replaces, on the trainer's path:
//   - K2 flash_attention_fwd: areal_tpu/ops/attention.py:flash_fwd_pallas
//     (_flash_fwd_kernel), the no-grad forward, and the forward of jax's
//     library flash_attention (jax/experimental/pallas/ops/tpu/
//     flash_attention.py:758) reached through ops/attention.py:flash_train,
//     which keeps the per-row logsumexp for the backward;
//   - K3 flash_attention_bwd_dkv: that library's _flash_attention_bwd_dkv
//     (flash_attention.py:1121);
//   - K4 flash_attention_bwd_dq: its _flash_attention_bwd_dq (:1456).
// The function: q, k, v [G, L, H, HD] bf16 (KV heads already repeated to
// H), segment ids [G, L] int32. Query row i attends to key row j of the same
// grid row when j <= i (causal by column index, not by rope position),
// seg[j] == seg[i] and seg[i] != 0 (0 = padding). Segment ids are any
// nonzero ints, and a segment need not be one contiguous run. Softmax scale
// 1/sqrt(HD). Rows with no valid key (padding) output zeros and a
// logsumexp of 0; they take and give no gradient. The backward takes
// di = rowsum(dO * O) from the caller, as the JAX library computes it
// outside its kernels.
//
// What bounds it: the segment lengths decide. The forward does
// 2 * HD * H * sum(n^2) flops (q.k and p.v over each segment's causal pairs)
// on 8 * G * L * H * HD bytes (q, k, v, o in bf16): about n/4 flop/byte for
// rows filled with segments of n tokens. The H100 needs ~295 flop/byte
// (989 TFLOP/s bf16 over 3.35 TB/s), so segments shorter than ~1,200 tokens
// (the trainer's rollouts of a few hundred) are bound by the bytes, longer
// ones (long reasoning rollouts of several thousand) by the tensor cores.
// The backward is the same with 2.5x the flops of a fused backward (K3's
// four products and K4's three here, since each recomputes S and dP) on a
// few more bytes.
//
// K2's design (FlashAttention-2 on mma.sync, flash_mma.cuh's helpers, as
// kernel #3's suffix_kernel):
//   - one block of 4 warps per (64-row query tile, head, grid row); warp w
//     owns rows 16w..16w+15 and keeps its Q fragments (ldmatrix once), S (32
//     f32 a thread), P (bf16 A fragments packed straight from S's
//     accumulator layout) and O (HD / 2 f32 a thread) in registers. Both
//     products are mma.sync m16n8k16 bf16 -> f32, V read by ldmatrix.trans;
//     row max and sum use the quad's shuffles; the softmax scale is folded
//     into exp2's argument, O is rescaled only when a row's max moved and
//     normalised once at the end; lse = (m + log2 l) ln 2. Nothing of S, P
//     or O goes through shared memory, and O's bits do not depend on
//     whether lse is written.
//   - a cp.async ring of 64-row K and V tiles (2 stages, one barrier a
//     tile): the next tile is in flight while one computes. Each tile's 64
//     segment ids ride with it; rows past L are zero-filled with segment 0.
//     Rows are padded by 16 bytes: ldmatrix is free of bank conflicts. The
//     query tile is staged once in the ring's last stage.
//   - each block first reduces, for tiles 0..its own, the nonzero
//     segment-id range of every 64-row tile and whether the tile holds one
//     nonzero id only (fwd_tile_ranges, redux.sync). A (query tile, KV
//     tile) pair is then skipped (the KV tile lies in the future, or the
//     two ranges do not meet: it is never loaded), interior (both tiles
//     hold one and the same nonzero id and the KV tile lies wholly before
//     the query tile: no per-element test) or partial (the diagonal,
//     segment boundaries, padding: the test from the staged ids, and a warp
//     none of whose rows attends the tile skips its math). The class is
//     uniform in the block. ops/attention.py:fwd_tile_pairs is its plain
//     twin.
//   - on a partial tile P enters the P.V product as the bf16 pair hi + lo
//     (two MMAs, 16 bits of P kept): rows near a segment's start average
//     few keys, and P rounded to bf16 alone put their worst element past
//     the element-wise check on a row of 5,000 + 3,192 tokens (1.07x the
//     limit; with the pair the long grid's worst is 0.58x). Interior
//     tiles, where every row has many keys, round P once.
//   - launch order: grid (H, nt, G) with the query tile reversed, so within
//     a grid row the tiles with the most KV tiles start first and the heads
//     of one row run together (K and V of a row stay in L2); each block
//     walks its KV tiles from 0 up. No atomics: every call gives the same
//     bits, so a checkpointed recompute reproduces the forward.
//   - resources (sm_90a, nvcc 12.8, measured on an H100;
//     flash_attention_fwd_occupancy reports them, chip_smoke.py prints
//     them): HD = 128 168 registers (__launch_bounds__ for 3 blocks an SM;
//     44 bytes spilled), HD = 64 128 registers; shared memory 2 stages x
//     (K, V) of 64 x (HD + 8) bf16, the ids, and 12 bytes a 64-row tile of
//     L (70,336 B at HD = 128, L = 1,024): 3 blocks of 4 warps an SM.
//     2 blocks (240 registers) and a 3-stage ring measured no faster, nor
//     did walking from the diagonal down or staging O for 16-byte stores.
// What holds it now, measured (PERF.md): on the trainer's grid (segments
// of 199-573 tokens) loads alone and math alone each take ~75% of the
// kernel's time; on an 8,192-token row the 16-row warps' ldmatrix reads of
// every K / V tile and the L2 -> shared copies of 64-row tiles (each ~1.0
// ms of 1.35) hold it at ~23% of the bf16 peak. What it leaves for later:
// wgmma and TMA (fewer shared-memory reads per product: the lever for long
// rows, which are operations-bound), 128-row query tiles, a persistent
// schedule.
//
// K3 / K4 (simple and correct first, unchanged since they were ported):
//   - tiles of 64 query rows x 64 key rows; every product (do.v^T, p^T.do,
//     ds^T.q, ds.k and the recomputed q.k^T) runs on the tensor cores
//     through WMMA 16x16x16 bf16 fragments with f32 accumulation, from
//     shared memory;
//   - K3: one block per (KV tile, head, grid row), 8 warps, looping over the
//     query tiles at or after it; dK and dV stay in WMMA accumulators. K4:
//     one block per (query tile, head, grid row), looping over the KV tiles
//     at or before it; dQ stays in accumulators. Both recompute
//     P = exp(S * scale - lse) and take dS = P * (dP - di);
//   - tiles entirely in the future are skipped, and so are tile pairs whose
//     (nonzero) segment-id ranges do not meet: each block first reduces the
//     min / max segment id of every 64-row tile of its grid row;
//   - rows past L (L need not be a multiple of 64) load as zeros with
//     segment 0 and are never stored.
// What they do not do yet: cp.async double buffering, mma.sync with S and
// dP in registers, one fused backward.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using namespace nvcuda;

// K3 / K4's tiles (K2 uses flash_mma.cuh's kT, kWarps, kThreads, kPad)
constexpr int kB = 64;         // rows per query tile and per key tile
constexpr int kBwdWarps = 8;   // backward
constexpr int kPadH = 8;       // bf16 row padding (elements): ldm % 8 == 0
constexpr int kPadF = 4;       // f32 row padding: ldm % 4 == 0
constexpr int kStageLd = 20;   // f32 staging tile [16][20] for the backward stores

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// 32-byte aligned byte offsets of the shared-memory regions
__host__ __device__ constexpr size_t align32(size_t n) { return (n + 31) / 32 * 32; }

// Copy rows [r0, r0 + kB) of one head of a [G, L, H, HD] tensor into a
// [kB][HD + kPadH] shared tile; rows at or past L become zeros.
// `base` points at (g, 0, h, 0); consecutive rows are `rs` elements apart.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ base,
                                          int r0, int L, size_t rs, int tid, int nthr) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int LD = HD + kPadH;
  for (int c = tid; c < kB * kChunks; c += nthr) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int l = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (l < L) val = *reinterpret_cast<const uint4*>(base + (size_t)l * rs + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

// min / max of the nonzero segment ids of every 64-row tile of one grid row
// (INT_MAX / INT_MIN for a tile of padding only). Caller syncs afterwards.
__device__ __forceinline__ void tile_segment_ranges(const int* __restrict__ seg, int L, int nt,
                                                    int* lo_s, int* hi_s, int warp, int lane,
                                                    int nwarps) {
  for (int t = warp; t < nt; t += nwarps) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < kB; r += 32) {
      const int l = t * kB + r;
      const int s = l < L ? seg[l] : 0;
      if (s != 0) {
        lo = min(lo, s);
        hi = max(hi, s);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFull, lo, o));
      hi = max(hi, __shfl_xor_sync(kFull, hi, o));
    }
    if (lane == 0) {
      lo_s[t] = lo;
      hi_s[t] = hi;
    }
  }
}

__device__ __forceinline__ bool ranges_meet(int alo, int ahi, int blo, int bhi) {
  return !(ahi < blo || bhi < alo);  // empty ranges (INT_MAX, INT_MIN) never meet
}

// ---------------------------------------------------------------------------
// K2: forward
// ---------------------------------------------------------------------------

// K2's shared memory: the ring's stages x (K, V) tiles of 64 rows of
// HD + kPad bf16 (the query tile is staged in the last stage's K tile
// before the loop), the ring's key segment ids [stages][64], then the tile
// ranges lo, hi, one [nt] of the grid row.
template <int HD>
struct FwdCfg {
  static constexpr int stages = 2;
  static constexpr int min_blocks = HD == 128 ? 3 : 4;
  static constexpr int LDH = HD + kPad;
  static constexpr size_t tile = sizeof(bf16) * kT * LDH;
  static constexpr size_t segs = 2 * stages * tile;
  static constexpr size_t ranges = segs + sizeof(int) * stages * kT;
  static size_t bytes(int nt) { return ranges + sizeof(int) * 3 * nt; }
};

// For tiles 0 .. n - 1 of one grid row: lo / hi, the range of the tile's
// nonzero segment ids (INT_MAX / INT_MIN for padding only), and one, the
// id when all 64 rows hold one and the same nonzero id (else 0; rows past
// L count as padding). Warp w takes tiles w, w + 4, ...; each lane reads
// two ids a tile, four tiles' reads in flight at once. Caller syncs.
__device__ __forceinline__ void fwd_tile_ranges(const int* __restrict__ seg, int L, int n, int* lo_s,
                                                int* hi_s, int* one_s, int warp, int lane) {
  constexpr int kU = 4;
  for (int t0 = warp; t0 < n; t0 += kU * kWarps) {
    int ids[kU][2];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + u * kWarps, l = t * kT + 32 * e + lane;
        ids[u][e] = t < n && l < L ? __ldg(seg + l) : 0;
      }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u * kWarps;
      if (t >= n) break;  // uniform in the warp
      const int a = ids[u][0], b = ids[u][1];
      const int lo = __reduce_min_sync(kFull, min(a != 0 ? a : INT_MAX, b != 0 ? b : INT_MAX));
      const int hi = __reduce_max_sync(kFull, max(a != 0 ? a : INT_MIN, b != 0 ? b : INT_MIN));
      const bool pad = __any_sync(kFull, a == 0 || b == 0);
      if (lane == 0) {
        lo_s[t] = lo;
        hi_s[t] = hi;
        one_s[t] = !pad && lo == hi ? lo : 0;
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, FwdCfg<HD>::min_blocks) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, bf16* __restrict__ o, float* __restrict__ lse, int L, int H,
    float scale_log2) {
  typedef FwdCfg<HD> CF;
  constexpr int LDH = CF::LDH, kStages = CF::stages;
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a row
  static_assert(kT * kChunks % kThreads == 0, "whole chunks a thread");
  extern __shared__ __align__(128) unsigned char smem[];

  const int nt = (L + kT - 1) / kT;
  const int h = blockIdx.x, qt = nt - 1 - static_cast<int>(blockIdx.y), g = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row group, thread of the quad
  const size_t rs = (size_t)H * HD;         // elements between consecutive rows of one head
  const size_t head0 = (size_t)g * L * rs + (size_t)h * HD;
  const int* segg = seg + (size_t)g * L;
  const int q0 = qt * kT;
  int* lo_s = reinterpret_cast<int*>(smem + CF::ranges);
  int* hi_s = lo_s + nt;
  int* one_s = hi_s + nt;
  auto kv_tile = [&](int st, int kv) -> bf16* { return reinterpret_cast<bf16*>(smem + (2 * st + kv) * CF::tile); };
  auto seg_tile = [&](int st) -> int* { return reinterpret_cast<int*>(smem + CF::segs) + st * kT; };

  // rows r0 .. r0 + 63 of this head of a [G, L, H, HD] tensor -> a padded
  // tile; rows past L are zero-filled, not read
  auto copy_tile = [&](bf16* dst, const bf16* __restrict__ src, int r0) {
#pragma unroll
    for (int i = 0; i < kT * kChunks / kThreads; ++i) {
      const int c = tid + i * kThreads, rr = c / kChunks, ch = c % kChunks, l = r0 + rr;
      const bool ok = l < L;
      cp_async16(dst + rr * LDH + ch * 8, src + (ok ? head0 + (size_t)l * rs + ch * 8 : 0), ok);
    }
  };
  auto issue = [&](int t, int st) {  // KV tile t and its ids -> ring stage st
    const int k0 = t * kT;
    copy_tile(kv_tile(st, 0), k, k0);
    copy_tile(kv_tile(st, 1), v, k0);
    if (tid < kT) {
      const bool ok = k0 + tid < L;
      cp_async4(seg_tile(st) + tid, segg + (ok ? k0 + tid : 0), ok);
    }
  };

  // the query tile, in flight while the tile ranges are reduced
  copy_tile(kv_tile(kStages - 1, 0), q, q0);
  cp_async_commit();
  int qrow[2], sq[2];  // this thread's rows gq and gq + 8 of its warp, and their ids
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + 16 * warp + gq + 8 * r;
    sq[r] = qrow[r] < L ? __ldg(segg + qrow[r]) : 0;
  }
  fwd_tile_ranges(segg, L, qt + 1, lo_s, hi_s, one_s, warp, lane);
  __syncthreads();
  const int qlo = lo_s[qt], qhi = hi_s[qt], qone = one_s[qt];
  // the next KV tile after t that can hold a valid pair, or -1 (uniform)
  auto next_tile = [&](int t) -> int {
    for (++t; t <= qt; ++t)
      if (!(qhi < lo_s[t] || hi_s[t] < qlo)) return t;
    return -1;
  };

  // the ring: tiles tl[0] (computing) .. tl[kStages - 2] in flight
  int tl[kStages];
  tl[0] = next_tile(-1);
#pragma unroll
  for (int i = 1; i < kStages; ++i) tl[i] = -1;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i > 0 && tl[i - 1] >= 0) tl[i] = next_tile(tl[i - 1]);
    if (tl[i] >= 0) issue(tl[i], i);
    cp_async_commit();
  }

  // the query fragments stay in registers (rows past L are zeros)
  uint32_t qa[HD / 16][4];
  cp_async_wait<kStages - 1>();
  __syncthreads();
  {
    const bf16* q_s = kv_tile(kStages - 1, 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm_x4(qa[kk], q_s + (16 * warp + (lane & 15)) * LDH + 16 * kk + (lane >> 4) * 8);
    // (the loop's first barrier frees the stage before it is written)
  }

  float oacc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m: log2 domain; l: this thread's columns

  int st = 0;  // the stage of tl[0]
  while (tl[0] >= 0) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tl[0] have landed
    __syncthreads();               // every thread's; and the stage written next is free
    {
      const int nx = tl[kStages - 2] >= 0 ? next_tile(tl[kStages - 2]) : -1;
      if (nx >= 0) issue(nx, (st + kStages - 1) % kStages);
      cp_async_commit();
      tl[kStages - 1] = nx;
    }
    const int kt = tl[0], k0 = kt * kT;
    const bf16* k_t = kv_tile(st, 0);
    const bf16* v_t = kv_tile(st, 1);
    // this thread's valid pairs: bit 16 r + 2 j + e is row r's column
    // 8 j + 2 tq + e; an interior pair needs no test
    const bool partial = !(kt < qt && qone != 0 && one_s[kt] == qone);
    uint32_t bits = 0xffffffffu;
    if (partial) {
      const int* sk = seg_tile(st);
      bits = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * tq + e, sc_ = sk[c];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (sq[r] != 0 && sc_ == sq[r] && k0 + c <= qrow[r]) bits |= 1u << (16 * r + 2 * j + e);
        }
    }

    if (__any_sync(kFull, bits != 0u)) {  // some row of the warp attends this tile
      // S = Q K^T: 8 column tiles of 8 keys, in registers
      float sc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t b[4];
          ldsm_x4(b, k_t + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * LDH + 16 * kk + ((lane >> 3) & 1) * 8);
          mma16816(sc[2 * jj], qa[kk], b[0], b[1]);
          mma16816(sc[2 * jj + 1], qa[kk], b[2], b[3]);
        }
      }
      // online softmax in the log2 domain: masked columns are -inf; the
      // scale is folded into the exponent, exp2(s * scale_log2 - m)
      if (bits != 0xffffffffu) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (!((bits >> (16 * r + 2 * j + e)) & 1u)) sc[j][2 * r + e] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      float alpha[2], msub[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        alpha[r] = m_new == -INFINITY ? 1.f : fast_exp2(m[r] - m_new);  // 0 while the row had nothing
        msub[r] = m_new == -INFINITY ? 0.f : m_new;
        m[r] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = fast_exp2(fmaf(sc[j][2 * r + e], scale_log2, -msub[r]));  // masked: 0
            psum[r] += p;
            sc[j][2 * r + e] = p;
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
      if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a row's max moved
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          oacc[n][0] *= alpha[0];
          oacc[n][1] *= alpha[0];
          oacc[n][2] *= alpha[1];
          oacc[n][3] *= alpha[1];
        }
      }
      // O += P V, P as bf16 A fragments of keys 16 kk .. 16 kk + 15. On a
      // partial tile P is the bf16 pair hi + lo (16 bits kept): rows near a
      // segment's start average few keys, so P's rounding does not average
      // out there as it does over long rows
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4], pl[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p0 = sc[2 * kk + hh][2 * r], p1 = sc[2 * kk + hh][2 * r + 1];
            pa[2 * hh + r] = pack_bf16(p0, p1);
            if (partial) {
              const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&pa[2 * hh + r]);
              pl[2 * hh + r] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
            }
          }
#pragma unroll
        for (int dd = 0; dd < HD / 16; ++dd) {
          uint32_t b[4];
          ldsm_x4_t(b, v_t + (16 * kk + (lane & 15)) * LDH + 16 * dd + (lane >> 4) * 8);
          mma16816(oacc[2 * dd], pa, b[0], b[1]);
          mma16816(oacc[2 * dd + 1], pa, b[2], b[3]);
          if (partial) {
            mma16816(oacc[2 * dd], pl, b[0], b[1]);
            mma16816(oacc[2 * dd + 1], pl, b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) tl[i] = tl[i + 1];
    st = st + 1 == kStages ? 0 : st + 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= L) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no valid key: exact zeros
    bf16* orow = o + head0 + (size_t)qrow[r] * rs;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * tq) =
          __floats2bfloat162_rn(oacc[n][2 * r] * inv, oacc[n][2 * r + 1] * inv);
    if (lse != nullptr && tq == 0)
      lse[((size_t)g * L + qrow[r]) * H + h] = l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K3 / K4: backward
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
  static constexpr size_t di = lse + sizeof(float) * kB;
  static constexpr size_t segq = di + sizeof(float) * kB;
  static constexpr size_t segk = segq + sizeof(int) * kB;
  static constexpr size_t ranges = segk + sizeof(int) * kB;
  static size_t bytes(int nt) { return ranges + sizeof(int) * 2 * nt; }
};

// One (query tile, key tile) pair of the backward: S = Q K^T and dP = dO V^T
// on the tensor cores, then P = exp(S * scale - lse) under the mask and
// dS = P * (dP - di), written as bf16 over S's rows (P) and dP's rows (dS).
template <int HD>
__device__ __forceinline__ void bwd_p_ds(unsigned char* smem, int q0, int k0, float scale,
                                         int tid, int warp) {
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
  const float* di_s = reinterpret_cast<const float*>(smem + SM::di);
  const int* segq_s = reinterpret_cast<const int*>(smem + SM::segq);
  const int* segk_s = reinterpret_cast<const int*>(smem + SM::segk);

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
    const int sq = segq_s[r];
    const bool ok = sq != 0 && segk_s[c] == sq && k0 + c <= q0 + r;
    const float p = ok ? __expf(s_s[r * LDS + c] * scale - lse_s[r]) : 0.f;
    pv[i] = p;
    dsv[i] = p * (dp_s[r * LDS + c] - di_s[r]);
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

// load lse, di and the segment ids of query rows [q0, q0 + kB)
template <int HD>
__device__ __forceinline__ void load_row_stats(unsigned char* smem, const float* __restrict__ lse,
                                               const float* __restrict__ di,
                                               const int* __restrict__ segg, int g, int h,
                                               int q0, int L, int H, int tid) {
  typedef BwdSmem<HD> SM;
  float* lse_s = reinterpret_cast<float*>(smem + SM::lse);
  float* di_s = reinterpret_cast<float*>(smem + SM::di);
  int* segq_s = reinterpret_cast<int*>(smem + SM::segq);
  for (int r = tid; r < kB; r += kBwdWarps * 32) {
    const int l = q0 + r;
    const bool in = l < L;
    const size_t idx = ((size_t)g * L + l) * H + h;
    lse_s[r] = in ? lse[idx] : 0.f;
    di_s[r] = in ? di[idx] : 0.f;
    segq_s[r] = in ? segg[l] : 0;
  }
}

// write a warp's 16 x 16 accumulator tile, times `mul`, as bf16 rows
// [row0, row0 + 16) x cols [col0, col0 + 16) of one head; rows >= L skipped
__device__ __forceinline__ void store_acc(const FragC& acc, float* stage, bf16* __restrict__ base,
                                          int row0, int col0, int L, size_t rs, float mul,
                                          int lane) {
  wmma::store_matrix_sync(stage, acc, kStageLd, wmma::mem_row_major);
  __syncwarp();
  const int rr = lane >> 1, c0 = (lane & 1) * 8;
  const int l = row0 + rr;
  if (l < L) {
    bf16* dst = base + (size_t)l * rs + col0 + c0;
#pragma unroll
    for (int c = 0; c < 8; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
          stage[rr * kStageLd + c0 + c] * mul, stage[rr * kStageLd + c0 + c + 1] * mul);
    }
  }
  __syncwarp();
}

template <int HD>
__global__ void __launch_bounds__(kBwdWarps * 32) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H,
    float scale) {
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
  int* segk_s = reinterpret_cast<int*>(smem + SM::segk);
  const int nt = (L + kB - 1) / kB;
  int* lo_s = reinterpret_cast<int*>(smem + SM::ranges);
  int* hi_s = lo_s + nt;

  const int kt = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rs = (size_t)H * HD;
  const size_t head0 = (size_t)g * L * rs + (size_t)h * HD;
  const int* segg = seg + (size_t)g * L;
  const int k0 = kt * kB;
  const int rstrip = warp % 4;            // key rows 16*rstrip.. of the tile
  const int col0 = (warp / 4) * (HD / 2);  // head-dim columns this warp owns

  tile_segment_ranges(segg, L, nt, lo_s, hi_s, warp, lane, kBwdWarps);
  load_tile<HD>(k_s, k + head0, k0, L, rs, tid, kThreads);
  load_tile<HD>(v_s, v + head0, k0, L, rs, tid, kThreads);
  for (int j = tid; j < kB; j += kThreads) segk_s[j] = k0 + j < L ? segg[k0 + j] : 0;
  __syncthreads();

  FragC acc_dk[kFr], acc_dv[kFr];
#pragma unroll
  for (int j = 0; j < kFr; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }
  const int klo = lo_s[kt], khi = hi_s[kt];
  for (int qt = kt; qt < nt; ++qt) {  // earlier query tiles see none of these keys
    if (!ranges_meet(lo_s[qt], hi_s[qt], klo, khi)) continue;
    const int q0 = qt * kB;
    load_tile<HD>(q_s, q + head0, q0, L, rs, tid, kThreads);
    load_tile<HD>(do_s, dout + head0, q0, L, rs, tid, kThreads);
    load_row_stats<HD>(smem, lse, di, segg, g, h, q0, L, H, tid);
    __syncthreads();
    bwd_p_ds<HD>(smem, q0, k0, scale, tid, warp);
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
    __syncthreads();  // q_s / do_s / P / dS are reloaded next iteration
  }

  // staging: a [16][kStageLd] f32 tile per warp over the (now free) S region
  float* stage = reinterpret_cast<float*>(smem + SM::s) + warp * 16 * kStageLd;
#pragma unroll
  for (int j = 0; j < kFr; ++j) {
    const int c = col0 + 16 * j;
    store_acc(acc_dk[j], stage, dk + head0, k0 + 16 * rstrip, c, L, rs, scale, lane);
    store_acc(acc_dv[j], stage, dv + head0, k0 + 16 * rstrip, c, L, rs, 1.f, lane);
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdWarps * 32) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, bf16* __restrict__ dq, int L, int H, float scale) {
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
  int* segk_s = reinterpret_cast<int*>(smem + SM::segk);
  const int nt = (L + kB - 1) / kB;
  int* lo_s = reinterpret_cast<int*>(smem + SM::ranges);
  int* hi_s = lo_s + nt;

  const int qt = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rs = (size_t)H * HD;
  const size_t head0 = (size_t)g * L * rs + (size_t)h * HD;
  const int* segg = seg + (size_t)g * L;
  const int q0 = qt * kB;
  const int rstrip = warp % 4;            // query rows 16*rstrip.. of the tile
  const int col0 = (warp / 4) * (HD / 2);

  tile_segment_ranges(segg, L, nt, lo_s, hi_s, warp, lane, kBwdWarps);
  load_tile<HD>(q_s, q + head0, q0, L, rs, tid, kThreads);
  load_tile<HD>(do_s, dout + head0, q0, L, rs, tid, kThreads);
  load_row_stats<HD>(smem, lse, di, segg, g, h, q0, L, H, tid);
  __syncthreads();

  FragC acc_dq[kFr];
#pragma unroll
  for (int j = 0; j < kFr; ++j) wmma::fill_fragment(acc_dq[j], 0.f);
  const int qlo = lo_s[qt], qhi = hi_s[qt];
  for (int kt = 0; kt <= qt; ++kt) {
    if (!ranges_meet(qlo, qhi, lo_s[kt], hi_s[kt])) continue;
    const int k0 = kt * kB;
    load_tile<HD>(k_s, k + head0, k0, L, rs, tid, kThreads);
    load_tile<HD>(v_s, v + head0, k0, L, rs, tid, kThreads);
    for (int j = tid; j < kB; j += kThreads) segk_s[j] = k0 + j < L ? segg[k0 + j] : 0;
    __syncthreads();
    bwd_p_ds<HD>(smem, q0, k0, scale, tid, warp);
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
    __syncthreads();  // k_s / v_s / dS are reloaded next iteration
  }

  float* stage = reinterpret_cast<float*>(smem + SM::s) + warp * 16 * kStageLd;
#pragma unroll
  for (int j = 0; j < kFr; ++j) {
    store_acc(acc_dq[j], stage, dq + head0, q0 + 16 * rstrip, col0 + 16 * j, L, rs, scale, lane);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// 1/sqrt(hd) rounded once from double, as the JAX package's d**-0.5
float softmax_scale(int hd) { return static_cast<float>(1.0 / sqrt(static_cast<double>(hd))); }

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return -2;
  // cheap, and per device: set before every launch rather than cache it
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
               int G, int L, int H, cudaStream_t stream) {
  const int nt = (L + kT - 1) / kT;
  if (nt > 65535) return -1;  // the grid's y
  const size_t bytes = FwdCfg<HD>::bytes(nt);
  int rc = set_smem(flash_fwd_kernel<HD>, bytes);
  if (rc != 0) return rc;
  dim3 grid(H, nt, G);
  flash_fwd_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<bf16*>(o), static_cast<float*>(lse), L, H,
      static_cast<float>(kLog2e / sqrt(static_cast<double>(HD))));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int fwd_occupancy(int L, int* info) {
  const size_t bytes = FwdCfg<HD>::bytes((L + kT - 1) / kT);
  int rc = set_smem(flash_fwd_kernel<HD>, bytes);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  rc = static_cast<int>(cudaFuncGetAttributes(&attr, flash_fwd_kernel<HD>));
  if (rc != 0) return rc;
  int blocks = 0;
  rc = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd_kernel<HD>, kThreads, bytes));
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(bytes);
  info[2] = blocks;
  return rc;
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* seg, const void* dout,
               const void* lse, const void* di, void* dk, void* dv, int G, int L, int H,
               cudaStream_t stream) {
  const int nt = (L + kB - 1) / kB;
  const size_t bytes = BwdSmem<HD>::bytes(nt);
  int rc = set_smem(flash_bwd_dkv_kernel<HD>, bytes);
  if (rc != 0) return rc;
  dim3 grid(nt, H, G);
  flash_bwd_dkv_kernel<HD><<<grid, kBwdWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L, H, softmax_scale(HD));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* seg, const void* dout,
              const void* lse, const void* di, void* dq, int G, int L, int H,
              cudaStream_t stream) {
  const int nt = (L + kB - 1) / kB;
  const size_t bytes = BwdSmem<HD>::bytes(nt);
  int rc = set_smem(flash_bwd_dq_kernel<HD>, bytes);
  if (rc != 0) return rc;
  dim3 grid(nt, H, G);
  flash_bwd_dq_kernel<HD><<<grid, kBwdWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<bf16*>(dq), L,
      H, softmax_scale(HD));
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int G, int L, int H) { return G >= 0 && L >= 0 && H > 0 && H <= 65535 && G <= 65535; }

}  // namespace

// q, k, v, o, dout, dq, dk, dv: contiguous [G, L, H, hd] bf16; seg [G, L]
// int32; lse, di [G, L, H] f32 (lse may be null in the forward: the no-grad
// caller does not keep it). hd is 64 or 128. Each returns cudaGetLastError()
// after its launch, -1 for an unsupported head dim or shape, -2 when the
// row is too long for the block's shared memory.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* seg,
                                   void* o, void* lse, int G, int L, int H, int hd,
                                   void* stream) {
  if (!shape_ok(G, L, H)) return -1;
  if (G == 0 || L == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_fwd<64>(q, k, v, seg, o, lse, G, L, H, st);
    case 128: return launch_fwd<128>(q, k, v, seg, o, lse, G, L, H, st);
    default: return -1;
  }
}

// K2's resources for rows of L tokens: info[0] registers a thread, info[1]
// dynamic shared memory bytes, info[2] blocks an SM holds.
extern "C" int flash_attention_fwd_occupancy(int hd, int L, int* info) {
  if (L < 0) return -1;
  switch (hd) {
    case 64: return fwd_occupancy<64>(L, info);
    case 128: return fwd_occupancy<128>(L, info);
    default: return -1;
  }
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* seg, const void* dout, const void* lse,
                                       const void* di, void* dk, void* dv, int G, int L, int H,
                                       int hd, void* stream) {
  if (!shape_ok(G, L, H)) return -1;
  if (G == 0 || L == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_dkv<64>(q, k, v, seg, dout, lse, di, dk, dv, G, L, H, st);
    case 128: return launch_dkv<128>(q, k, v, seg, dout, lse, di, dk, dv, G, L, H, st);
    default: return -1;
  }
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* seg, const void* dout, const void* lse,
                                      const void* di, void* dq, int G, int L, int H, int hd,
                                      void* stream) {
  if (!shape_ok(G, L, H)) return -1;
  if (G == 0 || L == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_dq<64>(q, k, v, seg, dout, lse, di, dq, G, L, H, st);
    case 128: return launch_dq<128>(q, k, v, seg, dout, lse, di, dq, G, L, H, st);
    default: return -1;
  }
}
