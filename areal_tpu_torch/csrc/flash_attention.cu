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
// K3 / K4's design (K2's loop and helpers applied to the backward; no
// atomics, so every call gives the same bits and a checkpointed recompute
// is exact; K4 stays a pass of its own for dQ):
//   - K4 (dQ): one block of 4 warps per (64-row query tile, head, grid
//     row), grid (H, nt, G) with the query tile reversed, as K2. Warp w
//     owns rows 16w..16w+15 and keeps its Q and dO fragments (ldmatrix
//     once, from the ring's last stage), lse and di of its rows and dQ (HD
//     / 2 f32 a thread) in registers. For each live KV tile of the 2-stage
//     cp.async K / V ring (segment ids riding with the tile): S = Q K^T and
//     dP = dO V^T on mma.sync m16n8k16 (K and V read by ldmatrix as K2
//     reads K), P = exp(S scale - lse), 0 off the mask, dS = P (dP - di),
//     packed straight from the accumulator layout into bf16 A fragments,
//     and dQ += dS K with K read by ldmatrix.trans as K2 reads V.
//   - K3 (dK, dV): one block of 4 warps per (64-row KV tile, head, grid
//     row), grid (H, nt, G), KV tile 0 (seen by the most query tiles)
//     first. Warp w owns key rows 16w..16w+15; the block's K and V tiles
//     stay in shared memory for the whole walk and their A fragments are
//     read there (in registers they would take the 64 registers a thread
//     that dK and dV's two 16 x HD f32 accumulators need). Query tiles
//     from kt up come through the ring with their ids, lse and di (per
//     column here). It computes the transposes directly: S^T = K Q^T and
//     dP^T = V dO^T, so P^T and dS^T are already in the A-fragment layout
//     of dV += P^T dO and dK += dS^T Q, with dO and Q read by
//     ldmatrix.trans. dK is scaled once at the end.
//   - nothing of S, P, dP or dS goes through shared memory. Both kernels
//     classify each tile pair as K2 does (fwd_tile_ranges from the block's
//     tile onwards; fwd_tile_pairs is the plain twin): skipped pairs are
//     never loaded, interior pairs run without a per-element test, partial
//     pairs test key j against query i by k0 + j <= q0 + i, seg[i] ==
//     seg[j] != 0, and a warp none of whose rows meets the tile skips its
//     math. Rows past L are zero-filled with segment 0 and never stored;
//     padding rows meet no pair, so their gradients are exact zeros.
//   - P and dS are rounded once to bf16 before their products, where the
//     JAX library and the plain twin round them, and P is exp(S scale -
//     lse) in that order of operations. With exp2 and the scale folded in,
//     as K2 has it, P's last bits differ; on the 8,192-token grid that
//     moved the bf16 rounding of one dS element in a row a few tokens into
//     a segment, where few keys meet, and put dQ there at 2.47x the
//     check's limit (dK 2.53x).
//   - resources (sm_90a, nvcc 12.8, measured on an H100;
//     flash_attention_bwd_occupancy reports them): HD = 128 255 registers
//     a thread, no spill, 2 blocks an SM (__launch_bounds__; HD = 64 168
//     registers, at most 12 bytes spilled, 3 blocks); K3 keeps
//     2 stages x (Q, dO) + K and V of 64 x (HD + 8) bf16, the ids, lse and
//     di, and 12 bytes a 64-row tile of L (106,176 B at L = 1,024); K4 K2's
//     70,336 B.
// What holds them, measured (PERF.md): on the trainer's grid the copies
// alone (math skipped) and the math alone (copies skipped) each take
// 71-76% of K3's and K4's time, as for K2: per-block latency of a few tile
// pairs a block. On an 8,192-token row the math alone takes 78% of K3's
// time (1.78 of 2.29 ms) and 72% of K4's: the 16-row warps' ldmatrix reads
// and mma.sync issue hold them at ~28% of the bf16 peak. What they leave
// for later: wgmma and TMA (the lever on long rows, which are operations-
// bound), summing the repeated KV heads' dK / dV inside K3 (GQA: a
// different function from the JAX library's, whose dK / dV are per
// repeated head), a persistent schedule over the live tile pairs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

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

// For tiles begin .. n - 1 of one grid row: lo / hi, the range of the
// tile's nonzero segment ids (INT_MAX / INT_MIN for padding only), and one,
// the id when all 64 rows hold one and the same nonzero id (else 0; rows
// past L count as padding). Warp w takes tiles begin + w, begin + w + 4,
// ...; each lane reads two ids a tile, four tiles' reads in flight at once.
// Caller syncs.
__device__ __forceinline__ void fwd_tile_ranges(const int* __restrict__ seg, int L, int begin, int n, int* lo_s,
                                                int* hi_s, int* one_s, int warp, int lane) {
  constexpr int kU = 4;
  for (int t0 = begin + warp; t0 < n; t0 += kU * kWarps) {
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
  fwd_tile_ranges(segg, L, 0, qt + 1, lo_s, hi_s, one_s, warp, lane);
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

// K3's shared memory. K3 keeps its K and V tiles for the whole walk and
// rings the query side: the K and V tiles, stages x (Q, dO) tiles, stages
// x (ids, lse, di) of 64 query rows, then the tile ranges lo, hi and one of
// the grid row, [nt] each. (K4 has K2's layout, FwdCfg: the ring's stages
// x (K, V) tiles, their segment ids, the tile ranges; Q and dO are staged
// once in the last stage's two tiles.)
template <int HD>
struct BwdCfg {
  static constexpr int stages = 2;
  static constexpr int min_blocks = HD == 128 ? 2 : 3;
  static constexpr int LDH = HD + kPad;
  static constexpr size_t tile = sizeof(bf16) * kT * LDH;
  static constexpr size_t rows = 3 * sizeof(int) * kT;  // ids, lse, di of one stage
  static constexpr size_t ring = 2 * tile;               // after the K and V tiles
  static constexpr size_t row_stats = ring + 2 * stages * tile;
  static constexpr size_t ranges = row_stats + stages * rows;
  static size_t bytes(int nt) { return ranges + sizeof(int) * 3 * nt; }
};

// K4: dQ = scale dS K over the KV tiles 0 .. qt of one query tile, with
// P = exp(S scale - lse) and dS = P (dP - di) recomputed in registers.
template <int HD>
__global__ void __launch_bounds__(kThreads, BwdCfg<HD>::min_blocks) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, bf16* __restrict__ dq, int L, int H, float scale) {
  typedef FwdCfg<HD> CF;
  constexpr int LDH = CF::LDH, kStages = CF::stages;
  extern __shared__ __align__(128) unsigned char smem[];

  const int nt = (L + kT - 1) / kT;
  const int h = blockIdx.x, qt = nt - 1 - static_cast<int>(blockIdx.y), g = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t rs = (size_t)H * HD;
  const size_t head0 = (size_t)g * L * rs + (size_t)h * HD;
  const int* segg = seg + (size_t)g * L;
  const int q0 = qt * kT;
  int* lo_s = reinterpret_cast<int*>(smem + CF::ranges);
  int* hi_s = lo_s + nt;
  int* one_s = hi_s + nt;
  auto kv_tile = [&](int st, int kv) -> bf16* { return reinterpret_cast<bf16*>(smem + (2 * st + kv) * CF::tile); };
  auto seg_tile = [&](int st) -> int* { return reinterpret_cast<int*>(smem + CF::segs) + st * kT; };
  auto issue = [&](int t, int st) {  // KV tile t and its ids -> ring stage st
    const int k0 = t * kT;
    copy_rows<HD>(kv_tile(st, 0), k, head0, rs, k0, L, tid);
    copy_rows<HD>(kv_tile(st, 1), v, head0, rs, k0, L, tid);
    if (tid < kT) {
      const bool ok = k0 + tid < L;
      cp_async4(seg_tile(st) + tid, segg + (ok ? k0 + tid : 0), ok);
    }
  };

  // Q and dO, in flight while the tile ranges are reduced
  copy_rows<HD>(kv_tile(kStages - 1, 0), q, head0, rs, q0, L, tid);
  copy_rows<HD>(kv_tile(kStages - 1, 1), dout, head0, rs, q0, L, tid);
  cp_async_commit();
  int qrow[2], sq[2];  // this thread's rows gq and gq + 8 of its warp, their ids, lse and di
  float lser[2], dir[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + 16 * warp + gq + 8 * r;
    const bool in = qrow[r] < L;
    const size_t idx = ((size_t)g * L + (in ? qrow[r] : 0)) * H + h;
    sq[r] = in ? __ldg(segg + qrow[r]) : 0;
    lser[r] = in ? __ldg(lse + idx) : 0.f;
    dir[r] = in ? __ldg(di + idx) : 0.f;
  }
  fwd_tile_ranges(segg, L, 0, qt + 1, lo_s, hi_s, one_s, warp, lane);
  __syncthreads();
  const int qlo = lo_s[qt], qhi = hi_s[qt], qone = one_s[qt];
  auto next_tile = [&](int t) -> int {  // the next KV tile after t that can hold a valid pair, or -1
    for (++t; t <= qt; ++t)
      if (!(qhi < lo_s[t] || hi_s[t] < qlo)) return t;
    return -1;
  };

  int tl[kStages];  // the ring: tl[0] computing, the rest in flight
  tl[0] = next_tile(-1);
#pragma unroll
  for (int i = 1; i < kStages; ++i) tl[i] = -1;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i > 0 && tl[i - 1] >= 0) tl[i] = next_tile(tl[i - 1]);
    if (tl[i] >= 0) issue(tl[i], i);
    cp_async_commit();
  }

  // Q and dO fragments stay in registers (rows past L are zeros)
  uint32_t qa[HD / 16][4], da[HD / 16][4];
  cp_async_wait<kStages - 1>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (16 * warp + (lane & 15)) * LDH + 16 * kk + (lane >> 4) * 8;
    ldsm_x4(qa[kk], kv_tile(kStages - 1, 0) + off);
    ldsm_x4(da[kk], kv_tile(kStages - 1, 1) + off);
  }
  // (the loop's first barrier frees the stage before it is written)

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int st = 0;
  while (tl[0] >= 0) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int nx = tl[kStages - 2] >= 0 ? next_tile(tl[kStages - 2]) : -1;
      if (nx >= 0) issue(nx, (st + kStages - 1) % kStages);
      cp_async_commit();
      tl[kStages - 1] = nx;
    }
    const int kt = tl[0], k0 = kt * kT;
    const bf16* k_t = kv_tile(st, 0);
    const bf16* v_t = kv_tile(st, 1);
    // bit 16 r + 2 j + e: row r's column 8 j + 2 tq + e is a valid pair
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

    if (__any_sync(kFull, bits != 0u)) {  // some row of the warp meets this tile
      float s[8][4], dp[8][4];
      mma_abt<HD>(s, qa, nullptr, k_t, lane);   // S = Q K^T
      mma_abt<HD>(dp, da, nullptr, v_t, lane);  // dP = dO V^T
      // P = exp(S scale - lse), 0 off the mask; dS = P (dP - di), rounded
      // once to bf16 straight into A fragments (keys 16 kk ..)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t dsa[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = 2 * kk + hh;
            float d[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float p = __expf(s[j][2 * r + e] * scale - lser[r]);
              if (!((bits >> (16 * r + 2 * j + e)) & 1u)) p = 0.f;
              d[e] = p * (dp[j][2 * r + e] - dir[r]);
            }
            dsa[2 * hh + r] = pack_bf16(d[0], d[1]);
          }
        mma_ab<HD>(acc, dsa, k_t, kk, lane);  // dQ += dS K
      }
    }
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) tl[i] = tl[i + 1];
    st = st + 1 == kStages ? 0 : st + 1;
  }
  cp_async_wait<0>();
  store_rows<HD>(dq, acc, qrow, head0, rs, L, scale, tq);  // padding rows: exact zeros
}

// K3: dV = P^T dO and dK = scale dS^T Q over the query tiles kt .. nt - 1 of
// one KV tile, computed as transposes: S^T = K Q^T and dP^T = V dO^T are
// in registers in the A-fragment layout of the two products.
template <int HD>
__global__ void __launch_bounds__(kThreads, BwdCfg<HD>::min_blocks) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H, float scale) {
  typedef BwdCfg<HD> CB;
  constexpr int LDH = CB::LDH, kStages = CB::stages;
  extern __shared__ __align__(128) unsigned char smem[];

  const int nt = (L + kT - 1) / kT;
  const int h = blockIdx.x, kt = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t rs = (size_t)H * HD;
  const size_t head0 = (size_t)g * L * rs + (size_t)h * HD;
  const int* segg = seg + (size_t)g * L;
  const int k0 = kt * kT;
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = reinterpret_cast<bf16*>(smem + CB::tile);
  int* lo_s = reinterpret_cast<int*>(smem + CB::ranges);
  int* hi_s = lo_s + nt;
  int* one_s = hi_s + nt;
  auto qd_tile = [&](int st, int which) -> bf16* {  // which 0: Q, 1: dO
    return reinterpret_cast<bf16*>(smem + CB::ring + (2 * st + which) * CB::tile);
  };
  auto ids_of = [&](int st) -> int* { return reinterpret_cast<int*>(smem + CB::row_stats + st * CB::rows); };
  auto issue = [&](int t, int st) {  // query tile t, its ids, lse and di -> ring stage st
    const int q0 = t * kT;
    copy_rows<HD>(qd_tile(st, 0), q, head0, rs, q0, L, tid);
    copy_rows<HD>(qd_tile(st, 1), dout, head0, rs, q0, L, tid);
    const int r = tid % kT, l = q0 + r;
    const bool ok = l < L;
    const size_t idx = ((size_t)g * L + (ok ? l : 0)) * H + h;
    int* ids = ids_of(st);
    if (tid < kT) {
      cp_async4(ids + r, segg + (ok ? l : 0), ok);
      cp_async4(ids + kT + r, lse + idx, ok);
    } else {
      cp_async4(ids + 2 * kT + r, di + idx, ok);
    }
  };

  // this block's K and V tiles, kept for the whole walk
  copy_rows<HD>(k_s, k, head0, rs, k0, L, tid);
  copy_rows<HD>(v_s, v, head0, rs, k0, L, tid);
  cp_async_commit();
  int krow[2], sk[2];  // this thread's key rows gq and gq + 8 of its warp and their ids
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    krow[r] = k0 + 16 * warp + gq + 8 * r;
    sk[r] = krow[r] < L ? __ldg(segg + krow[r]) : 0;
  }
  fwd_tile_ranges(segg, L, kt, nt, lo_s, hi_s, one_s, warp, lane);
  __syncthreads();
  const int klo = lo_s[kt], khi = hi_s[kt], kone = one_s[kt];
  auto next_tile = [&](int t) -> int {  // the next query tile after t that can hold a valid pair, or -1
    for (++t; t < nt; ++t)
      if (!(khi < lo_s[t] || hi_s[t] < klo)) return t;
    return -1;
  };

  int tl[kStages];  // the ring: tl[0] computing, the rest in flight
  tl[0] = next_tile(kt - 1);
#pragma unroll
  for (int i = 1; i < kStages; ++i) tl[i] = -1;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i > 0 && tl[i - 1] >= 0) tl[i] = next_tile(tl[i - 1]);
    if (tl[i] >= 0) issue(tl[i], i);
    cp_async_commit();
  }

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const bf16* k_w = k_s + 16 * warp * LDH;  // this warp's 16 key rows
  const bf16* v_w = v_s + 16 * warp * LDH;

  int st = 0;
  while (tl[0] >= 0) {
    cp_async_wait<kStages - 2>();  // tl[0] (and, the first time, K and V) landed
    __syncthreads();
    {
      const int nx = tl[kStages - 2] >= 0 ? next_tile(tl[kStages - 2]) : -1;
      if (nx >= 0) issue(nx, (st + kStages - 1) % kStages);
      cp_async_commit();
      tl[kStages - 1] = nx;
    }
    const int qt = tl[0], q0 = qt * kT;
    const bf16* q_t = qd_tile(st, 0);
    const bf16* d_t = qd_tile(st, 1);
    const int* sq = ids_of(st);
    const float* lse_t = reinterpret_cast<const float*>(sq + kT);
    const float* di_t = reinterpret_cast<const float*>(sq + 2 * kT);
    // bit 16 r + 2 j + e: key row r meets query column 8 j + 2 tq + e
    const bool partial = !(qt > kt && kone != 0 && one_s[qt] == kone);
    uint32_t bits = 0xffffffffu;
    if (partial) {
      bits = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * tq + e, sc_ = sq[c];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (sc_ != 0 && sc_ == sk[r] && krow[r] <= q0 + c) bits |= 1u << (16 * r + 2 * j + e);
        }
    }

    if (__any_sync(kFull, bits != 0u)) {  // some key row of the warp meets this tile
      float s[8][4], dp[8][4];
      mma_abt<HD>(s, nullptr, k_w, q_t, lane);  // S^T = K Q^T
      // P^T = exp(S^T scale - lse), lse per column; 0 off the mask
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lc = lse_t[8 * j + 2 * tq + e];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p = __expf(s[j][2 * r + e] * scale - lc);
            s[j][2 * r + e] = (bits >> (16 * r + 2 * j + e)) & 1u ? p : 0.f;
          }
        }
      mma_abt<HD>(dp, nullptr, v_w, d_t, lane);  // dP^T = V dO^T
      // dV += P^T dO and dK += dS^T Q, dS^T = P^T (dP^T - di): P^T and dS^T
      // rounded once to bf16 straight into A fragments (queries 16 kk ..)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4], dsa[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = 2 * kk + hh, c = 8 * j + 2 * tq;
            const float p0 = s[j][2 * r], p1 = s[j][2 * r + 1];
            pa[2 * hh + r] = pack_bf16(p0, p1);
            dsa[2 * hh + r] = pack_bf16(p0 * (dp[j][2 * r] - di_t[c]), p1 * (dp[j][2 * r + 1] - di_t[c + 1]));
          }
        mma_ab<HD>(dva, pa, d_t, kk, lane);
        mma_ab<HD>(dka, dsa, q_t, kk, lane);
      }
    }
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) tl[i] = tl[i + 1];
    st = st + 1 == kStages ? 0 : st + 1;
  }
  cp_async_wait<0>();
  store_rows<HD>(dk, dka, krow, head0, rs, L, scale, tq);  // padding rows: exact zeros
  store_rows<HD>(dv, dva, krow, head0, rs, L, 1.f, tq);
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

// a kernel's registers a thread, dynamic shared memory and blocks an SM
// -> info[0..2]
template <typename Kernel>
int occupancy_of(Kernel kernel, size_t bytes, int* info) {
  int rc = set_smem(kernel, bytes);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  rc = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  if (rc != 0) return rc;
  int blocks = 0;
  rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, bytes));
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(bytes);
  info[2] = blocks;
  return rc;
}

template <int HD>
int fwd_occupancy(int L, int* info) {
  return occupancy_of(flash_fwd_kernel<HD>, FwdCfg<HD>::bytes((L + kT - 1) / kT), info);
}

template <int HD>
int bwd_occupancy(int L, int* info) {
  const int nt = (L + kT - 1) / kT;
  const int rc = occupancy_of(flash_bwd_dkv_kernel<HD>, BwdCfg<HD>::bytes(nt), info);
  return rc != 0 ? rc : occupancy_of(flash_bwd_dq_kernel<HD>, FwdCfg<HD>::bytes(nt), info + 3);
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* seg, const void* dout,
               const void* lse, const void* di, void* dk, void* dv, int G, int L, int H,
               cudaStream_t stream) {
  const int nt = (L + kT - 1) / kT;
  if (nt > 65535) return -1;  // the grid's y
  const size_t bytes = BwdCfg<HD>::bytes(nt);
  int rc = set_smem(flash_bwd_dkv_kernel<HD>, bytes);
  if (rc != 0) return rc;
  dim3 grid(H, nt, G);  // KV tile 0, the one most query tiles see, first
  flash_bwd_dkv_kernel<HD><<<grid, kThreads, bytes, stream>>>(
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
  const int nt = (L + kT - 1) / kT;
  if (nt > 65535) return -1;  // the grid's y
  const size_t bytes = FwdCfg<HD>::bytes(nt);
  int rc = set_smem(flash_bwd_dq_kernel<HD>, bytes);
  if (rc != 0) return rc;
  dim3 grid(H, nt, G);  // the query tile reversed: the one with the most KV tiles first
  flash_bwd_dq_kernel<HD><<<grid, kThreads, bytes, stream>>>(
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

// K3's (info[0..2]) and K4's (info[3..5]) resources for rows of L tokens,
// as flash_attention_fwd_occupancy reports K2's.
extern "C" int flash_attention_bwd_occupancy(int hd, int L, int* info) {
  if (L < 0) return -1;
  switch (hd) {
    case 64: return bwd_occupancy<64>(L, info);
    case 128: return bwd_occupancy<128>(L, info);
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
