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
// #4's design (K2's forward loop of flash_attention.cu on #5's walk below,
// with the tile products of flash_mma.cuh; no atomics, so every call gives
// the same bits, and O's bits do not depend on whether lse is written):
//   - one block of 4 warps per (64-row query tile, head), grid (H, nt) with
//     the query tile reversed, so the longest walks start first. The block
//     walks #5's list of its live key tiles 0..qt through a 2-stage
//     cp.async ring of K and V tiles with the pair's 64 x 2 mask words
//     (row-major), #5's shared memory exactly; the query tile is staged
//     once in the ring's last stage and read into A fragments once.
//   - warp w owns rows 16w..16w+15 and keeps Q's fragments, S (32 f32 a
//     thread), P (bf16 A fragments packed straight from S's accumulator
//     layout) and O (HD / 2 f32 a thread) in registers. S = Q K^T and O +=
//     P V run on mma.sync m16n8k16 bf16 -> f32, V read by ldmatrix.trans.
//     On a partial pair S is -inf where the bit is clear, and a warp none
//     of whose rows has a bit in the pair skips its math; a full pair
//     takes no test. Row max and sum use the quad's shuffles; O is
//     rescaled only when a row's max moved and normalised once at the end.
//     Nothing of S, P or O goes through shared memory.
//   - numerics: the softmax runs in the natural-log domain, P = exp(S scale
//     - m) on __expf, and lse = m + log l is the lse from which #5 / #6
//     recompute P (K2's exp2 with the scale folded in moves P's last bits;
//     in K3 / K4 that moved a dS rounding past the check; here it measured
//     only 3% faster, so it was not taken). P rounds once to bf16 before P
//     V, as the JAX kernel rounds it, and not as K2's bf16 pair hi + lo:
//     O's worst element against the plain f32 forward is 0.29-0.73 of the
//     check's limit over both kernel_tree forests and the walk tries at HD
//     64 and 128 (a chain, whose row 0 has one key, 0.38 / 0.46; branches
//     straddling tile edges 0.37 / 0.42), under the 0.8 that would call for
//     the pair, which measured 0.27-0.39 and 14% slower.
//   - resources (sm_90a, nvcc 12.8, measured on an H100;
//     tree_attention_fwd_occupancy reports them, chip_smoke.py prints
//     them): HD = 128 168 registers a thread (__launch_bounds__ for 3
//     blocks an SM, K2's budget; 72 bytes spilled), HD = 64 128 registers
//     (16 bytes spilled, 4 blocks); #5's shared memory, 70,788 B at HD =
//     128 and N = 2,048 (38,020 B at HD = 64). At N = 2,048 and H = 12 the
//     384 blocks all fit the card's 396 slots at once.
// What holds it, measured (PERF.md): on a GRPO forest of N = 2,048 the math
// alone (K and V copies skipped) keeps 65% of its time and the copies alone
// (math skipped) 68%: per-block latency over walks of up to 10 pairs, the
// longest walk setting the kernel's end, as for #5. What it leaves for
// later: wgmma and TMA, splitting long walks (a second pass to merge them,
// no atomics).
//
// #5 / #6's design (K3 / K4's in flash_attention.cu, the tile products of
// flash_mma.cuh, with the ancestor bit in place of the segment-causal
// predicate; no atomics, so every call gives the same bits and a
// checkpointed recompute is exact):
//   - #5 (dQ), as K4: one block of 4 warps per (64-row query tile, head),
//     grid (H, nt) with the query tile reversed, so the longest walks
//     start first. Warp w owns rows 16w..16w+15 and keeps its Q and dO
//     fragments (ldmatrix once, from the ring's last stage), the lse and
//     delta of its rows and dQ (HD / 2 f32 a thread) in registers. For each
//     live key tile of a 2-stage cp.async ring: S = Q K^T and dP = dO V^T on
//     mma.sync m16n8k16, P = exp(S scale - lse) (0 off the mask), dS = P (dP
//     - delta) packed straight from the accumulator layout into bf16 A
//     fragments, and dQ += dS K with K read by ldmatrix.trans. The pair's
//     64 x 2 mask words ride in the ring stage with K and V, row-major: a
//     thread's two words of its row are one 8-byte read, a warp's 8 rows 64
//     consecutive bytes.
//   - #6 (dK, dV), as K3: one block of 4 warps per (64-row key tile, head),
//     grid (H, nt), key tile 0 first. Warp w owns key rows 16w..16w+15; the
//     block's K and V tiles stay in shared memory for the whole walk. The
//     live query tiles from kt up come through the ring with their dO, Q,
//     lse, delta and their 64 x 2 words for this key tile's columns. It
//     computes the transposes directly, S^T = K Q^T and dP^T = V dO^T, so
//     P^T and dS^T are already A fragments of dV += P^T dO and dK += dS^T Q,
//     with Q and dO read by ldmatrix.trans; dK is scaled once at the end.
//     The bit of (key row j, query column i) is bit j % 32 of word (i,
//     j / 32): a thread's two key rows share one word column (the warp's
//     16 rows lie in one 32-row half) and its 16 query columns are 8 pairs
//     of adjacent ones. So the stage keeps its words column-major, [word
//     column][query row]: each pair of a thread's columns is one 8-byte
//     read, and for each of the 8 reads the warp's four quads' threads
//     read 32 consecutive bytes the other quads share (a broadcast), free
//     of bank conflicts.
//   - the walk: each block first classifies the 64-tile pairs of its strip
//     (#4, #5: its query tile against key tiles 0..qt; #6: its key tile against
//     query tiles kt..nt-1) from the words alone (tree_tile_list: block_any
//     as a first filter, then OR and AND reductions over each pair's 128
//     words with redux.sync) and compacts the live ones, with a flag for
//     full pairs, into a list in shared memory, in walk order. The ring
//     walks that list only: dead pairs are never loaded; full pairs (every
//     bit set) load no words and run without a per-element test; in a
//     partial pair a warp none of whose 16 rows has a bit in it skips its
//     math. ops/tree_attention.py:tree_tile_classes is the plain twin.
//   - P and dS round once to bf16 before their products, where the plain
//     version rounds them, and P = __expf(S scale - lse) in that order of
//     operations (K3 / K4's finding: the exp2-folded scale moves dS
//     roundings). Padding rows have no bit, so they meet no pair and their
//     gradients are exact zeros.
//   - resources (sm_90a, nvcc 12.8, measured on an H100;
//     tree_attention_bwd_occupancy reports them, chip_smoke.py prints
//     them): HD = 128 255 registers a thread (__launch_bounds__ for 2
//     blocks an SM), 16 bytes spilled (#5) and 32 (#6); HD = 64 168
//     registers, 8 / 24 bytes spilled, 3 blocks an SM. Shared memory at
//     N = 2,048: #5 70,788 B (HD = 128) and 38,020 (64), #6 106,628 and
//     57,476.
// What holds them, measured (PERF.md): on a GRPO forest of N = 2,048 the
// math alone (copies skipped) keeps 78% of #5's time and 81% of #6's, the
// copies alone 74% and 58%: per-block latency over walks of up to 10 (#5)
// and 15 (#6) pairs; building the list costs ~5%. What they leave for
// later: wgmma and TMA, a persistent schedule over the live pairs (the
// longest walk sets the kernel's time), GQA inside the kernels (summing
// the repeated KV heads' dK / dV, a different function from the JAX VJP's
// per-head dK / dV).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int kSkip = 128;  // tile edge of block_any

// ---------------------------------------------------------------------------
// the walk over live 64-tile pairs (#4, #5, #6)
// ---------------------------------------------------------------------------

// A tile pair's class; a live-list entry is the walked tile's index, with
// kFullBit set where every bit of the pair is set.
constexpr int kDead = 0, kPartial = 1, kFullPair = 2;
constexpr int kFullBit = 1 << 30;

// Classify the 64-tile pairs of one block's strip from the words alone and
// write the live ones, in walk order, to list_s and their count to *n_s:
// #4 and #5 (kByRow) pair query tile `fixed` with key tiles begin .. end - 1, #6
// key tile `fixed` with query tiles begin .. end - 1. A pair is dead where
// block_any's enclosing 128 x 128 tile is 0 (no word read) or its 128
// words are all 0, and full where they are all ones. Warp w takes pairs w,
// w + 4, ...; each lane reads rows lane and lane + 32 of the pair (two
// words each), four pairs' reads in flight at once, and an OR and an AND
// reduction (redux.sync) classify the pair. Warp 0 then compacts the
// classes in place by ballot. The caller syncs before reading the list.
template <bool kByRow>
__device__ __forceinline__ void tree_tile_list(const unsigned* __restrict__ words, const int* __restrict__ block_any,
                                              int N, int fixed, int begin, int end, int* list_s, int* n_s, int warp,
                                              int lane) {
  constexpr int kU = 4;
  const int W = N / 32, nB = N / kSkip, n = end - begin;
  for (int i0 = warp; i0 < n; i0 += kU * kWarps) {
    uint2 a[kU], b[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kWarps, t = begin + i;
      const int pq = kByRow ? fixed : t, pk = kByRow ? t : fixed;
      a[u] = b[u] = make_uint2(0u, 0u);
      if (i < n && __ldg(block_any + (size_t)(pq * kT / kSkip) * nB + pk * kT / kSkip) != 0) {
        const unsigned* w = words + (size_t)(pq * kT + lane) * W + 2 * pk;
        const unsigned* w32 = w + (size_t)32 * W;
        a[u] = make_uint2(__ldg(w), __ldg(w + 1));
        b[u] = make_uint2(__ldg(w32), __ldg(w32 + 1));
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kWarps;
      if (i >= n) break;  // uniform in the warp
      const unsigned any = __reduce_or_sync(kFull, a[u].x | a[u].y | b[u].x | b[u].y);
      const unsigned all = __reduce_and_sync(kFull, a[u].x & a[u].y & b[u].x & b[u].y);
      if (lane == 0) list_s[i] = any == 0u ? kDead : all == kFull ? kFullPair : kPartial;
    }
  }
  __syncthreads();
  if (warp == 0) {  // entry i moves to a position <= i
    int count = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const int c = i < n ? list_s[i] : kDead;
      const unsigned live = __ballot_sync(kFull, c != kDead);  // every lane has read before any writes
      if (c != kDead)
        list_s[count + __popc(live & ((1u << lane) - 1u))] = (begin + i) | (c == kFullPair ? kFullBit : 0);
      count += __popc(live);
    }
    if (lane == 0) *n_s = count;
  }
}

// #5's shared memory, and #4's: the ring's stages x (K, V) tiles of 64
// rows of HD + kPad bf16 (Q and dO, or #4's Q alone, are staged once in the
// last stage's tiles before the walk), each stage's 64 x 2 mask words
// (row-major), then the live list [nt] and its length.
template <int HD>
struct DqCfg {
  static constexpr int stages = 2;
  static constexpr int min_blocks = HD == 128 ? 2 : 3;
  static constexpr int LDH = HD + kPad;
  static constexpr size_t tile = sizeof(bf16) * kT * LDH;
  static constexpr size_t words = 2 * stages * tile;
  static constexpr size_t list = words + sizeof(unsigned) * stages * 2 * kT;
  static size_t bytes(int nt) { return list + sizeof(int) * (nt + 1); }
};

// This thread's bits of a partial pair from a stage's row-major words: bit
// 16 r + 2 j + e is row 16 warp + gq + 8 r against column 8 j + 2 tq + e,
// which is bit 8 (j % 4) + 2 tq + e of the row's word j / 4.
__device__ __forceinline__ uint32_t row_pair_bits(const unsigned* words_s, int warp, int gq, int tq) {
  uint32_t bits = 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint2 wr = *reinterpret_cast<const uint2*>(words_s + 2 * (16 * warp + gq + 8 * r));
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bits |= (((j < 4 ? wr.x : wr.y) >> (8 * (j & 3) + 2 * tq)) & 3u) << (16 * r + 2 * j);
  }
  return bits;
}

// ---------------------------------------------------------------------------
// #4: forward
// ---------------------------------------------------------------------------

// #4 stages as #5 does, with K2's register budget (3 blocks an SM at
// HD = 128).
template <int HD>
struct FwdCfg : DqCfg<HD> {
  static constexpr int min_blocks = HD == 128 ? 3 : 4;
};

// One live pair of #4 for this warp: S = Q K^T, -inf off the mask where
// kMasked (bit 16 r + 2 j + e of `bits`: this thread's row r against column
// 8 j + 2 tq + e), the online softmax of its rows (m: the running max of S
// scale; l: this thread's share of the running sum), O rescaled where a
// row's max moved, then O += P V with P rounded once to bf16 straight into
// A fragments.
template <int HD, bool kMasked>
__device__ __forceinline__ void fwd_pair(float (&oacc)[HD / 8][4], float (&m)[2], float (&l)[2],
                                         const uint32_t (&qa)[HD / 16][4], const bf16* k_t, const bf16* v_t,
                                         uint32_t bits, float scale, int lane) {
  float s[8][4];
  mma_abt<HD>(s, qa, nullptr, k_t, lane);  // S = Q K^T
  if (kMasked) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (!((bits >> (16 * r + 2 * j + e)) & 1u)) s[j][2 * r + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], fmaxf(s[j][2 * r], s[j][2 * r + 1]));
  float alpha[2], msub[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale);
    alpha[r] = m_new == -INFINITY ? 1.f : __expf(m[r] - m_new);  // 0 while the row had no bit
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
        const float p = __expf(s[j][2 * r + e] * scale - msub[r]);  // masked: exp(-inf) = 0
        psum[r] += p;
        s[j][2 * r + e] = p;
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
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // O += P V, keys 16 kk .. 16 kk + 15
    uint32_t pa[4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int r = 0; r < 2; ++r) pa[2 * hh + r] = pack_bf16(s[2 * kk + hh][2 * r], s[2 * kk + hh][2 * r + 1]);
    mma_ab<HD>(oacc, pa, v_t, kk, lane);
  }
}

// #4: O = softmax(S scale) V over the live key tiles of one query tile, and
// lse = m + log l in the natural-log domain.
template <int HD>
__global__ void __launch_bounds__(kThreads, FwdCfg<HD>::min_blocks) tree_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const unsigned* __restrict__ words, const int* __restrict__ block_any, bf16* __restrict__ o,
    float* __restrict__ lse, int N, int H, float scale) {
  typedef FwdCfg<HD> CF;
  constexpr int LDH = CF::LDH, kStages = CF::stages;
  extern __shared__ __align__(128) unsigned char smem[];

  const int nt = N / kT, W = N / 32;
  const int h = blockIdx.x, qt = nt - 1 - static_cast<int>(blockIdx.y);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t rs = (size_t)H * HD, head0 = (size_t)h * HD;
  const int q0 = qt * kT;
  int* list_s = reinterpret_cast<int*>(smem + CF::list);
  auto kv_tile = [&](int st, int kv) -> bf16* { return reinterpret_cast<bf16*>(smem + (2 * st + kv) * CF::tile); };
  auto words_of = [&](int st) -> unsigned* { return reinterpret_cast<unsigned*>(smem + CF::words) + st * 2 * kT; };
  auto issue = [&](int e, int st) {  // entry e's K and V tiles (and words, if partial) -> ring stage st
    const int kt = e & ~kFullBit;
    copy_rows<HD>(kv_tile(st, 0), k, head0, rs, kt * kT, N, tid);
    copy_rows<HD>(kv_tile(st, 1), v, head0, rs, kt * kT, N, tid);
    if (!(e & kFullBit))  // thread t: word t % 2 of row t / 2
      cp_async4(words_of(st) + tid, words + (size_t)(q0 + tid / 2) * W + 2 * kt + (tid & 1), true);
  };

  // Q, in flight while the strip is classified
  copy_rows<HD>(kv_tile(kStages - 1, 0), q, head0, rs, q0, N, tid);
  cp_async_commit();
  tree_tile_list<true>(words, block_any, N, qt, 0, qt + 1, list_s, list_s + nt, warp, lane);
  __syncthreads();
  const int n_live = list_s[nt];

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {  // the ring: entries 0 .. kStages - 2 in flight
    if (i < n_live) issue(list_s[i], i);
    cp_async_commit();
  }

  // Q's fragments stay in registers
  uint32_t qa[HD / 16][4];
  cp_async_wait<kStages - 1>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qa[kk], kv_tile(kStages - 1, 0) + (16 * warp + (lane & 15)) * LDH + 16 * kk + (lane >> 4) * 8);
  // (the walk's first barrier frees the stage before it is written)

  float oacc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int p = 0; p < n_live; ++p) {
    const int st = p % kStages;
    cp_async_wait<kStages - 2>();  // entry p landed (this thread's copies)
    __syncthreads();               // every thread's; and the stage written next is free
    if (p + kStages - 1 < n_live) issue(list_s[p + kStages - 1], (p + kStages - 1) % kStages);
    cp_async_commit();
    const int e = list_s[p];
    const bf16* k_t = kv_tile(st, 0);
    const bf16* v_t = kv_tile(st, 1);
    if (e & kFullBit) {
      fwd_pair<HD, false>(oacc, m, l, qa, k_t, v_t, 0u, scale, lane);
    } else {
      const uint32_t bits = row_pair_bits(words_of(st), warp, gq, tq);
      if (__any_sync(kFull, bits != 0u))  // some row of the warp has a bit in the pair
        fwd_pair<HD, true>(oacc, m, l, qa, k_t, v_t, bits, scale, lane);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + gq + 8 * r;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // padding rows: exact zeros
    bf16* orow = o + head0 + (size_t)row * rs;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * tq) =
          __floats2bfloat162_rn(oacc[n][2 * r] * inv, oacc[n][2 * r + 1] * inv);
    if (lse != nullptr && tq == 0) lse[(size_t)row * H + h] = l[r] > 0.f ? m[r] + logf(l[r]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// #5 / #6: backward
// ---------------------------------------------------------------------------

// One live pair of #5 for this warp: S = Q K^T and dP = dO V^T, P =
// exp(S scale - lse), 0 off the mask where kMasked (bit 16 r + 2 j + e of
// `bits`: this thread's row r against column 8 j + 2 tq + e), dS = P (dP -
// delta) rounded once to bf16 straight into A fragments, dQ += dS K.
template <int HD, bool kMasked>
__device__ __forceinline__ void dq_pair(float (&acc)[HD / 8][4], const uint32_t (&qa)[HD / 16][4],
                                        const uint32_t (&da)[HD / 16][4], const bf16* k_t, const bf16* v_t,
                                        const float (&lser)[2], const float (&der)[2], uint32_t bits, float scale,
                                        int lane) {
  float s[8][4], dp[8][4];
  mma_abt<HD>(s, qa, nullptr, k_t, lane);   // S = Q K^T
  mma_abt<HD>(dp, da, nullptr, v_t, lane);  // dP = dO V^T
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
          if (kMasked && !((bits >> (16 * r + 2 * j + e)) & 1u)) p = 0.f;
          d[e] = p * (dp[j][2 * r + e] - der[r]);
        }
        dsa[2 * hh + r] = pack_bf16(d[0], d[1]);
      }
    mma_ab<HD>(acc, dsa, k_t, kk, lane);  // dQ += dS K
  }
}

// #5: dQ = scale dS K over the live key tiles of one query tile.
template <int HD>
__global__ void __launch_bounds__(kThreads, DqCfg<HD>::min_blocks) tree_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const unsigned* __restrict__ words, const int* __restrict__ block_any,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int N, int H, float scale) {
  typedef DqCfg<HD> CF;
  constexpr int LDH = CF::LDH, kStages = CF::stages;
  extern __shared__ __align__(128) unsigned char smem[];

  const int nt = N / kT, W = N / 32;
  const int h = blockIdx.x, qt = nt - 1 - static_cast<int>(blockIdx.y);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t rs = (size_t)H * HD, head0 = (size_t)h * HD;
  const int q0 = qt * kT;
  int* list_s = reinterpret_cast<int*>(smem + CF::list);
  auto kv_tile = [&](int st, int kv) -> bf16* { return reinterpret_cast<bf16*>(smem + (2 * st + kv) * CF::tile); };
  auto words_of = [&](int st) -> unsigned* { return reinterpret_cast<unsigned*>(smem + CF::words) + st * 2 * kT; };
  auto issue = [&](int e, int st) {  // entry e's K and V tiles (and words, if partial) -> ring stage st
    const int kt = e & ~kFullBit;
    copy_rows<HD>(kv_tile(st, 0), k, head0, rs, kt * kT, N, tid);
    copy_rows<HD>(kv_tile(st, 1), v, head0, rs, kt * kT, N, tid);
    if (!(e & kFullBit))  // thread t: word t % 2 of row t / 2
      cp_async4(words_of(st) + tid, words + (size_t)(q0 + tid / 2) * W + 2 * kt + (tid & 1), true);
  };

  // Q and dO, in flight while the strip is classified
  copy_rows<HD>(kv_tile(kStages - 1, 0), q, head0, rs, q0, N, tid);
  copy_rows<HD>(kv_tile(kStages - 1, 1), dout, head0, rs, q0, N, tid);
  cp_async_commit();
  int qrow[2];  // this thread's rows gq and gq + 8 of its warp, their lse and delta
  float lser[2], der[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + 16 * warp + gq + 8 * r;
    const size_t idx = (size_t)qrow[r] * H + h;
    lser[r] = __ldg(lse + idx);
    der[r] = __ldg(delta + idx);
  }
  tree_tile_list<true>(words, block_any, N, qt, 0, qt + 1, list_s, list_s + nt, warp, lane);
  __syncthreads();
  const int n_live = list_s[nt];

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {  // the ring: entries 0 .. kStages - 2 in flight
    if (i < n_live) issue(list_s[i], i);
    cp_async_commit();
  }

  // Q and dO fragments stay in registers
  uint32_t qa[HD / 16][4], da[HD / 16][4];
  cp_async_wait<kStages - 1>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (16 * warp + (lane & 15)) * LDH + 16 * kk + (lane >> 4) * 8;
    ldsm_x4(qa[kk], kv_tile(kStages - 1, 0) + off);
    ldsm_x4(da[kk], kv_tile(kStages - 1, 1) + off);
  }
  // (the walk's first barrier frees the stage before it is written)

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int p = 0; p < n_live; ++p) {
    const int st = p % kStages;
    cp_async_wait<kStages - 2>();  // entry p landed (this thread's copies)
    __syncthreads();               // every thread's; and the stage written next is free
    if (p + kStages - 1 < n_live) issue(list_s[p + kStages - 1], (p + kStages - 1) % kStages);
    cp_async_commit();
    const int e = list_s[p];
    const bf16* k_t = kv_tile(st, 0);
    const bf16* v_t = kv_tile(st, 1);
    if (e & kFullBit) {
      dq_pair<HD, false>(acc, qa, da, k_t, v_t, lser, der, 0u, scale, lane);
    } else {
      const uint32_t bits = row_pair_bits(words_of(st), warp, gq, tq);
      if (__any_sync(kFull, bits != 0u))  // some row of the warp has a bit in the pair
        dq_pair<HD, true>(acc, qa, da, k_t, v_t, lser, der, bits, scale, lane);
    }
  }
  cp_async_wait<0>();
  store_rows<HD>(dq, acc, qrow, head0, rs, N, scale, tq);  // padding rows: exact zeros
}

// #6's shared memory: the block's K and V tiles, the ring's stages x (Q,
// dO) tiles of 64 rows of HD + kPad bf16, each stage's lse [64], delta [64]
// and 2 x 64 mask words (column-major, [word column][query row]), then the
// live list [nt] and its length.
template <int HD>
struct DkvCfg {
  static constexpr int stages = 2;
  static constexpr int min_blocks = HD == 128 ? 2 : 3;
  static constexpr int LDH = HD + kPad;
  static constexpr size_t tile = sizeof(bf16) * kT * LDH;
  static constexpr size_t rows = 4 * sizeof(float) * kT;  // lse, delta and the words of one stage
  static constexpr size_t ring = 2 * tile;                 // after the K and V tiles
  static constexpr size_t row_stats = ring + 2 * stages * tile;
  static constexpr size_t list = row_stats + stages * rows;
  static size_t bytes(int nt) { return list + sizeof(int) * (nt + 1); }
};

// One live pair of #6 for this warp: S^T = K Q^T, P^T = exp(S^T scale -
// lse) with lse per column, 0 off the mask where kMasked (bit 16 r + 2 j +
// e of `bits`: this thread's key row r against query column 8 j + 2 tq +
// e), dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q with dS^T = P^T
// (dP^T - delta), both rounded once to bf16 straight into A fragments.
template <int HD, bool kMasked>
__device__ __forceinline__ void dkv_pair(float (&dka)[HD / 8][4], float (&dva)[HD / 8][4], const bf16* k_w,
                                         const bf16* v_w, const bf16* q_t, const bf16* d_t,
                                         const float* __restrict__ lse_t, const float* __restrict__ de_t,
                                         uint32_t bits, float scale, int lane, int tq) {
  float s[8][4], dp[8][4];
  mma_abt<HD>(s, nullptr, k_w, q_t, lane);  // S^T = K Q^T
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float lc = lse_t[8 * j + 2 * tq + e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p = __expf(s[j][2 * r + e] * scale - lc);
        s[j][2 * r + e] = !kMasked || (bits >> (16 * r + 2 * j + e)) & 1u ? p : 0.f;
      }
    }
  mma_abt<HD>(dp, nullptr, v_w, d_t, lane);  // dP^T = V dO^T
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
        dsa[2 * hh + r] = pack_bf16(p0 * (dp[j][2 * r] - de_t[c]), p1 * (dp[j][2 * r + 1] - de_t[c + 1]));
      }
    mma_ab<HD>(dva, pa, d_t, kk, lane);  // dV += P^T dO
    mma_ab<HD>(dka, dsa, q_t, kk, lane);  // dK += dS^T Q
  }
}

// #6: dV = P^T dO and dK = scale dS^T Q over the live query tiles of one
// key tile.
template <int HD>
__global__ void __launch_bounds__(kThreads, DkvCfg<HD>::min_blocks) tree_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const unsigned* __restrict__ words, const int* __restrict__ block_any,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int H, float scale) {
  typedef DkvCfg<HD> CB;
  constexpr int LDH = CB::LDH, kStages = CB::stages;
  extern __shared__ __align__(128) unsigned char smem[];

  const int nt = N / kT, W = N / 32;
  const int h = blockIdx.x, kt = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t rs = (size_t)H * HD, head0 = (size_t)h * HD;
  const int k0 = kt * kT;
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = reinterpret_cast<bf16*>(smem + CB::tile);
  int* list_s = reinterpret_cast<int*>(smem + CB::list);
  auto qd_tile = [&](int st, int which) -> bf16* {  // which 0: Q, 1: dO
    return reinterpret_cast<bf16*>(smem + CB::ring + (2 * st + which) * CB::tile);
  };
  auto rows_of = [&](int st) -> float* { return reinterpret_cast<float*>(smem + CB::row_stats + st * CB::rows); };
  auto issue = [&](int e, int st) {  // entry e's Q, dO, lse, delta (and words, if partial) -> ring stage st
    const int q0 = (e & ~kFullBit) * kT, r = tid % kT;
    copy_rows<HD>(qd_tile(st, 0), q, head0, rs, q0, N, tid);
    copy_rows<HD>(qd_tile(st, 1), dout, head0, rs, q0, N, tid);
    float* rw = rows_of(st);
    const size_t idx = (size_t)(q0 + r) * H + h;
    cp_async4(rw + tid, (tid < kT ? lse : delta) + idx, true);  // lse [64] then delta [64]
    if (!(e & kFullBit))  // thread t: word column t / 64 of query row t % 64, at [t / 64][t % 64]
      cp_async4(rw + 2 * kT + tid, words + (size_t)(q0 + r) * W + 2 * kt + tid / kT, true);
  };

  // this block's K and V tiles, kept for the whole walk, in flight while
  // the strip is classified
  copy_rows<HD>(k_s, k, head0, rs, k0, N, tid);
  copy_rows<HD>(v_s, v, head0, rs, k0, N, tid);
  cp_async_commit();
  int krow[2];  // this thread's key rows gq and gq + 8 of its warp
#pragma unroll
  for (int r = 0; r < 2; ++r) krow[r] = k0 + 16 * warp + gq + 8 * r;
  tree_tile_list<false>(words, block_any, N, kt, kt, nt, list_s, list_s + nt, warp, lane);
  __syncthreads();
  const int n_live = list_s[nt];

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {  // the ring: entries 0 .. kStages - 2 in flight
    if (i < n_live) issue(list_s[i], i);
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
  // the warp's key rows lie in word column warp / 2; row r is bit b0 + 8 r
  const int b0 = 16 * (warp & 1) + gq;

  for (int p = 0; p < n_live; ++p) {
    const int st = p % kStages;
    cp_async_wait<kStages - 2>();  // entry p (and, the first time, K and V) landed
    __syncthreads();
    if (p + kStages - 1 < n_live) issue(list_s[p + kStages - 1], (p + kStages - 1) % kStages);
    cp_async_commit();
    const int e = list_s[p];
    const bf16* q_t = qd_tile(st, 0);
    const bf16* d_t = qd_tile(st, 1);
    const float* rw = rows_of(st);
    if (e & kFullBit) {
      dkv_pair<HD, false>(dka, dva, k_w, v_w, q_t, d_t, rw, rw + kT, 0u, scale, lane, tq);
    } else {
      // query columns 8 j + 2 tq and + 1: one 8-byte read of the word column
      const unsigned* wcol = reinterpret_cast<const unsigned*>(rw + 2 * kT) + (warp >> 1) * kT;
      uint32_t bits = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint2 wv = *reinterpret_cast<const uint2*>(wcol + 8 * j + 2 * tq);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          bits |= ((wv.x >> (b0 + 8 * r)) & 1u) << (16 * r + 2 * j) |
                  ((wv.y >> (b0 + 8 * r)) & 1u) << (16 * r + 2 * j + 1);
      }
      if (__any_sync(kFull, bits != 0u))  // some key row of the warp has a bit in the pair
        dkv_pair<HD, true>(dka, dva, k_w, v_w, q_t, d_t, rw, rw + kT, bits, scale, lane, tq);
    }
  }
  cp_async_wait<0>();
  store_rows<HD>(dk, dka, krow, head0, rs, N, scale, tq);  // padding rows: exact zeros
  store_rows<HD>(dv, dva, krow, head0, rs, N, 1.f, tq);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

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
  const size_t bytes = FwdCfg<HD>::bytes(N / kT);
  int rc = set_smem(tree_fwd_kernel<HD>, bytes);
  if (rc != 0) return rc;
  dim3 grid(H, N / kT);  // the query tile reversed: the longest walks first
  tree_fwd_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned*>(words), static_cast<const int*>(block_any),
      static_cast<bf16*>(o), static_cast<float*>(lse), N, H, softmax_scale(HD));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* words,
               const void* block_any, const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int N, int H, cudaStream_t stream) {
  const int nt = N / kT;
  const size_t bytes = DkvCfg<HD>::bytes(nt);
  int rc = set_smem(tree_bwd_dkv_kernel<HD>, bytes);
  if (rc != 0) return rc;
  dim3 grid(H, nt);  // key tile 0, seen by the most query tiles, first
  tree_bwd_dkv_kernel<HD><<<grid, kThreads, bytes, stream>>>(
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
  const int nt = N / kT;
  const size_t bytes = DqCfg<HD>::bytes(nt);
  int rc = set_smem(tree_bwd_dq_kernel<HD>, bytes);
  if (rc != 0) return rc;
  dim3 grid(H, nt);  // the query tile reversed: the longest walks first
  tree_bwd_dq_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned*>(words), static_cast<const int*>(block_any),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), N, H, softmax_scale(HD));
  return static_cast<int>(cudaGetLastError());
}

// a kernel's registers a thread, dynamic shared memory, blocks an SM and
// local (spill) bytes a thread -> info[0..3]
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
  info[3] = static_cast<int>(attr.localSizeBytes);
  return rc;
}

template <int HD>
int bwd_occupancy(int N, int* info) {
  const int nt = N / kT;
  const int rc = occupancy_of(tree_bwd_dkv_kernel<HD>, DkvCfg<HD>::bytes(nt), info);
  return rc != 0 ? rc : occupancy_of(tree_bwd_dq_kernel<HD>, DqCfg<HD>::bytes(nt), info + 4);
}

template <int HD>
int fwd_occupancy(int N, int* info) {
  return occupancy_of(tree_fwd_kernel<HD>, FwdCfg<HD>::bytes(N / kT), info);
}

// the grids hold the tile count in y
bool shape_ok(int N, int H) { return N > 0 && N % kSkip == 0 && N / kT <= 65535 && H > 0 && H <= 65535; }

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

// #6's (info[0..3]) and #5's (info[4..7]) registers a thread, dynamic shared
// memory bytes, blocks an SM and local (spill) bytes a thread for N nodes.
extern "C" int tree_attention_bwd_occupancy(int hd, int N, int* info) {
  if (!shape_ok(N, 1)) return -1;
  switch (hd) {
    case 64: return bwd_occupancy<64>(N, info);
    case 128: return bwd_occupancy<128>(N, info);
    default: return -1;
  }
}

// #4's registers a thread, dynamic shared memory bytes, blocks an SM and
// local (spill) bytes a thread (info[0..3]) for N nodes.
extern "C" int tree_attention_fwd_occupancy(int hd, int N, int* info) {
  if (!shape_ok(N, 1)) return -1;
  switch (hd) {
    case 64: return fwd_occupancy<64>(N, info);
    case 128: return fwd_occupancy<128>(N, info);
    default: return -1;
  }
}
