// Paged suffix attention for Hopper (sm_90a), called through ctypes.
//
// Replaces the TPU kernel areal_tpu/ops/paged_suffix_attention.py:
// paged_suffix_attention (bodies _suffix_kernel / _suffix_kernel_noscale).
// The function: for each slot s, B suffix query rows (q [S, B, H, HD]) attend
// (a) the slot's first prefix_lens[s] cached tokens, read through its page
// table from layer `layer` of the stacked cache [L, KH, N, psz, HD], and
// (b) the B in-flight suffix keys (k/v_suffix [S, B, KH, HD]) under
// suffix_mask [S, B, B] (row attends column). A row attends the prefix only
// when its mask diagonal bit is set; a row with no valid bit outputs exact
// zeros. One kernel serves both launches of the engine: a causal chain mask
// (warm suffix prefill after a radix hit) and a draft tree's ancestor mask
// (speculative verify). Query heads are grouped by KV head, row order
// i * G + g inside a (slot, KV head) cell, as on the TPU. int8 and
// fp8-e4m3 pages carry one f32 scale per token vector and dequantize as
// x * scale / 127.5.
//
// What bounds it: the regime decides. Verify (B = 5 or 9 rows, S = 32
// slots, prefixes of up to a few thousand tokens) reads every prefix byte
// for ~4 * B * G flops per KV element: bytes-bound, like decode. A warm
// prefill (8 rows x 256 suffix tokens over a 1,024-token prefix) does
// ~4 * 256 * G flops per KV element: bound by the tensor cores.
//
// The design (FlashAttention-2 on mma.sync, flash-decoding splits):
//   - suffix_kernel: one block of 4 warps per (tile of 64 query rows,
//     prefix split, KV head, slot); warp w owns rows 16w..16w+15 and keeps
//     its Q fragments, S (32 f32 a thread), P (bf16 A fragments packed
//     straight from S's accumulator layout) and O (HD / 2 f32 a thread) in
//     registers. Both products are mma.sync m16n8k16 bf16 -> f32 fed by
//     ldmatrix (.trans for V); row max and sum use the quad's shuffles; the
//     softmax scale is folded into exp2's argument, and O is rescaled only
//     when a row's max moved. Nothing of S, P or O goes through shared
//     memory.
//   - a cp.async ring of 64-token K/V tiles, one barrier a tile: the next
//     stages - 1 tiles are in flight while one computes. An aligned prefix
//     tile (psz a multiple of 64) is one contiguous copy whose page index
//     was read one issue ahead (the first before the prefix length is
//     known); otherwise each token row looks its page up. Rows past the
//     prefix are zero-filled by the copy. Suffix tiles use the same ring;
//     a suffix tile no row of the block attends is never loaded, and the
//     first one's mask bits are read with the block's other set-up reads.
//     Rows are padded by 16 bytes: ldmatrix is free of bank conflicts.
//   - int8 / fp8 pages: the ring stages the raw bytes and the f32 scales;
//     one pass in shared memory converts the landed tile to bf16 exactly
//     (7-bit integers, 3-bit mantissas). The K scale multiplies S's columns
//     and the V scale P before P rounds to bf16, in f32, so the products
//     see the stored values.
//   - two configurations (Cfg), measured on an H100: verify (a (slot, KV
//     head) cell of < 128 rows) a 3-stage ring, 2 blocks an SM; prefill
//     (>= 128 rows) a 2-stage ring, 3 blocks an SM at 168 registers.
//   - split-KV over the prefix: split p of P covers a fixed range of the
//     window's 64-token tiles (from wp * psz, never from prefix_lens, which
//     lives on the device); split 0 also takes the suffix. With P > 1 each
//     split writes its O normalised by its own row sum, and its log-sum-exp
//     (-inf for a row it saw no valid key of), to scratch; merge_kernel
//     (split_merge.cuh) combines the splits in a fixed order, without
//     atomics, and writes bf16 (a row every split saw empty gets exact
//     zeros). P = 1 writes bf16 directly. merge_kernel knows rows, not
//     masks: (slot, KV head, i * G + g) -> out[slot, i, head], so decode
//     (#1, paged_attention.cu, B = 1) shares it, and the fragment helpers
//     of flash_mma.cuh.
//   - the wrapper picks P from shapes alone: 1 at warm prefill, 5 at
//     verify with G = 6, 3 / 2 with G = 8 (S = 32, a 2,048-token window).
// Resources (sm_90a, nvcc 12.8, HD = 128, measured on an H100): prefill
// 168 registers (88 bytes of stack spilled), 69,632 B of shared memory, 3
// blocks an SM; verify 248 registers, 104,448 B, 2 blocks; int8 / fp8 243
// registers, 105,472 B, 2 blocks.
// `paged_suffix_attention_occupancy` reports them; chip_smoke.py prints
// them.
// What bounds it now, measured (PERF.md): a warm prefill is held by the
// L2 -> shared memory traffic of prefix tiles that every 64-row tile of a
// cell reads again, and by latency with 12 warps an SM; larger row tiles
// (128 rows in one block) measured slower, for want of warps. What it
// leaves for later: wgmma and TMA multicast of a prefix tile to a cluster
// of row tiles, a persistent schedule, and a 16- or 32-row tile for verify
// (at B * G = 30 the block's last two warps hold no rows and skip the math).
//
// q must be bf16; the suffix K/V bf16; pages bf16, int8 or fp8.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "split_merge.cuh"

namespace {

// The block's configuration, by regime. kPrefill: a (slot, KV head) cell
// of at least 128 rows (a warm prefill) wants more blocks an SM (3 at 168
// registers, with a few spilled); verify (fewer rows, bytes-bound) a
// deeper ring. Shared memory: the ring's stages
// x (K, V) tiles of 64 keys, each sized for bf16 rows of HD + kPad (a
// prefix tile of int8 / fp8 pages uses the first 64 * HD bytes, dense);
// for int8 / fp8 pages also the converted bf16 K and V of the current tile
// and the ring's f32 scales [stages][K, V][64]. The query tile is staged in
// the ring's last stage before the loop. At HD = 128: bf16 prefill 2
// stages, 68 KB, 3 blocks an SM; bf16 verify 3 stages, 102 KB, 2 blocks;
// int8 / fp8 2 stages + the converted tile, 103 KB, 2 blocks.
template <int HD, typename TKV, bool kPrefill>
struct Cfg {
  static constexpr bool quant = IsQuant<TKV>::value;
  static constexpr int stages = quant || kPrefill ? 2 : 3;
  static constexpr int min_blocks = !quant && kPrefill ? 3 : 2;
  static constexpr int LDH = HD + kPad;
  static constexpr size_t tile = sizeof(bf16) * kT * LDH;
  static constexpr size_t ring = 0;
  static constexpr size_t cvt = ring + 2 * stages * tile;
  static constexpr size_t scales = cvt + (quant ? 2 * tile : 0);
  static constexpr size_t bytes = scales + (quant ? sizeof(float) * 2 * stages * kT : 0);
};

// Column-validity bits of one row for the suffix keys j0 .. j0 + 63 this
// thread holds (bit 2 j + e: key j0 + 8 j + 2 tq + e).
__device__ __forceinline__ uint32_t suffix_row_bits(const uint8_t* mrow, int j0, int B, int tq) {
  uint32_t b = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = j0 + 8 * j + 2 * tq + e;
      if (c < B && mrow[c]) b |= 1u << (2 * j + e);
    }
  return b;
}

// The copies of one tile whose rows each look their page up (psz not a
// multiple of 64): rows past `limit` are zero-filled, not read.
template <int HD, typename TKV>
__device__ __noinline__ void issue_rows(unsigned char* kd, unsigned char* vd, float* ksd, float* vsd,
                                        const TKV* k_pages, const TKV* v_pages, const float* k_scales,
                                        const float* v_scales, const int* pt, size_t plane, int psz, int t0,
                                        int limit, int tid, int dst_stride) {
  constexpr int kRowBytes = HD * static_cast<int>(sizeof(TKV));
  constexpr int kRowChunks = kRowBytes / 16;
  for (int c = tid; c < kT * kRowChunks; c += kThreads) {
    const int rr = c / kRowChunks, ch = c % kRowChunks, t = t0 + rr;
    const bool ok = t < limit;
    const size_t row = ok ? (plane + __ldg(pt + t / psz)) * psz + t % psz : 0;
    const size_t src = row * kRowBytes + ch * 16;
    cp_async16(kd + rr * dst_stride + ch * 16, reinterpret_cast<const unsigned char*>(k_pages) + src, ok);
    cp_async16(vd + rr * dst_stride + ch * 16, reinterpret_cast<const unsigned char*>(v_pages) + src, ok);
  }
  if (ksd != nullptr) {  // one scale a thread: K for threads 0..63, V for 64..127
    const int kv = tid / kT, rr = tid % kT, t = t0 + rr;
    const bool ok = t < limit;
    const size_t row = ok ? (plane + __ldg(pt + t / psz)) * psz + t % psz : 0;
    cp_async4((kv ? vsd : ksd) + rr, (kv ? v_scales : k_scales) + row, ok);
  }
}

// The copies of one tile of the in-flight suffix K/V (bf16 rows j0 ..).
template <int HD>
__device__ __noinline__ void issue_suffix(unsigned char* kd, unsigned char* vd, const bf16* k_sfx,
                                          const bf16* v_sfx, int s, int B, int KH, int kh, int j0, int tid) {
  constexpr int kChunks = HD / 8;
  for (int c = tid; c < kT * kChunks; c += kThreads) {
    const int rr = c / kChunks, ch = c % kChunks, j = j0 + rr;
    const bool ok = j < B;
    const size_t row = ok ? ((size_t)s * B + j) * KH + kh : 0;
    const int dst = rr * (HD + kPad) * 2 + ch * 16;
    cp_async16(kd + dst, k_sfx + row * HD + ch * 8, ok);
    cp_async16(vd + dst, v_sfx + row * HD + ch * 8, ok);
  }
}

template <int HD, typename TKV, bool kPrefill>
__global__ void __launch_bounds__(kThreads, (Cfg<HD, TKV, kPrefill>::min_blocks)) suffix_kernel(
    const bf16* __restrict__ q,          // [S, B, H, HD]
    const bf16* __restrict__ k_sfx,      // [S, B, KH, HD]
    const bf16* __restrict__ v_sfx,
    const TKV* __restrict__ k_pages,     // [L, KH, N, psz, HD]
    const TKV* __restrict__ v_pages,
    const float* __restrict__ k_scales,  // [L, KH, N, psz] or null
    const float* __restrict__ v_scales,
    const int* __restrict__ prefix_lens, // [S]
    const int* __restrict__ page_table,  // [S, pt_stride], first wp columns used
    const uint8_t* __restrict__ mask,    // [S, B, B]
    bf16* __restrict__ out,              // [S, B, H, HD] (n_splits == 1)
    float* __restrict__ o_part,          // [P, S, KH, B * G, HD] (n_splits > 1)
    float* __restrict__ lse_part,        // [P, S, KH, B * G]
    int S, int B, int H, int KH, int N, int psz, int wp, int pt_stride, int layer, int n_splits,
    float scale_log2) {
  typedef Cfg<HD, TKV, kPrefill> CF;
  constexpr int LDH = CF::LDH;
  constexpr bool kQuant = CF::quant;
  constexpr int kStages = CF::stages;
  constexpr int kRowBytes = HD * static_cast<int>(sizeof(TKV));  // one page row
  constexpr int kRowChunks = kRowBytes / 16;
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a bf16 row
  extern __shared__ __align__(128) unsigned char smem[];

  const int G = H / KH, BG = B * G;
  const int n_rt = (BG + kT - 1) / kT;
  const int rt = blockIdx.x % n_rt, split = blockIdx.x / n_rt;
  const int kh = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row group, thread of the quad
  const int row0 = rt * kT + 16 * warp;  // the warp's first row in the (slot, KV head) cell

  // the query tile's rows (rows past B * G are zeros), read into registers
  // first so that their latency overlaps the block's other set-up reads
  static_assert(kT * kChunks % kThreads == 0 && kT * kRowChunks % kThreads == 0, "whole chunks a thread");
  static_assert(kThreads == 2 * kT, "one int8 / fp8 scale a thread");
  uint4 qv[kT * kChunks / kThreads];
#pragma unroll
  for (int i = 0; i < kT * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads, rr = c / kChunks, col = (c % kChunks) * 8;
    const int rh = rt * kT + rr;
    qv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (rh < BG) {
      const int qi = rh / G, g = rh % G;
      qv[i] = *reinterpret_cast<const uint4*>(q + (((size_t)s * B + qi) * H + (size_t)kh * G + g) * HD + col);
    }
  }

  // this thread's rows gq and gq + 8 of its warp: suffix row i (or -1),
  // and whether the row attends the prefix (its diagonal bit)
  int irow[2];
  bool rvalid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rho = row0 + gq + 8 * r;
    irow[r] = rho < BG ? rho / G : -1;
    rvalid[r] = irow[r] >= 0 && mask[((size_t)s * B + irow[r]) * B + irow[r]] != 0;
  }
  const bool warp_live = row0 < BG;
  // the first suffix tile's column bits (see tile_bits), read early as well
  uint32_t sfx0 = 0u;
  if (split == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (irow[r] >= 0) sfx0 |= suffix_row_bits(mask + ((size_t)s * B + irow[r]) * B, 0, B, tq) << (16 * r);
  }

  // this split's prefix tiles, only when some row of the block attends it
  const int* pt = page_table + (size_t)s * pt_stride;
  const bool aligned = psz % kT == 0;
  const int win_tiles = (wp * psz + kT - 1) / kT;
  const int per = (win_tiles + n_splits - 1) / n_splits;
  const int pre_lo = split * per;
  const int page_lo = aligned && pre_lo < win_tiles ? __ldg(pt + pre_lo * kT / psz) : 0;
  int limit = min(prefix_lens[s], wp * psz);
  if (!__syncthreads_or(rvalid[0] || rvalid[1])) limit = 0;
  const int pre_hi = min(pre_lo + per, (max(limit, 0) + kT - 1) / kT);
  const bool has_sfx = split == 0;
  auto part_row = [&](int r) -> size_t {  // the scratch row of this thread's row r
    return (((size_t)split * S + s) * KH + kh) * BG + row0 + gq + 8 * r;
  };

  if (pre_lo >= pre_hi && !has_sfx) {  // nothing here: m = -inf, l = 0
    if (tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (irow[r] >= 0) lse_part[part_row(r)] = -INFINITY;
    }
    return;
  }

  const size_t plane = ((size_t)layer * KH + kh) * N;  // pages before this (layer, head)

  // Column-validity bits of a tile for this thread: bit 16 r + 2 j + e is
  // row r's column 8 j + 2 tq + e. Tiles below win_tiles are prefix tiles,
  // tile win_tiles + j the suffix keys 64 j ...
  auto tile_bits = [&](int tile) -> uint32_t {
    if (tile == win_tiles) return sfx0;
    uint32_t bits = 0u;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (tile < win_tiles) {
        if (!rvalid[r]) continue;
        const int n = limit - tile * kT;
        uint32_t b = 0xffffu;
        if (n < kT) {
          b = 0u;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            b |= (8 * j + 2 * tq < n ? 1u : 0u) << (2 * j) | (8 * j + 2 * tq + 1 < n ? 2u : 0u) << (2 * j);
        }
        bits |= b << (16 * r);
      } else if (irow[r] >= 0) {
        bits |= suffix_row_bits(mask + ((size_t)s * B + irow[r]) * B, (tile - win_tiles) * kT, B, tq) << (16 * r);
      }
    }
    return bits;
  };
  // the first suffix tile at or after j that some row of the block attends
  // (block-uniform; a barrier per tile looked at), or -1
  auto next_suffix = [&](int j, uint32_t& bits) -> int {
    if (!has_sfx) return -1;
    for (; j * kT < B; ++j) {
      bits = tile_bits(win_tiles + j);
      if (__syncthreads_or(bits != 0u)) return win_tiles + j;
    }
    return -1;
  };
  // the tile after `tile` in this block's order, and its column bits: the
  // block's prefix tiles, then the suffix tiles it attends
  auto next_tile = [&](int tile, uint32_t& bits) -> int {
    if (tile < win_tiles && tile + 1 < pre_hi) {
      bits = tile_bits(tile + 1);
      return tile + 1;
    }
    return next_suffix(tile < win_tiles ? 0 : tile - win_tiles + 1, bits);
  };

  // With psz a multiple of 64 a prefix tile is 64 consecutive rows of one
  // page: its page index is read one issue ahead, off the copies' critical
  // path, and the copy is one contiguous block. Otherwise each token row
  // looks its page up (issue_rows).
  auto tile_page = [&](int tile) -> int {
    if (!aligned || tile < 0 || tile >= pre_hi) return 0;
    return tile == pre_lo ? page_lo : __ldg(pt + tile * kT / psz);
  };
  auto stage_ptr = [&](int st, int kv) -> unsigned char* {
    return smem + CF::ring + (2 * st + kv) * CF::tile;
  };
  auto scale_ptr = [&](int st, int kv) -> float* {
    return reinterpret_cast<float*>(smem + CF::scales) + (2 * st + kv) * kT;
  };
  // start the copies of one tile into ring stage st (`page`: an aligned
  // prefix tile's page)
  auto issue = [&](int tile, int st, int page) {
    unsigned char* kd = stage_ptr(st, 0);
    unsigned char* vd = stage_ptr(st, 1);
    constexpr int dst_stride = kQuant ? kRowBytes : LDH * 2;
    if (tile >= win_tiles) {
      issue_suffix<HD>(kd, vd, k_sfx, v_sfx, s, B, KH, kh, (tile - win_tiles) * kT, tid);
    } else if (!aligned) {
      issue_rows<HD, TKV>(kd, vd, kQuant ? scale_ptr(st, 0) : nullptr, scale_ptr(st, 1), k_pages, v_pages,
                          k_scales, v_scales, pt, plane, psz, tile * kT, limit, tid, dst_stride);
    } else {
      const int t0 = tile * kT;
      const size_t base = ((plane + page) * psz + t0 % psz) * kRowBytes;
      const int rows_in = limit - t0;  // rows of the tile inside the prefix
#pragma unroll
      for (int i = 0; i < kT * kRowChunks / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int rr = c / kRowChunks, ch = c % kRowChunks;
        const bool ok = rr < rows_in;
        const size_t src = ok ? base + (size_t)c * 16 : 0;
        cp_async16(kd + rr * dst_stride + ch * 16, reinterpret_cast<const unsigned char*>(k_pages) + src, ok);
        cp_async16(vd + rr * dst_stride + ch * 16, reinterpret_cast<const unsigned char*>(v_pages) + src, ok);
      }
      if constexpr (kQuant) {  // one scale a thread: K for threads 0..63, V for 64..127
        const int kv = tid / kT, rr = tid % kT;
        const bool ok = rr < rows_in;
        cp_async4(scale_ptr(st, kv) + rr, (kv ? v_scales : k_scales) + (ok ? base / kRowBytes + rr : 0), ok);
      }
    }
  };

  // The ring: tiles tl[0] (computing) .. tl[kStages - 2] in flight, one
  // barrier a tile; tb[i] holds tile tl[i]'s column bits.
  int tl[kStages];
  uint32_t tb[kStages];
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    tl[i] = -1;
    tb[i] = 0u;
  }
  if (pre_lo < pre_hi) {
    tl[0] = pre_lo;
    tb[0] = tile_bits(pre_lo);
  } else {
    tl[0] = next_suffix(0, tb[0]);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i > 0 && tl[i - 1] >= 0) tl[i] = next_tile(tl[i - 1], tb[i]);
    if (tl[i] >= 0) issue(tl[i], i, tile_page(tl[i]));
    cp_async_commit();
  }
  auto page_after = [&](int tile) -> int {  // the page of the prefix tile after `tile`
    return tile >= 0 && tile + 1 < pre_hi ? tile_page(tile + 1) : 0;
  };
  int page_next = page_after(tl[kStages - 2]);

  // the query tile (rows past B * G are zeros), staged in the ring's last
  // stage; its fragments stay in registers
  uint32_t qa[HD / 16][4];
  {
    bf16* q_s = reinterpret_cast<bf16*>(stage_ptr(kStages - 1, 0));
#pragma unroll
    for (int i = 0; i < kT * kChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<uint4*>(q_s + (c / kChunks) * LDH + (c % kChunks) * 8) = qv[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm_x4(qa[kk], q_s + (16 * warp + (lane & 15)) * LDH + 16 * kk + (lane >> 4) * 8);
    // (the loop's first barrier frees the stage before it is written)
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns

  int st = 0;  // the stage of tl[0]
  while (tl[0] >= 0) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tl[0] have landed
    __syncthreads();               // every thread's; and the previous tile's stage is free
    {
      uint32_t nb = 0u;
      const int nt = tl[kStages - 2] >= 0 ? next_tile(tl[kStages - 2], nb) : -1;
      const int pa = page_after(nt);
      if (nt >= 0) issue(nt, (st + kStages - 1) % kStages, page_next);
      cp_async_commit();
      page_next = pa;
      tl[kStages - 1] = nt;
      tb[kStages - 1] = nb;
    }
    const int cur = tl[0];
    const uint32_t cbits = tb[0];
    const bf16* k_t = reinterpret_cast<const bf16*>(stage_ptr(st, 0));
    const bf16* v_t = reinterpret_cast<const bf16*>(stage_ptr(st, 1));
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (kQuant) {
      if (cur < win_tiles) {  // raw bytes -> bf16, exactly (a suffix tile is bf16 already)
        bf16* cvt = reinterpret_cast<bf16*>(smem + CF::cvt);
        for (int c = tid; c < 2 * kT * kChunks; c += kThreads) {
          const int kv = c / (kT * kChunks), rem = c % (kT * kChunks);
          const int rr = rem / kChunks, col = (rem % kChunks) * 8;
          const uint2 raw = *reinterpret_cast<const uint2*>(stage_ptr(st, kv) + rr * HD + col);
          *reinterpret_cast<uint4*>(cvt + (kv * kT + rr) * LDH + col) = widen8<TKV>(raw);
        }
        __syncthreads();
        k_t = cvt;
        v_t = cvt + kT * LDH;
        ksc = scale_ptr(st, 0);
        vsc = scale_ptr(st, 1);
      }
    }

    if (warp_live && __any_sync(kFull, cbits != 0u)) {  // some row of the warp attends this tile
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
      // online softmax in the log2 domain: masked columns are -inf (a tile
      // whose 32 columns of this thread are all valid skips the mask);
      // the scale is folded into the exponent, exp2(s * scale - m)
      if constexpr (kQuant) {
        if (ksc != nullptr) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int e = 0; e < 2; ++e) sc[j][2 * r + e] *= ksc[8 * j + 2 * tq + e] * kDequant;
        }
      }
      if (cbits != 0xffffffffu) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (!((cbits >> (16 * r + 2 * j + e)) & 1u)) sc[j][2 * r + e] = -INFINITY;
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
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
      }
      // P (times the V scale) as bf16 A fragments: keys 16 kk .. 16 kk + 15
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = 2 * kk + h;
            float p0 = sc[j][2 * r], p1 = sc[j][2 * r + 1];
            if (kQuant && vsc != nullptr) {
              p0 *= vsc[8 * j + 2 * tq] * kDequant;
              p1 *= vsc[8 * j + 2 * tq + 1] * kDequant;
            }
            pa[kk][2 * h + r] = pack_bf16(p0, p1);
          }
      // O += P V
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int dd = 0; dd < HD / 16; ++dd) {
          uint32_t b[4];
          ldsm_x4_t(b, v_t + (16 * kk + (lane & 15)) * LDH + 16 * dd + (lane >> 4) * 8);
          mma16816(o[2 * dd], pa[kk], b[0], b[1]);
          mma16816(o[2 * dd + 1], pa[kk], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      tl[i] = tl[i + 1];
      tb[i] = tb[i + 1];
    }
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
    if (irow[r] < 0) continue;
    if (n_splits == 1) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no valid bit: exact zeros
      const int g = (row0 + gq + 8 * r) % G;
      bf16* orow = out + (((size_t)s * B + irow[r]) * H + (size_t)kh * G + g) * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * tq) =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    } else {
      const size_t prow = part_row(r);
      if (l[r] > 0.f) {
        const float inv = 1.f / l[r];
        float* orow = o_part + prow * HD;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<float2*>(orow + 8 * n + 2 * tq) = make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      }
      if (tq == 0) lse_part[prow] = l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : -INFINITY;
    }
  }
}

struct Args {
  const void* q; const void* ks; const void* vs; const void* kp; const void* vp;
  const float* ksc; const float* vsc; const int* plens; const int* pt; const uint8_t* mask;
  void* out; float* o_part; float* lse_part;
  int S, B, H, KH, N, psz, wp, pt_stride, layer, n_splits;
  cudaStream_t stream;
};

template <int HD, typename TKV, bool kPrefill>
int prepare() {
  static_assert(Cfg<HD, TKV, kPrefill>::bytes <= kMaxSmem, "shared memory");
  return static_cast<int>(cudaFuncSetAttribute(suffix_kernel<HD, TKV, kPrefill>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)Cfg<HD, TKV, kPrefill>::bytes));
}

template <int HD, typename TKV, bool kPrefill>
int launch_cfg(const Args& a) {
  int rc = prepare<HD, TKV, kPrefill>();
  if (rc != 0) return rc;
  typedef Cfg<HD, TKV, kPrefill> CF;
  const int G = a.H / a.KH, BG = a.B * G;
  dim3 grid(((BG + kT - 1) / kT) * a.n_splits, a.KH, a.S);
  suffix_kernel<HD, TKV, kPrefill><<<grid, kThreads, CF::bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.ks),
      static_cast<const bf16*>(a.vs), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.ksc, a.vsc, a.plens, a.pt, a.mask,
      static_cast<bf16*>(a.out), a.o_part, a.lse_part, a.S, a.B, a.H, a.KH, a.N, a.psz, a.wp,
      a.pt_stride, a.layer, a.n_splits,
      static_cast<float>(kLog2e / sqrt(static_cast<double>(HD))));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || a.n_splits == 1) return rc;
  const int rows = a.S * a.KH * BG;
  const long long threads = (long long)rows * (HD / 4);
  merge_kernel<HD><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, a.stream>>>(
      a.o_part, a.lse_part, static_cast<bf16*>(a.out), rows, a.B, G, a.KH, a.n_splits);
  return static_cast<int>(cudaGetLastError());
}

// the prefill configuration where a (slot, KV head) cell has >= 128 rows
template <int HD, typename TKV>
int launch(const Args& a) {
  if (a.B * (a.H / a.KH) >= 128) return launch_cfg<HD, TKV, true>(a);
  return launch_cfg<HD, TKV, false>(a);
}

template <int HD, typename TKV, bool kPrefill>
int occupancy(int* info) {
  int rc = prepare<HD, TKV, kPrefill>();
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  rc = static_cast<int>(cudaFuncGetAttributes(&attr, suffix_kernel<HD, TKV, kPrefill>));
  if (rc != 0) return rc;
  int blocks = 0;
  rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, suffix_kernel<HD, TKV, kPrefill>, kThreads, Cfg<HD, TKV, kPrefill>::bytes));
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(Cfg<HD, TKV, kPrefill>::bytes);
  info[2] = blocks;
  return rc;
}

template <int HD>
int by_kv(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case 1: return launch<HD, bf16>(a);
    case 2: return launch<HD, int8_t>(a);
    case 3: return launch<HD, Fp8>(a);
    default: return -1;
  }
}

template <int HD, bool kPrefill>
int occupancy_by_kv(int kv_dtype, int* info) {
  switch (kv_dtype) {
    case 1: return occupancy<HD, bf16, kPrefill>(info);
    case 2: return occupancy<HD, int8_t, kPrefill>(info);
    case 3: return occupancy<HD, Fp8, kPrefill>(info);
    default: return -1;
  }
}

}  // namespace

// q [S, B, H, hd], k_suffix / v_suffix [S, B, KH, hd]: contiguous bf16.
// k_pages / v_pages: contiguous [L, KH, N, psz, hd]; kv_dtype 1 = bf16,
// 2 = int8, 3 = fp8-e4m3 (2 and 3 need the contiguous f32 scales
// [L, KH, N, psz, 1]). prefix_lens [S] int32, page_table [S, pt_stride]
// int32 (first wp columns used), suffix_mask [S, B, B] one byte each,
// out [S, B, H, hd] bf16. n_splits > 1 needs the f32 scratch o_part
// [n_splits, S, KH, B * H / KH, hd] and lse_part [n_splits, S, KH,
// B * H / KH] and launches the merge after the splits. Returns
// cudaGetLastError() after the launches, or -1 for an unsupported
// combination.
extern "C" int paged_suffix_attention(
    const void* q, const void* k_suffix, const void* v_suffix, const void* k_pages,
    const void* v_pages, const void* k_scales, const void* v_scales, const void* prefix_lens,
    const void* page_table, const void* suffix_mask, void* out, void* o_part, void* lse_part,
    int S, int B, int H, int KH, int N, int psz, int hd, int wp, int pt_stride, int layer,
    int kv_dtype, int n_splits, void* stream) {
  if (KH <= 0 || H % KH != 0 || psz <= 0 || S < 0 || B < 0 || S > 65535 || KH > 65535) return -1;
  if ((kv_dtype >= 2) != (k_scales != nullptr && v_scales != nullptr)) return -1;
  if (n_splits < 1 || (n_splits > 1 && (o_part == nullptr || lse_part == nullptr))) return -1;
  if (S == 0 || B == 0) return 0;
  Args a{q, k_suffix, v_suffix, k_pages, v_pages,
         static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
         static_cast<const int*>(prefix_lens), static_cast<const int*>(page_table),
         static_cast<const uint8_t*>(suffix_mask), out, static_cast<float*>(o_part),
         static_cast<float*>(lse_part),
         S, B, H, KH, N, psz, wp, pt_stride, layer, n_splits, static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 64: return by_kv<64>(kv_dtype, a);
    case 128: return by_kv<128>(kv_dtype, a);
    default: return -1;
  }
}

// The split kernel's resources for (hd, kv_dtype, prefill: the
// configuration of cells of >= 128 rows, else verify's): info[0]
// registers a thread, info[1] dynamic shared memory bytes, info[2] blocks
// an SM holds.
extern "C" int paged_suffix_attention_occupancy(int hd, int kv_dtype, int prefill, int* info) {
  switch (hd) {
    case 64: return prefill ? occupancy_by_kv<64, true>(kv_dtype, info) : occupancy_by_kv<64, false>(kv_dtype, info);
    case 128: return prefill ? occupancy_by_kv<128, true>(kv_dtype, info) : occupancy_by_kv<128, false>(kv_dtype, info);
    default: return -1;
  }
}
