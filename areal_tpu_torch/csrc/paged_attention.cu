// Paged decode attention for Hopper (sm_90a), called through ctypes.
//
// Replaces the TPU kernel areal_tpu/ops/paged_attention_q8.py:
// paged_attention_stacked (bodies _stacked_kernel / _stacked_kernel_noscale,
// around jax's paged_flash_attention_kernel_inline_seq_dim). It computes
// the same function: q_len = 1 grouped-query attention for S slots over
// their page tables, masked to min(lengths[s], wp * psz), reading one layer
// of the stacked KV cache in place (the caller passes the layer's pointer;
// the page table's row stride may exceed wp). q is raw: 1/sqrt(hd) is
// applied inside, in f32. int8 and fp8-e4m3 pages dequantize as
// x * scale / 127.5 with one f32 scale per token vector (the narrow
// [..., psz, 1] scales). lengths[s] == 0 writes exact zeros.
//
// What bounds it: device-memory bytes. A slot reads len * KH * hd * 2 (K
// and V) page elements (plus 2 * 4 bytes of scales a row when quantized)
// for ~4 * G flops an element, far below the ~295 flop/byte an H100 needs
// before its tensor cores limit, at every G <= 8 and page type: the bound
// is sum(len) * KH * hd * 2 * bytes_per_element / 3.35 TB/s.
//
// The design for bf16 queries over bf16, int8 and fp8 pages (decode_kernel;
// every combination the engine serves):
//   - tensor cores with S, P and O in registers: a (slot, KV head) cell's
//     G <= 8 query rows are rows 0..7 of mma.sync m16n8k16 (rows 8..15
//     carry q = 0 and are neither computed into nor written: mma_rows8).
//     The Q fragments are read once from device memory. A block of 4 warps
//     takes a split's 64-key tiles in order; warp w owns keys 16w..16w+15
//     of each, so S is two 8-key column tiles, P one bf16 A fragment packed
//     straight from S's accumulator, and O (8 x hd f32, hd / 4 values a
//     thread) stays in registers. Row max and sum take the quad's
//     shuffles; the softmax scale is folded into exp2's argument and O is
//     rescaled only when a row's max moved (flash_mma.cuh and #3's rules).
//     Each warp keeps its own m, l and O; the 4 merge once, in shared
//     memory, at the end of the split.
//   - a cp.async ring of 64-token K/V tiles (16 bytes a thread, one
//     barrier a tile): the next stages - 1 tiles are in flight while one
//     computes. A tile of an aligned page (psz a multiple of 64) is one
//     contiguous copy whose page index was read one issue ahead; otherwise
//     each token row looks its page up. Rows past the slot's length are
//     zero-filled by the copy and masked.
//   - int8 / fp8 pages: the ring stages the raw bytes and the f32 scales,
//     and the conversion to bf16 (exact: 7-bit integers, 3-bit mantissas)
//     happens in registers while the B fragments are built, with no
//     shared-memory pass and no barrier of its own: at decode no K/V tile
//     is read by more than one row tile, so a converted copy would be
//     written once and read once (#3's pass of that kind cost 30-40% at
//     verify, PERF.md). int8 takes a byte permute and an f32 add a value
//     (Cvt<int8_t>: I2F's quarter rate made int8 the slowest page type),
//     fp8 the hardware's e4m3x2 -> f16x2 conversion. Even so the
//     conversions lengthen a tile's chain of dependent instructions about
//     2x over bf16's ldmatrix, which at the kernel phase's ragged lengths
//     leaves int8 / fp8 10-15% behind bf16 for all their halved bytes
//     (PERF.md). K is read a 16-byte run of one key row a thread and
//     V a run of hd / 8 bytes of each of 4 key rows, so the head dimension
//     is permuted: for K the same permutation is applied to Q's fragments
//     (the dot product does not see it), for V it is undone when O is
//     written. The K scale multiplies S's columns and the V scale P before
//     P rounds to bf16, in f32, as #3 does. Row strides are chosen for
//     conflict-free shared-memory reads: bf16 rows padded by 16 bytes
//     (ldmatrix), int8 / fp8 K rows at hd + 64 bytes (hd % 128 == 0) and V
//     rows at hd + 16.
//   - split-KV over the window: the grid is (S, KH, P); split p covers the
//     window's 64-token tiles [p * per, (p + 1) * per), per = ceil(tiles /
//     P), with P from shapes alone (the wrapper's pick_splits, never from
//     lengths, which live on the device: no host sync, and the call can be
//     captured in a CUDA graph). A split that starts at or past its slot's
//     length writes lse = -inf and exits. With P > 1 each split writes its
//     O normalised by its own row sum and its natural-log log-sum-exp to
//     f32 scratch, and merge_kernel (split_merge.cuh, shared with #3 at
//     B = 1) combines them in a fixed order: the same bits every call.
//     P = 1 writes bf16 directly.
//   - shared memory, at hd = 128: bf16 2 stages x (K, V) x 64 x 272 bytes
//     = 69,632 B; int8 / fp8 3 stages x (12,288 + 9,216 + 512) = 66,048 B.
//     Measured on an H100 (nvcc 12.8): 168 registers a thread (the cap that
//     __launch_bounds__ sets for 3 blocks an SM; bf16 spills 40 bytes) and
//     3 blocks an SM for every page type. `paged_attention_occupancy`
//     reports them; chip_smoke.py prints them. A 3-stage bf16 ring (2
//     blocks an SM) and L2 prefetch of the tiles ahead measured no better.
// What bounds it now (PERF.md): at ragged lengths, the blocks of the
// longest slots, each streaming its split's tiles one after another, and
// the fixed cost of a launch and the merge (chip_smoke.py's kernel phase
// prints both: times at uniform lengths of 128, 512 and 2,048 rows). What
// it leaves for later: wgmma and TMA, a persistent schedule that deals
// tiles rather than fixed splits (the longest slot still sets the time of
// its splits), and CUDA graphs for the whole decode step.
//
// f32 queries or f32 pages keep the first port's CUDA-core kernel
// (namespace scalar below, unchanged): bf16 tensor cores cannot hold the
// f32 tolerance its tests ask, and the engine never serves f32 on the card.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "split_merge.cuh"

namespace {

constexpr int kMaxG = 8;  // query heads per KV head: the MMA's rows 0..7

// c[rows 0..7 of 16 x 8] += a[16 x 16] b[16 x 8] where rows 8..15 of a are
// zero: a thread passes its row-gq halves a0 (k 2tq, 2tq + 1) and a2 (k
// 2tq + 8, 2tq + 9) and keeps the two accumulators of row gq.
__device__ __forceinline__ void mma_rows8(float (&c)[2], uint32_t a0, uint32_t a2, uint32_t b0, uint32_t b1) {
  float d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %10, %10};\n"
      : "+f"(c[0]), "+f"(c[1]), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f));
}

// One-byte page values -> bf16 pairs, exactly, in registers. A page word is
// first passed through prep (once), then pair(a, i, b, j) is the bf16 pair
// (low: byte i of word a, high: byte j of word b).
template <typename T> struct Cvt;
// int8: with the sign bit flipped (x ^ 0x80 = x + 128), 0x4B0000xx is the f32
// 2^23 + x + 128, so one byte permute and one add give x exactly (I2F runs
// at a quarter of the rate)
template <> struct Cvt<int8_t> {
  static __device__ __forceinline__ uint32_t prep(uint32_t w) { return w ^ 0x80808080u; }
  static __device__ __forceinline__ float one(uint32_t w, int i) {
    return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | i)) - 8388736.f;
  }
  static __device__ __forceinline__ uint32_t pair(uint32_t a, int i, uint32_t b, int j) {
    return pack_bf16(one(a, i), one(b, j));
  }
};
// fp8-e4m3: the hardware's e4m3x2 -> f16x2 conversion, then f32 -> bf16
template <> struct Cvt<Fp8> {
  static __device__ __forceinline__ uint32_t prep(uint32_t w) { return w; }
  static __device__ __forceinline__ uint32_t pair(uint32_t a, int i, uint32_t b, int j) {
    const uint32_t two = __byte_perm(a, b, i | (4 + j) << 4);
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    return pack_bf16(f.x, f.y);
  }
};

// The block's configuration by page type. Shared memory: the ring's stages,
// each a K tile, a V tile (64 rows at the strides below) and, for int8 /
// fp8 pages, the tile's f32 K and V scales; at the end of a split the
// warps' O, m and l reuse it.
template <int HD, typename TKV>
struct DCfg {
  static constexpr bool quant = IsQuant<TKV>::value;
  static constexpr int stages = quant ? 3 : 2;
  static constexpr int k_ld = quant ? (HD % 128 ? HD : HD + 64) : 2 * (HD + kPad);  // bytes a K row
  static constexpr int v_ld = quant ? HD + 16 : 2 * (HD + kPad);                     // bytes a V row
  static constexpr size_t k_tile = static_cast<size_t>(kT) * k_ld;
  static constexpr size_t v_tile = static_cast<size_t>(kT) * v_ld;
  static constexpr size_t stage = k_tile + v_tile + (quant ? sizeof(float) * 2 * kT : 0);
  static constexpr size_t merge = sizeof(float) * kWarps * kMaxG * (HD + 2);
  static constexpr size_t bytes = stages * stage > merge ? stages * stage : merge;
};

template <int HD, typename TKV>
__global__ void __launch_bounds__(kThreads, 3) decode_kernel(
    const bf16* __restrict__ q,          // [S, H, HD]
    const TKV* __restrict__ k_pages,     // [KH, N, psz, HD] (one layer)
    const TKV* __restrict__ v_pages,
    const float* __restrict__ k_scales,  // [KH, N, psz] (one layer) or null
    const float* __restrict__ v_scales,
    const int* __restrict__ lengths,     // [S]
    const int* __restrict__ page_table,  // [S, pt_stride], first wp columns used
    bf16* __restrict__ out,              // [S, H, HD] (n_splits == 1)
    float* __restrict__ o_part,          // [P, S, KH, G, HD] (n_splits > 1)
    float* __restrict__ lse_part,        // [P, S, KH, G]
    int S, int H, int KH, int N, int psz, int wp, int pt_stride, int n_splits, float scale_log2) {
  typedef DCfg<HD, TKV> CF;
  constexpr bool kQuant = CF::quant;
  constexpr int kStages = CF::stages;
  constexpr int kRowBytes = HD * static_cast<int>(sizeof(TKV));  // one page row
  constexpr int kRowChunks = kRowBytes / 16;
  constexpr int LDH = HD + kPad;  // bf16 elements a staged bf16 row
  constexpr int kVB = HD / 8;     // int8 / fp8: V bytes a thread reads of a key row
  extern __shared__ __align__(128) unsigned char smem[];

  const int s = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int G = H / KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row (query head), thread of the quad

  // this split's window tiles, and the first one's page (read before the
  // slot's length is known, so the two reads overlap)
  const int* pt = page_table + static_cast<size_t>(s) * pt_stride;
  const bool aligned = psz % kT == 0;
  const int win_tiles = (wp * psz + kT - 1) / kT;
  const int per = (win_tiles + n_splits - 1) / n_splits;
  const int lo = split * per;
  const int page_lo = aligned && lo < win_tiles ? __ldg(pt + lo * kT / psz) : 0;

  // the Q fragments of row gq (zeros for gq >= G): qa[kk][0] holds k
  // 2tq, 2tq + 1 of k-step kk, qa[kk][1] k 2tq + 8, 2tq + 9. bf16 pages:
  // head dims 16 kk + those k. int8 / fp8 pages: the permutation of the K
  // reads below, k-step kk = 4c + i at dims 64c + 16tq + 4i + (0, 1 | 2, 3).
  const size_t head0 = static_cast<size_t>(s) * H + static_cast<size_t>(kh) * G;
  uint32_t qa[HD / 16][2];
  {
    const bf16* qrow = q + (head0 + gq) * HD;
    const bool live = gq < G;
    if constexpr (kQuant) {
#pragma unroll
      for (int c = 0; c < HD / 64; ++c) {
        uint4 x0 = make_uint4(0u, 0u, 0u, 0u), x1 = x0;
        if (live) {
          x0 = *reinterpret_cast<const uint4*>(qrow + 64 * c + 16 * tq);
          x1 = *reinterpret_cast<const uint4*>(qrow + 64 * c + 16 * tq + 8);
        }
        const uint32_t w[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[4 * c + i][0] = w[2 * i];
          qa[4 * c + i][1] = w[2 * i + 1];
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        qa[kk][0] = live ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 2 * tq) : 0u;
        qa[kk][1] = live ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8 + 2 * tq) : 0u;
      }
    }
  }

  const int len = max(min(lengths[s], wp * psz), 0);
  const int hi = min(lo + per, (len + kT - 1) / kT);
  if (lo >= hi) {  // nothing here: P = 1 means len == 0 (exact zeros), else lse = -inf
    if (n_splits == 1) {
      for (int i = tid; i < G * HD; i += kThreads) out[head0 * HD + i] = __float2bfloat16(0.f);
    } else if (tid < G) {
      lse_part[((static_cast<size_t>(split) * S + s) * KH + kh) * G + tid] = -INFINITY;
    }
    return;
  }

  const size_t plane = static_cast<size_t>(kh) * N;  // pages before this KV head's plane
  auto stage_ptr = [&](int st) -> unsigned char* { return smem + st * CF::stage; };
  auto tile_page = [&](int tile) -> int {  // an aligned tile's page
    if (!aligned) return 0;
    return tile == lo ? page_lo : __ldg(pt + tile * kT / psz);
  };
  // start the copies of one tile into ring stage st
  auto issue = [&](int tile, int st, int page) {
    unsigned char* kd = stage_ptr(st);
    unsigned char* vd = kd + CF::k_tile;
    const int t0 = tile * kT;
    const int rows_in = len - t0;  // rows of the tile below the length
    auto row_of = [&](int rr) -> size_t {
      if (aligned) return (plane + page) * psz + t0 % psz + rr;
      const int t = t0 + rr;
      return (plane + __ldg(pt + t / psz)) * psz + t % psz;
    };
    static_assert(kT * kRowChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
    for (int i = 0; i < kT * kRowChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int rr = c / kRowChunks, ch = c % kRowChunks;
      const bool ok = rr < rows_in;
      const size_t src = ok ? row_of(rr) * kRowBytes + ch * 16 : 0;
      cp_async16(kd + rr * CF::k_ld + ch * 16, reinterpret_cast<const unsigned char*>(k_pages) + src, ok);
      cp_async16(vd + rr * CF::v_ld + ch * 16, reinterpret_cast<const unsigned char*>(v_pages) + src, ok);
    }
    if constexpr (kQuant) {  // one scale a thread: K for threads 0..63, V for 64..127
      static_assert(kThreads == 2 * kT, "one scale a thread");
      float* sd = reinterpret_cast<float*>(vd + CF::v_tile);
      const int kv = tid / kT, rr = tid % kT;
      const bool ok = rr < rows_in;
      cp_async4(sd + kv * kT + rr, (kv ? v_scales : k_scales) + (ok ? row_of(rr) : 0), ok);
    }
  };

  // the ring: tile lo + i in stage i % kStages, the next kStages - 1 in flight
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (lo + i < hi) issue(lo + i, i, tile_page(lo + i));
    cp_async_commit();
  }
  int page_next = lo + kStages - 1 < hi ? tile_page(lo + kStages - 1) : 0;

  float o[HD / 8][2];  // row gq, columns 2tq, 2tq + 1 of column tile n
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = 0.f;
  float m = -INFINITY, l = 0.f;  // m: row gq's max in the log2 domain; l: this thread's columns

  int st = 0;
  for (int tile = lo; tile < hi; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `tile` have landed
    __syncthreads();               // every thread's; and the previous tile's stage is free
    {
      const int nt = tile + kStages - 1;
      if (nt < hi) issue(nt, (st + kStages - 1) % kStages, page_next);
      cp_async_commit();
      page_next = nt + 1 < hi ? tile_page(nt + 1) : 0;
    }
    const int key0 = tile * kT + 16 * warp;  // the warp's first key
    if (key0 < len) {
      const unsigned char* k_t = stage_ptr(st);
      const unsigned char* v_t = k_t + CF::k_tile;
      const float* ksc = reinterpret_cast<const float*>(v_t + CF::v_tile) + 16 * warp;
      const float* vsc = ksc + kT;
      // S = Q K^T over the warp's 16 keys: column tile j holds keys 8j ..
      float sc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      if constexpr (kQuant) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const unsigned char* krow = k_t + (16 * warp + 8 * j + gq) * CF::k_ld + 16 * tq;
#pragma unroll
          for (int c = 0; c < HD / 64; ++c) {
            const uint4 raw = *reinterpret_cast<const uint4*>(krow + 64 * c);
            const uint32_t w[4] = {Cvt<TKV>::prep(raw.x), Cvt<TKV>::prep(raw.y), Cvt<TKV>::prep(raw.z),
                                   Cvt<TKV>::prep(raw.w)};
#pragma unroll
            for (int i = 0; i < 4; ++i)
              mma_rows8(sc[j], qa[4 * c + i][0], qa[4 * c + i][1], Cvt<TKV>::pair(w[i], 0, w[i], 1),
                        Cvt<TKV>::pair(w[i], 2, w[i], 3));
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) sc[j][e] *= ksc[8 * j + 2 * tq + e] * kDequant;
      } else {
        const bf16* kb = reinterpret_cast<const bf16*>(k_t);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t b[4];
          ldsm_x4(b, kb + (16 * warp + (lane & 7) + ((lane >> 4) << 3)) * LDH + 16 * kk + ((lane >> 3) & 1) * 8);
          mma_rows8(sc[0], qa[kk][0], qa[kk][1], b[0], b[1]);
          mma_rows8(sc[1], qa[kk][0], qa[kk][1], b[2], b[3]);
        }
      }
      const int n_valid = len - key0;  // keys of the warp below the length
      if (n_valid < 16) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + 2 * tq + e >= n_valid) sc[j][e] = -INFINITY;
      }
      // online softmax of row gq in the log2 domain (key0 < len: the max is finite)
      float mx = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m, mx * scale_log2);
      const float alpha = fast_exp2(m - m_new);  // 0 on the warp's first tile
      m = m_new;
      float p[2][2], psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[j][e] = fast_exp2(fmaf(sc[j][e], scale_log2, -m_new));  // masked: 0
          psum += p[j][e];
        }
      l = l * alpha + psum;
      if (__any_sync(kFull, alpha != 1.f)) {  // a row's max moved
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[n][0] *= alpha;
          o[n][1] *= alpha;
        }
      }
      // P (times the V scale) as the bf16 A fragment of the warp's 16 keys
      if constexpr (kQuant) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) p[j][e] *= vsc[8 * j + 2 * tq + e] * kDequant;
      }
      const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]);
      const uint32_t pa2 = pack_bf16(p[1][0], p[1][1]);
      // O += P V
      if constexpr (kQuant) {
        // keys 2tq, 2tq + 1, 2tq + 8, 2tq + 9 of the warp's 16, bytes
        // gq * kVB .. of each: column n of tile dd is head dim n * kVB + dd
        constexpr int kW = kVB / 4;  // 32-bit words a row
        uint32_t vw[4][kW];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const unsigned char* vrow = v_t + (16 * warp + 2 * tq + (r & 1) + 8 * (r >> 1)) * CF::v_ld + gq * kVB;
          if constexpr (kW == 4) {
            const uint4 x = *reinterpret_cast<const uint4*>(vrow);
            vw[r][0] = Cvt<TKV>::prep(x.x);
            vw[r][1] = Cvt<TKV>::prep(x.y);
            vw[r][2] = Cvt<TKV>::prep(x.z);
            vw[r][3] = Cvt<TKV>::prep(x.w);
          } else {
            const uint2 x = *reinterpret_cast<const uint2*>(vrow);
            vw[r][0] = Cvt<TKV>::prep(x.x);
            vw[r][1] = Cvt<TKV>::prep(x.y);
          }
        }
#pragma unroll
        for (int dd = 0; dd < kVB; ++dd) {
          const int wi = dd / 4, by = dd % 4;  // byte `by` of word wi of each row
          const uint32_t b0 = Cvt<TKV>::pair(vw[0][wi], by, vw[1][wi], by);
          const uint32_t b1 = Cvt<TKV>::pair(vw[2][wi], by, vw[3][wi], by);
          mma_rows8(o[dd], pa0, pa2, b0, b1);
        }
      } else {
        const bf16* vb = reinterpret_cast<const bf16*>(v_t);
#pragma unroll
        for (int dd = 0; dd < HD / 16; ++dd) {
          uint32_t b[4];
          ldsm_x4_t(b, vb + (16 * warp + (lane & 15)) * LDH + 16 * dd + (lane >> 4) * 8);
          mma_rows8(o[2 * dd], pa0, pa2, b[0], b[1]);
          mma_rows8(o[2 * dd + 1], pa0, pa2, b[2], b[3]);
        }
      }
    }
    st = st + 1 == kStages ? 0 : st + 1;
  }
  cp_async_wait<0>();

  // merge the 4 warps' (m, l, O) of each row in shared memory
  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);
  __syncthreads();  // every warp is done with the ring
  float* o_sh = reinterpret_cast<float*>(smem);  // [kWarps][kMaxG][HD]
  float* m_sh = o_sh + kWarps * kMaxG * HD;      // [kWarps][kMaxG]
  float* l_sh = m_sh + kWarps * kMaxG;
  {
    float* orow = o_sh + (warp * kMaxG + gq) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = kQuant ? (2 * tq + e) * kVB + n : 8 * n + 2 * tq + e;
        orow[d] = o[n][e];
      }
    if (tq == 0) {
      m_sh[warp * kMaxG + gq] = m;
      l_sh[warp * kMaxG + gq] = l;
    }
  }
  __syncthreads();
  const size_t prow = ((static_cast<size_t>(split) * S + s) * KH + kh) * G;  // the scratch rows
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_sh[w * kMaxG + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_sh[w * kMaxG + g];
      if (mw == -INFINITY) continue;  // a warp that saw no key below the length
      const float e = fast_exp2(mw - M);
      L += l_sh[w * kMaxG + g] * e;
      O += o_sh[(w * kMaxG + g) * HD + d] * e;
    }
    // warp 0 saw key lo * 64 < len, so M is finite and L > 0
    if (n_splits == 1) {
      out[head0 * HD + i] = __float2bfloat16(O / L);
    } else {
      o_part[(prow + g) * HD + d] = O / L;
      if (d == 0) lse_part[prow + g] = (M + log2f(L)) * kLn2;
    }
  }
}

struct MArgs {
  const void* q; const void* k; const void* v; const float* ks; const float* vs;
  const int* lengths; const int* page_table; void* out; float* o_part; float* lse_part;
  int S, H, KH, N, psz, wp, pt_stride, n_splits;
  cudaStream_t stream;
};

template <int HD, typename TKV>
int prepare() {
  static_assert(DCfg<HD, TKV>::bytes <= kMaxSmem, "shared memory");
  static const int rc = static_cast<int>(cudaFuncSetAttribute(
      decode_kernel<HD, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DCfg<HD, TKV>::bytes));
  return rc;
}

template <int HD, typename TKV>
int launch_mma(const MArgs& a) {
  int rc = prepare<HD, TKV>();
  if (rc != 0) return rc;
  dim3 grid(a.S, a.KH, a.n_splits);
  decode_kernel<HD, TKV><<<grid, kThreads, DCfg<HD, TKV>::bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v), a.ks, a.vs,
      a.lengths, a.page_table, static_cast<bf16*>(a.out), a.o_part, a.lse_part, a.S, a.H, a.KH, a.N, a.psz,
      a.wp, a.pt_stride, a.n_splits, static_cast<float>(kLog2e / sqrt(static_cast<double>(HD))));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || a.n_splits == 1) return rc;
  const int G = a.H / a.KH, rows = a.S * a.KH * G;
  const long long threads = (long long)rows * (HD / 4);
  merge_kernel<HD><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, a.stream>>>(
      a.o_part, a.lse_part, static_cast<bf16*>(a.out), rows, 1, G, a.KH, a.n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int mma_by_kv(int kv_dtype, const MArgs& a) {
  switch (kv_dtype) {
    case 1: return launch_mma<HD, bf16>(a);
    case 2: return launch_mma<HD, int8_t>(a);
    case 3: return launch_mma<HD, Fp8>(a);
    default: return -1;
  }
}

template <int HD, typename TKV>
int occupancy(int* info) {
  int rc = prepare<HD, TKV>();
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  rc = static_cast<int>(cudaFuncGetAttributes(&attr, decode_kernel<HD, TKV>));
  if (rc != 0) return rc;
  int blocks = 0;
  rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, decode_kernel<HD, TKV>, kThreads, DCfg<HD, TKV>::bytes));
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(DCfg<HD, TKV>::bytes);
  info[2] = blocks;
  return rc;
}

template <int HD>
int occupancy_by_kv(int kv_dtype, int* info) {
  switch (kv_dtype) {
    case 1: return occupancy<HD, bf16>(info);
    case 2: return occupancy<HD, int8_t>(info);
    case 3: return occupancy<HD, Fp8>(info);
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// f32 queries or f32 pages: the first port's kernel, unchanged. One block of
// 8 warps per (slot, KV head); each lane holds an hd / 32 slice of the G
// query rows in f32; a warp loads 4 K and 4 V rows at a time (page_size a
// multiple of 4: one page-table lookup), reduces the dots across its lanes
// and keeps its own online softmax; the 8 warps merge in shared memory.
// ---------------------------------------------------------------------------

namespace scalar {

constexpr int kMaxG = 8;    // query heads per KV head (Qwen2/3 use <= 8)
constexpr int kWarps = 8;   // warps per block; each streams its own rows
constexpr int kRows = 4;    // rows a warp loads per step

// storage tags: raw bits, converted with the CUDA intrinsics
struct Bf16 { unsigned short bits; };
struct Fp8 { uint8_t bits; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(Bf16 x) {
  return __bfloat162float(__ushort_as_bfloat16(x.bits));
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(Fp8 x) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(x.bits), __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(Bf16* p, float v) {
  p->bits = __bfloat16_as_ushort(__float2bfloat16(v));
}

template <typename T> struct IsQuant { static constexpr bool value = false; };
template <> struct IsQuant<int8_t> { static constexpr bool value = true; };
template <> struct IsQuant<Fp8> { static constexpr bool value = true; };

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec { T v[N]; };

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kWarps * 32) paged_decode_kernel(
    const TQ* __restrict__ q,            // [S, H, HD]
    const TKV* __restrict__ k_pages,     // [KH, N, psz, HD] (one layer)
    const TKV* __restrict__ v_pages,
    const float* __restrict__ k_scales,  // [KH, N, psz] (one layer) or null
    const float* __restrict__ v_scales,
    const int* __restrict__ lengths,     // [S]
    const int* __restrict__ page_table,  // [S, pt_stride], first wp columns used
    TQ* __restrict__ out,                // [S, H, HD]
    int H, int KH, int N, int psz, int wp, int pt_stride) {
  constexpr int kVec = HD / 32;  // contiguous elements per lane
  constexpr bool kScaled = IsQuant<TKV>::value;

  const int s = blockIdx.x / KH;
  const int kh = blockIdx.x % KH;
  const int G = H / KH;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __shared__ float m_sh[kWarps][kMaxG], l_sh[kWarps][kMaxG];
  __shared__ float o_sh[kWarps][kMaxG][HD];

  const int len = min(lengths[s], wp * psz);
  const size_t head0 = (size_t)s * H + (size_t)kh * G;
  TQ* o = out + head0 * HD;
  if (len <= 0) {
    for (int i = threadIdx.x; i < G * HD; i += blockDim.x) store(o + i, 0.f);
    return;
  }

  const float sm_scale = rsqrtf((float)HD);
  const TQ* qb = q + head0 * HD + lane * kVec;
  float qr[kMaxG][kVec], acc[kMaxG][kVec], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      qr[g][i] = g < G ? to_f(qb[(size_t)g * HD + i]) * sm_scale : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  const size_t plane = (size_t)kh * N * psz;  // rows before this KV head's plane
  const TKV* kb = k_pages + plane * HD + lane * kVec;
  const TKV* vb = v_pages + plane * HD + lane * kVec;
  const int* pt = page_table + (size_t)s * pt_stride;

  for (int t0 = warp * kRows; t0 < len; t0 += kWarps * kRows) {
    // psz % kRows == 0 and t0 % kRows == 0, so the chunk lies in one page
    // (rows past len stay inside it and are masked below)
    const long long base = (long long)__ldg(pt + t0 / psz) * psz + t0 % psz;
    // issue all of this step's loads before using any of them
    Vec<TKV, kVec> kv[kRows], vv[kRows];
    float ksc[kRows], vsc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      kv[j] = *reinterpret_cast<const Vec<TKV, kVec>*>(kb + (base + j) * HD);
      vv[j] = *reinterpret_cast<const Vec<TKV, kVec>*>(vb + (base + j) * HD);
      ksc[j] = kScaled ? __ldg(k_scales + plane + base + j) * (1.f / 127.5f) : 1.f;
      vsc[j] = kScaled ? __ldg(v_scales + plane + base + j) * (1.f / 127.5f) : 1.f;
    }
    float kf[kRows][kVec], vf[kRows][kVec];  // converted once, used by every head
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        kf[j][i] = to_f(kv[j].v[i]);
        // rows past len may hold anything finite or not: never let them in
        vf[j][i] = t0 + j < len ? to_f(vv[j].v[i]) * vsc[j] : 0.f;
      }
    }
    // all kMaxG head slots, without a branch on G: the heads' independent
    // dot -> reduce -> softmax chains then interleave (a per-head branch
    // serialized them); missing heads have q = 0 and their results go unused
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      float sc[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) a += qr[g][i] * kf[j][i];
        sc[j] = a;
      }
      float cm = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float dot = warp_sum(sc[j]);  // all lanes take part
        sc[j] = t0 + j < len ? dot * ksc[j] : -INFINITY;
        cm = fmaxf(cm, sc[j]);
      }
      const float mn = fmaxf(m[g], cm);  // finite: row t0 < len is valid
      const float alpha = __expf(m[g] - mn);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        sc[j] = __expf(sc[j] - mn);
        psum += sc[j];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = mn;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float x = acc[g][i] * alpha;
#pragma unroll
        for (int j = 0; j < kRows; ++j) x += sc[j] * vf[j][i];
        acc[g][i] = x;
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) continue;
#pragma unroll
    for (int i = 0; i < kVec; ++i) o_sh[warp][g][lane * kVec + i] = acc[g][i];
    if (lane == 0) {
      m_sh[warp][g] = m[g];
      l_sh[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += blockDim.x) {
    const int g = idx / HD, d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_sh[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_sh[w][g];
      if (mw == -INFINITY) continue;  // a warp that got no rows
      const float e = __expf(mw - M);
      L += l_sh[w][g] * e;
      O += o_sh[w][g][d] * e;
    }
    store(o + idx, O / L);
  }
}

struct Args {
  const void* q; const void* k; const void* v; const void* ks; const void* vs;
  const int* lengths; const int* page_table; void* out;
  int S, H, KH, N, psz, wp, pt_stride;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int HD>
int launch(const Args& a) {
  paged_decode_kernel<TQ, TKV, HD><<<a.S * a.KH, kWarps * 32, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), a.lengths, a.page_table,
      static_cast<TQ*>(a.out), a.H, a.KH, a.N, a.psz, a.wp, a.pt_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, int HD>
int by_kv(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case 0: return launch<TQ, float, HD>(a);
    case 1: return launch<TQ, Bf16, HD>(a);
    case 2: return launch<TQ, int8_t, HD>(a);
    case 3: return launch<TQ, Fp8, HD>(a);
    default: return -1;
  }
}

// f32 queries over any page type, or bf16 queries over f32 pages
template <int HD>
int by_q(int q_dtype, int kv_dtype, const Args& a) {
  if (q_dtype == 0) return by_kv<float, HD>(kv_dtype, a);
  if (q_dtype == 1 && kv_dtype == 0) return launch<Bf16, float, HD>(a);
  return -1;
}

}  // namespace scalar


}  // namespace

// dtype codes: q 0 = f32, 1 = bf16; pages 0 = f32, 1 = bf16, 2 = int8,
// 3 = fp8-e4m3 (2 and 3 need the scales). bf16 q over bf16 / int8 / fp8
// pages runs decode_kernel in n_splits splits of the window; n_splits > 1
// needs the f32 scratch o_part [n_splits, S, KH, H / KH, hd] and lse_part
// [n_splits, S, KH, H / KH] and launches the merge after the splits. f32 q
// or f32 pages run the CUDA-core kernel, at n_splits = 1. Returns
// cudaGetLastError() after the launches, or -1 for an unsupported
// combination.
extern "C" int paged_attention_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales,
    const void* lengths, const void* page_table, void* out,
    int S, int H, int KH, int N, int psz, int hd, int wp, int pt_stride,
    int q_dtype, int kv_dtype, int n_splits, void* o_part, void* lse_part, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > kMaxG || psz <= 0 || psz % 4 != 0) return -1;
  if ((kv_dtype >= 2) != (k_scales != nullptr && v_scales != nullptr)) return -1;
  if (n_splits < 1 || (n_splits > 1 && (o_part == nullptr || lse_part == nullptr))) return -1;
  if (hd != 64 && hd != 128) return -1;
  if (S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype != 1 || kv_dtype == 0) {  // f32 q or f32 pages
    if (n_splits != 1) return -1;
    scalar::Args a{q, k_pages, v_pages, k_scales, v_scales,
                   static_cast<const int*>(lengths), static_cast<const int*>(page_table), out,
                   S, H, KH, N, psz, wp, pt_stride, st};
    return hd == 64 ? scalar::by_q<64>(q_dtype, kv_dtype, a) : scalar::by_q<128>(q_dtype, kv_dtype, a);
  }
  // Q rows are read 16 bytes at a time, page rows by 16-byte cp.async
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pages) |
       reinterpret_cast<uintptr_t>(v_pages)) % 16 != 0)
    return -1;
  MArgs a{q, k_pages, v_pages, static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
          static_cast<const int*>(lengths), static_cast<const int*>(page_table), out,
          static_cast<float*>(o_part), static_cast<float*>(lse_part),
          S, H, KH, N, psz, wp, pt_stride, n_splits, st};
  return hd == 64 ? mma_by_kv<64>(kv_dtype, a) : mma_by_kv<128>(kv_dtype, a);
}

// decode_kernel's resources for (hd, kv_dtype 1 = bf16, 2 = int8, 3 =
// fp8): info[0] registers a thread, info[1] dynamic shared memory bytes,
// info[2] blocks an SM holds.
extern "C" int paged_attention_occupancy(int hd, int kv_dtype, int* info) {
  switch (hd) {
    case 64: return occupancy_by_kv<64>(kv_dtype, info);
    case 128: return occupancy_by_kv<128>(kv_dtype, info);
    default: return -1;
  }
}
