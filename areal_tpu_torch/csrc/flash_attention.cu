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
// seg[j] == seg[i] and seg[i] != 0 (0 = padding). Softmax scale 1/sqrt(HD).
// Rows with no valid key (padding) output zeros and a logsumexp of 0; they
// take and give no gradient. The backward takes di = rowsum(dO * O) from the
// caller, as the JAX library computes it outside its kernels.
//
// What bounds it: the segment lengths decide. The forward does
// 2 * HD * H * sum(n^2) flops (q.k and p.v over each segment's causal pairs)
// on 8 * G * L * H * HD bytes (q, k, v, o in bf16): about n/4 flop/byte for
// rows filled with segments of n tokens. The H100 needs ~295 flop/byte
// (989 TFLOP/s bf16 over 3.35 TB/s), so segments shorter than ~1,200 tokens
// (the trainer's rollouts of a few hundred) are bound by the bytes, longer
// ones by the tensor cores. The backward is the same with 2.5x the flops of
// a fused backward (K3's four products and K4's three here, since each
// recomputes S and dP) on a few more bytes.
//
// The design (simple and correct first):
//   - tiles of 64 query rows x 64 key rows; every product (q.k^T, p.v,
//     do.v^T, p^T.do, ds^T.q, ds.k) runs on the tensor cores through WMMA
//     16x16x16 bf16 fragments with f32 accumulation, from shared memory;
//   - forward: one block per (query tile, head, grid row), 4 warps, warp w
//     owning query rows 16w..16w+15. A loop over KV tiles replaces the TPU's
//     sequential grid axis; the online softmax (running max and sum per row,
//     f32) and the f32 output accumulator live in shared memory, because a
//     WMMA accumulator's element-to-row map is unspecified and the rescale
//     is per row;
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
// What it does not do yet: TMA / cp.async double buffering of the tiles,
// wgmma, keeping S and P in registers (the accumulator's layout would have
// to be fixed by hand with mma.sync), or splitting long rows across blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kB = 64;         // rows per query tile and per key tile
constexpr int kFwdWarps = 4;   // forward: warp w owns query rows 16w..16w+15
constexpr int kBwdWarps = 8;   // backward
constexpr int kPadH = 8;       // bf16 row padding (elements): ldm % 8 == 0
constexpr int kPadF = 4;       // f32 row padding: ldm % 4 == 0
constexpr int kStageLd = 20;   // f32 staging tile [16][20] for the backward stores
constexpr unsigned kFull = 0xffffffffu;

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
  static constexpr size_t segq = l + sizeof(float) * kB;
  static constexpr size_t segk = segq + sizeof(int) * kB;
  static constexpr size_t ranges = segk + sizeof(int) * kB;
  static size_t bytes(int nt) { return ranges + sizeof(int) * 2 * nt; }
};

template <int HD>
__global__ void __launch_bounds__(kFwdWarps * 32) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, bf16* __restrict__ o, float* __restrict__ lse, int L, int H,
    float scale) {
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
  int* segq_s = reinterpret_cast<int*>(smem + SM::segq);
  int* segk_s = reinterpret_cast<int*>(smem + SM::segk);
  const int nt = (L + kB - 1) / kB;
  int* lo_s = reinterpret_cast<int*>(smem + SM::ranges);
  int* hi_s = lo_s + nt;

  const int qt = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rs = (size_t)H * HD;  // elements between consecutive rows of one head
  const size_t head0 = (size_t)g * L * rs + (size_t)h * HD;
  const int* segg = seg + (size_t)g * L;
  const int q0 = qt * kB;

  tile_segment_ranges(segg, L, nt, lo_s, hi_s, warp, lane, kFwdWarps);
  load_tile<HD>(q_s, q + head0, q0, L, rs, tid, kThreads);
  for (int r = tid; r < kB; r += kThreads) {
    segq_s[r] = q0 + r < L ? segg[q0 + r] : 0;
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < kB * LDO; i += kThreads) o_s[i] = 0.f;
  __syncthreads();

  const int qlo = lo_s[qt], qhi = hi_s[qt];
  const int r = 16 * warp + (lane >> 1);  // the row this lane pair owns
  const int half = lane & 1;              // which half of the row's columns
  const int qi = q0 + r;
  const int sq = segq_s[r];

  for (int kt = 0; kt <= qt; ++kt) {  // later tiles lie entirely in the future
    if (!ranges_meet(qlo, qhi, lo_s[kt], hi_s[kt])) continue;  // uniform in the block
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's k_s / v_s / segk_s are done with
    load_tile<HD>(k_s, k + head0, k0, L, rs, tid, kThreads);
    load_tile<HD>(v_s, v + head0, k0, L, rs, tid, kThreads);
    for (int j = tid; j < kB; j += kThreads) segk_s[j] = k0 + j < L ? segg[k0 + j] : 0;
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
      const int cc = half * 32 + c;
      const bool ok = sq != 0 && segk_s[cc] == sq && k0 + cc <= qi;
      sv[c] = ok ? s_s[r * LDS + cc] * scale : -INFINITY;
      mx = fmaxf(mx, sv[c]);
    }
    // the shuffle also orders every lane's reads of S before P overwrites it
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    float alpha = 1.f, psum = 0.f;
    if (m_new != -INFINITY) {
      alpha = __expf(m_old - m_new);  // 0 while the row had no valid key
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

  __syncwarp();
  if (qi < L) {
    const float lr = l_s[r];
    const float inv = lr > 0.f ? 1.f / lr : 0.f;  // padding rows: zeros
    bf16* orow = o + head0 + (size_t)qi * rs;
#pragma unroll 4
    for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); d += 2) {
      *reinterpret_cast<__nv_bfloat162*>(orow + d) =
          __floats2bfloat162_rn(o_s[r * LDO + d] * inv, o_s[r * LDO + d + 1] * inv);
    }
    if (lse != nullptr && half == 0) {
      lse[((size_t)g * L + qi) * H + h] = lr > 0.f ? m_s[r] + logf(lr) : 0.f;
    }
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

constexpr size_t kMaxSmem = 232448;  // per block on sm_90 (opt-in)

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
  const int nt = (L + kB - 1) / kB;
  const size_t bytes = FwdSmem<HD>::bytes(nt);
  int rc = set_smem(flash_fwd_kernel<HD>, bytes);
  if (rc != 0) return rc;
  dim3 grid(nt, H, G);
  flash_fwd_kernel<HD><<<grid, kFwdWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<bf16*>(o), static_cast<float*>(lse), L, H,
      softmax_scale(HD));
  return static_cast<int>(cudaGetLastError());
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
