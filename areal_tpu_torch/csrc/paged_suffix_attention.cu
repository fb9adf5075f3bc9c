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
// The design (simple and correct first, the shape of K2 in
// flash_attention.cu):
//   - one block per (tile of 64 query rows, KV head, slot), 4 warps, warp w
//     owning rows 16w..16w+15 of the tile; the TPU put all B * G rows of a
//     cell in one VMEM block, which does not fit a block here at B = 256;
//   - a loop over 64-token prefix tiles (only the first ceil(len / 64); the
//     page table is read per token row, so any page size works), then over
//     64-key suffix tiles, skipping a suffix tile no row of the block
//     attends; every tile lands in shared memory as bf16 and both products
//     run on the tensor cores (WMMA 16x16x16, f32 accumulation);
//   - int8 / fp8 values convert to bf16 exactly (7-bit integers, 3-bit
//     mantissas) and the scales apply in f32: the K scale to each column of
//     S, the V scale to P before P rounds to bf16; so the products see the
//     stored values, not rounded dequantized ones;
//   - the online softmax (running max and sum per row, f32) and the f32
//     output accumulator live in shared memory, as in K2.
// What it does not do yet: split a long prefix across blocks (verify runs
// S * KH = 64 blocks on 132 SMs and the longest prefix sets the time),
// reuse a prefix tile across row tiles of one cell (warm prefill reads the
// prefix once per 64 rows, from L2), prefetch with cp.async / TMA, wgmma.
//
// q must be bf16; the suffix K/V bf16; pages bf16, int8 or fp8.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kT = 64;        // query rows per block, keys per tile
constexpr int kWarps = 4;     // warp w owns query rows 16w..16w+15
constexpr int kThreads = kWarps * 32;
constexpr int kPadH = 8;      // bf16 row padding (elements): ldm % 8 == 0
constexpr int kPadF = 4;      // f32 row padding: ldm % 4 == 0
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragARow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// storage tags for the 1-byte page types
struct Fp8 { uint8_t bits; };

__device__ __forceinline__ bf16 to_bf16(int8_t x) { return __float2bfloat16(static_cast<float>(x)); }
__device__ __forceinline__ bf16 to_bf16(Fp8 x) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(x.bits), __NV_E4M3);
  return __float2bfloat16(__half2float(__half(h)));
}

template <typename T> struct IsQuant { static constexpr bool value = true; };
template <> struct IsQuant<bf16> { static constexpr bool value = false; };

__host__ __device__ constexpr size_t align32(size_t n) { return (n + 31) / 32 * 32; }

template <int HD>
struct Smem {
  static constexpr int LDH = HD + kPadH;  // q / k / v tiles (bf16)
  static constexpr int LDS = kT + kPadF;  // S (f32)
  static constexpr int LDP = 2 * LDS;     // P (bf16) written over S's rows
  static constexpr int LDO = HD + kPadF;  // O accumulator (f32)
  static constexpr size_t q = 0;
  static constexpr size_t k = align32(q + sizeof(bf16) * kT * LDH);
  static constexpr size_t v = align32(k + sizeof(bf16) * kT * LDH);
  static constexpr size_t s = align32(v + sizeof(bf16) * kT * LDH);
  static constexpr size_t o = align32(s + sizeof(float) * kT * LDS);
  static constexpr size_t m = align32(o + sizeof(float) * kT * LDO);
  static constexpr size_t l = m + sizeof(float) * kT;
  static constexpr size_t ksc = l + sizeof(float) * kT;   // per key column: K scale / 127.5
  static constexpr size_t vsc = ksc + sizeof(float) * kT; // per key column: V scale / 127.5
  static constexpr size_t bytes = vsc + sizeof(float) * kT;
};

// One 8-element chunk of a page row into a bf16 tile row.
__device__ __forceinline__ uint4 load8(const bf16* src) {
  return *reinterpret_cast<const uint4*>(src);
}
template <typename T>
__device__ __forceinline__ uint4 load8(const T* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);  // 8 one-byte values
  const T* e = reinterpret_cast<const T*>(&raw);
  uint4 out;
  bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = to_bf16(e[i]);
  return out;
}

// S[rows of this warp][64] = Q K^T from the tiles in shared memory.
template <int HD>
__device__ __forceinline__ void qk_tile(const bf16* q_s, const bf16* k_s, float* s_s, int warp) {
  constexpr int LDH = Smem<HD>::LDH, LDS = Smem<HD>::LDS;
#pragma unroll
  for (int j = 0; j < kT / 16; ++j) {
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
}

// O[rows of this warp] += P V.
template <int HD>
__device__ __forceinline__ void pv_tile(const bf16* p_s, const bf16* v_s, float* o_s, int warp) {
  constexpr int LDH = Smem<HD>::LDH, LDP = Smem<HD>::LDP, LDO = Smem<HD>::LDO;
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    FragC acc;
    wmma::load_matrix_sync(acc, o_s + 16 * warp * LDO + 16 * j, LDO, wmma::mem_row_major);
#pragma unroll
    for (int s = 0; s < kT / 16; ++s) {
      FragARow a;
      FragBRow b;
      wmma::load_matrix_sync(a, p_s + 16 * warp * LDP + 16 * s, LDP);
      wmma::load_matrix_sync(b, v_s + 16 * s * LDH + 16 * j, LDH);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o_s + 16 * warp * LDO + 16 * j, acc, LDO, wmma::mem_row_major);
  }
}

// Online softmax of row r over the tile's 64 columns, two lanes per row
// (lane `half` takes columns 32*half .. 32*half+31). `bits` holds this
// lane's 32 column-validity bits. Writes P (times the V scale) over S's
// rows as bf16 and rescales the row's accumulator.
template <int HD>
__device__ __forceinline__ void softmax_tile(unsigned char* smem, int r, int half, uint32_t bits,
                                             float scale) {
  typedef Smem<HD> SM;
  constexpr int LDS = SM::LDS, LDP = SM::LDP, LDO = SM::LDO;
  float* s_s = reinterpret_cast<float*>(smem + SM::s);
  bf16* p_s = reinterpret_cast<bf16*>(smem + SM::s);
  float* o_s = reinterpret_cast<float*>(smem + SM::o);
  float* m_s = reinterpret_cast<float*>(smem + SM::m);
  float* l_s = reinterpret_cast<float*>(smem + SM::l);
  const float* ksc_s = reinterpret_cast<const float*>(smem + SM::ksc);
  const float* vsc_s = reinterpret_cast<const float*>(smem + SM::vsc);
  float sv[32];
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int cc = half * 32 + c;
    sv[c] = (bits >> c) & 1u ? s_s[r * LDS + cc] * ksc_s[cc] * scale : -INFINITY;
    mx = fmaxf(mx, sv[c]);
  }
  // the shuffle also orders both lanes' reads of S before P overwrites it
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
  const float m_old = m_s[r];
  const float m_new = fmaxf(m_old, mx);
  float alpha = 1.f, psum = 0.f;
  if (m_new != -INFINITY) {
    alpha = __expf(m_old - m_new);  // 0 while the row had no valid key
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int cc = half * 32 + c;
      const float p = __expf(sv[c] - m_new);  // masked: exp(-inf) = 0
      psum += p;
      p_s[r * LDP + cc] = __float2bfloat16(p * vsc_s[cc]);
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
}

template <int HD, typename TKV>
__global__ void __launch_bounds__(kThreads) suffix_kernel(
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
    bf16* __restrict__ out,              // [S, B, H, HD]
    int B, int H, int KH, int N, int psz, int wp, int pt_stride, int layer, float scale) {
  typedef Smem<HD> SM;
  constexpr int LDH = SM::LDH;
  constexpr int kChunks = HD / 8;  // 8-element chunks per row
  constexpr bool kScaled = IsQuant<TKV>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + SM::q);
  bf16* k_s = reinterpret_cast<bf16*>(smem + SM::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + SM::v);
  float* s_s = reinterpret_cast<float*>(smem + SM::s);
  const bf16* p_s = reinterpret_cast<const bf16*>(smem + SM::s);
  float* o_s = reinterpret_cast<float*>(smem + SM::o);
  float* m_s = reinterpret_cast<float*>(smem + SM::m);
  float* l_s = reinterpret_cast<float*>(smem + SM::l);
  float* ksc_s = reinterpret_cast<float*>(smem + SM::ksc);
  float* vsc_s = reinterpret_cast<float*>(smem + SM::vsc);

  const int rt = blockIdx.x, kh = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = H / KH, BG = B * G;
  const int r = 16 * warp + (lane >> 1);  // the query row this lane pair owns
  const int half = lane & 1;
  const int rho = rt * kT + r;            // its row in the (slot, KV head) cell
  const int i_row = rho < BG ? rho / G : -1;  // its suffix row
  const uint8_t* mrow = mask + ((size_t)s * B + (i_row < 0 ? 0 : i_row)) * B;
  const bool row_valid = i_row >= 0 && mrow[i_row] != 0;  // the diagonal gate

  // the query tile (rows past B * G are zeros and never stored)
  for (int c = tid; c < kT * kChunks; c += kThreads) {
    const int rr = c / kChunks, col = (c % kChunks) * 8;
    const int rh = rt * kT + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rh < BG) {
      const int i = rh / G, g = rh % G;
      val = load8(q + (((size_t)s * B + i) * H + (size_t)kh * G + g) * HD + col);
    }
    *reinterpret_cast<uint4*>(q_s + rr * LDH + col) = val;
  }
  for (int c = tid; c < kT * (HD + kPadF); c += kThreads) o_s[c] = 0.f;
  if (tid < kT) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // (a) the cached prefix, only when some row of the block attends it
  int limit = min(prefix_lens[s], wp * psz);
  if (!__syncthreads_or(row_valid)) limit = 0;
  const size_t plane = ((size_t)layer * KH + kh) * N;  // pages before this (layer, head)
  const int* pt = page_table + (size_t)s * pt_stride;
  for (int t0 = 0; t0 < limit; t0 += kT) {
    __syncthreads();  // the previous tile's k_s / v_s / scales are done with
    for (int c = tid; c < kT * kChunks; c += kThreads) {
      const int rr = c / kChunks, col = (c % kChunks) * 8;
      const int t = t0 + rr;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (t < limit) {  // rows past the prefix stay zero: never read
        const size_t row = (plane + __ldg(pt + t / psz)) * psz + t % psz;
        kv = load8(k_pages + row * HD + col);
        vv = load8(v_pages + row * HD + col);
      }
      *reinterpret_cast<uint4*>(k_s + rr * LDH + col) = kv;
      *reinterpret_cast<uint4*>(v_s + rr * LDH + col) = vv;
    }
    if (tid < kT) {
      const int t = t0 + tid;
      float ks = 1.f, vs = 1.f;
      if (kScaled && t < limit) {
        const size_t row = (plane + __ldg(pt + t / psz)) * psz + t % psz;
        ks = __ldg(k_scales + row) * (1.f / 127.5f);
        vs = __ldg(v_scales + row) * (1.f / 127.5f);
      }
      ksc_s[tid] = ks;
      vsc_s[tid] = vs;
    }
    __syncthreads();
    qk_tile<HD>(q_s, k_s, s_s, warp);
    __syncwarp();
    uint32_t bits = 0u;
    if (row_valid) {
      const int n = limit - t0 - half * 32;  // valid columns of this lane's half
      bits = n >= 32 ? kFull : (n > 0 ? (1u << n) - 1u : 0u);
    }
    softmax_tile<HD>(smem, r, half, bits, scale);
    __syncwarp();
    pv_tile<HD>(p_s, v_s, o_s, warp);
    __syncwarp();
  }

  // (b) the in-flight suffix under the mask
  for (int j0 = 0; j0 < B; j0 += kT) {
    uint32_t bits = 0u;
    if (i_row >= 0) {
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const int j = j0 + half * 32 + c;
        if (j < B && mrow[j]) bits |= 1u << c;
      }
    }
    // also the barrier before k_s / v_s are overwritten
    if (!__syncthreads_or(bits != 0u)) continue;
    for (int c = tid; c < kT * kChunks; c += kThreads) {
      const int rr = c / kChunks, col = (c % kChunks) * 8;
      const int j = j0 + rr;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (j < B) {
        const size_t row = ((size_t)s * B + j) * KH + kh;
        kv = load8(k_sfx + row * HD + col);
        vv = load8(v_sfx + row * HD + col);
      }
      *reinterpret_cast<uint4*>(k_s + rr * LDH + col) = kv;
      *reinterpret_cast<uint4*>(v_s + rr * LDH + col) = vv;
    }
    if (tid < kT) {
      ksc_s[tid] = 1.f;
      vsc_s[tid] = 1.f;
    }
    __syncthreads();
    qk_tile<HD>(q_s, k_s, s_s, warp);
    __syncwarp();
    softmax_tile<HD>(smem, r, half, bits, scale);
    __syncwarp();
    pv_tile<HD>(p_s, v_s, o_s, warp);
    __syncwarp();
  }

  __syncwarp();
  if (i_row >= 0) {
    constexpr int LDO = SM::LDO;
    const int g = rho % G;
    const float lr = l_s[r];
    const float inv = lr > 0.f ? 1.f / lr : 0.f;  // no valid bit: exact zeros
    bf16* orow = out + (((size_t)s * B + i_row) * H + (size_t)kh * G + g) * HD;
#pragma unroll 4
    for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); d += 2) {
      *reinterpret_cast<__nv_bfloat162*>(orow + d) =
          __floats2bfloat162_rn(o_s[r * LDO + d] * inv, o_s[r * LDO + d + 1] * inv);
    }
  }
}

struct Args {
  const void* q; const void* ks; const void* vs; const void* kp; const void* vp;
  const float* ksc; const float* vsc; const int* plens; const int* pt; const uint8_t* mask;
  void* out;
  int S, B, H, KH, N, psz, wp, pt_stride, layer;
  cudaStream_t stream;
};

template <int HD, typename TKV>
int launch(const Args& a) {
  const size_t bytes = Smem<HD>::bytes;
  static_assert(Smem<HD>::bytes <= kMaxSmem, "shared memory");
  int rc = static_cast<int>(cudaFuncSetAttribute(
      suffix_kernel<HD, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
  if (rc != 0) return rc;
  const int G = a.H / a.KH;
  dim3 grid((a.B * G + kT - 1) / kT, a.KH, a.S);
  suffix_kernel<HD, TKV><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.ks),
      static_cast<const bf16*>(a.vs), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.ksc, a.vsc, a.plens, a.pt, a.mask,
      static_cast<bf16*>(a.out), a.B, a.H, a.KH, a.N, a.psz, a.wp, a.pt_stride, a.layer,
      static_cast<float>(1.0 / sqrt(static_cast<double>(HD))));
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

// q [S, B, H, hd], k_suffix / v_suffix [S, B, KH, hd]: contiguous bf16.
// k_pages / v_pages: contiguous [L, KH, N, psz, hd]; kv_dtype 1 = bf16,
// 2 = int8, 3 = fp8-e4m3 (2 and 3 need the contiguous f32 scales
// [L, KH, N, psz, 1]). prefix_lens [S] int32, page_table [S, pt_stride]
// int32 (first wp columns used), suffix_mask [S, B, B] one byte each,
// out [S, B, H, hd] bf16. Returns cudaGetLastError() after the launch, or -1
// for an unsupported combination.
extern "C" int paged_suffix_attention(
    const void* q, const void* k_suffix, const void* v_suffix, const void* k_pages,
    const void* v_pages, const void* k_scales, const void* v_scales, const void* prefix_lens,
    const void* page_table, const void* suffix_mask, void* out, int S, int B, int H, int KH,
    int N, int psz, int hd, int wp, int pt_stride, int layer, int kv_dtype, void* stream) {
  if (KH <= 0 || H % KH != 0 || psz <= 0 || S < 0 || B < 0 || S > 65535 || KH > 65535) return -1;
  if ((kv_dtype >= 2) != (k_scales != nullptr && v_scales != nullptr)) return -1;
  if (S == 0 || B == 0) return 0;
  Args a{q, k_suffix, v_suffix, k_pages, v_pages,
         static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
         static_cast<const int*>(prefix_lens), static_cast<const int*>(page_table),
         static_cast<const uint8_t*>(suffix_mask), out,
         S, B, H, KH, N, psz, wp, pt_stride, layer, static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 64: return by_kv<64>(kv_dtype, a);
    case 128: return by_kv<128>(kv_dtype, a);
    default: return -1;
  }
}
