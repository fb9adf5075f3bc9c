// Paged decode attention for Hopper (sm_90a), called through ctypes.
//
// Replaces the TPU kernel areal_tpu/ops/paged_attention_q8.py:
// paged_attention_stacked (bodies _stacked_kernel / _stacked_kernel_noscale,
// around jax's paged_flash_attention_kernel_inline_seq_dim). It computes
// the same function: q_len = 1 grouped-query attention for S slots over
// their page tables, masked to lengths[s], reading one layer of the stacked
// KV cache in place. bf16 / f32 pages are read as they are; int8 and
// fp8-e4m3 pages are dequantized on load as x * scale / 127.5 with one f32
// scale per token vector (the narrow [..., psz, 1] scales).
//
// What bounds it: device-memory bytes. Each slot reads
// len[s] * KH * hd * 2 (K and V) elements of the page dtype (plus 2 * 4 bytes
// of scales per row when quantized) and does ~4 * G flops per element read,
// far below the ~295 flop/byte the H100 needs before arithmetic limits, so
// the bound is sum(len) * KH * hd * 2 * bytes_per_element / 3.35 TB/s.
//
// The design (simple and correct first):
//   - one thread block per (slot, KV head), 8 warps;
//   - the G = H / KH query rows of the head live in registers as f32,
//     pre-scaled by 1/sqrt(hd); each lane holds a contiguous hd/32 slice;
//   - the block walks only the first ceil(len / psz) entries of its page
//     table. The rows are dealt to the warps 4 at a time (page_size must be
//     a multiple of 4, so 4 rows share one page-table lookup); a warp loads
//     its 4 K and V rows together (8 loads in flight per lane), converts
//     them to f32 once, reduces the q.k dots across its lanes, and keeps its
//     own online softmax (running max, sum and f32 accumulator per head);
//   - at the end the 8 warps' partial results merge through shared memory.
// What it does not do yet: split the KV length across blocks
// (flash-decoding) — with S * KH blocks it fills only part of the 132 SMs
// at small batch, and the longest slot sets the time; prefetch pages with
// cp.async / TMA; use tensor cores for q.k and p.v.
//
// lengths[s] == 0 writes zeros. Rows at or past lengths[s] (and past
// wp * psz) are masked out; the last chunk may read up to 3 such rows of
// its own page.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

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

template <int HD>
int by_q(int q_dtype, int kv_dtype, const Args& a) {
  switch (q_dtype) {
    case 0: return by_kv<float, HD>(kv_dtype, a);
    case 1: return by_kv<Bf16, HD>(kv_dtype, a);
    default: return -1;
  }
}

}  // namespace

// dtype codes: q 0 = f32, 1 = bf16; pages 0 = f32, 1 = bf16, 2 = int8,
// 3 = fp8-e4m3 (2 and 3 need the scales). Returns cudaGetLastError() after
// the launch, or -1 for an unsupported combination.
extern "C" int paged_attention_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales,
    const void* lengths, const void* page_table, void* out,
    int S, int H, int KH, int N, int psz, int hd, int wp, int pt_stride,
    int q_dtype, int kv_dtype, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > kMaxG || psz % kRows != 0) return -1;
  if ((kv_dtype >= 2) != (k_scales != nullptr && v_scales != nullptr)) return -1;
  if (S == 0) return 0;
  Args a{q, k_pages, v_pages, k_scales, v_scales,
         static_cast<const int*>(lengths), static_cast<const int*>(page_table), out,
         S, H, KH, N, psz, wp, pt_stride, static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 64: return by_q<64>(q_dtype, kv_dtype, a);
    case 128: return by_q<128>(q_dtype, kv_dtype, a);
    default: return -1;
  }
}
