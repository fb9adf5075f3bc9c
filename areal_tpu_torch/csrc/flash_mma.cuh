// The mma.sync flash-loop building blocks shared by the attention kernels
// (#1 decode, #3 suffix, K2-K4 flash, #4-#6 tree) and gmm: the tile
// constants, the cp.async copies, ldmatrix, the m16n8k16 bf16 MMA, exp2 on
// the SFU, bf16 packing and the exact int8 / fp8 -> bf16 conversions
// (moved verbatim from paged_suffix_attention.cu), then the backward's tile
// products (moved verbatim from flash_attention.cu).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kT = 64;        // query rows per block, keys per tile
constexpr int kWarps = 4;     // warp w owns query rows 16w..16w+15
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 row padding (elements): 16 bytes
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kDequant = 1.f / 127.5f;  // int8 / fp8: x * scale / 127.5

// storage tag for the fp8 page type
struct Fp8 { uint8_t bits; };

__device__ __forceinline__ bf16 to_bf16(int8_t x) { return __float2bfloat16(static_cast<float>(x)); }
__device__ __forceinline__ bf16 to_bf16(Fp8 x) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(x.bits), __NV_E4M3);
  return __float2bfloat16(__half2float(__half(h)));
}

template <typename T> struct IsQuant { static constexpr bool value = true; };
template <> struct IsQuant<bf16> { static constexpr bool value = false; };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `valid` false reads nothing and
// fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (flushes denormal results to 0; exp2(-inf) = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 one-byte page values -> 8 bf16
template <typename T>
__device__ __forceinline__ uint4 widen8(uint2 raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
  uint4 out;
  bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = to_bf16(e[i]);
  return out;
}

// ---------------------------------------------------------------------------
// The flash loops' tile products (K3 / K4 in flash_attention.cu, #4-#6 in
// tree_attention.cu): 64-row tiles of HD + kPad bf16, 4 warps of 16 rows.
// ---------------------------------------------------------------------------

// rows r0 .. r0 + 63 of one head of a [G, L, H, HD] tensor -> a padded
// [64][HD + kPad] shared tile by cp.async; rows past L are zero-filled, not
// read. `head0` is the offset of (g, 0, h, 0), `rs` the elements between rows.
template <int HD>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* __restrict__ src, size_t head0, size_t rs,
                                          int r0, int L, int tid) {
  constexpr int kChunks = HD / 8, LDH = HD + kPad;
  static_assert(kT * kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < kT * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads, rr = c / kChunks, ch = c % kChunks, l = r0 + rr;
    const bool ok = l < L;
    cp_async16(dst + rr * LDH + ch * 8, src + (ok ? head0 + (size_t)l * rs + ch * 8 : 0), ok);
  }
}

// acc[16 x 64] = A[16 x HD] B^T, A this warp's fragments from registers or a
// padded shared tile (16 rows from `a_s`), B the 64 rows of a padded shared
// tile: the S = Q K^T pattern of K2 (K read by ldmatrix, not transposed).
template <int HD>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (*a_reg)[4], const bf16* a_s,
                                        const bf16* b_s, int lane) {
  constexpr int LDH = HD + kPad;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    if (a_reg != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_reg[kk][i];
    } else {
      ldsm_x4(a, a_s + (lane & 15) * LDH + 16 * kk + (lane >> 4) * 8);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, b_s + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * LDH + 16 * kk + ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * jj], a, b[0], b[1]);
      mma16816(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x HD] += A B, A the bf16 fragments of 16 rows x 16 of the 64 tile
// rows (slice kk), B rows 16 kk .. 16 kk + 15 of a padded shared tile read
// by ldmatrix.trans: the O += P V pattern of K2.
template <int HD>
__device__ __forceinline__ void mma_ab(float (&acc)[HD / 8][4], const uint32_t (&a)[4], const bf16* b_s, int kk,
                                       int lane) {
  constexpr int LDH = HD + kPad;
#pragma unroll
  for (int dd = 0; dd < HD / 16; ++dd) {
    uint32_t b[4];
    ldsm_x4_t(b, b_s + (16 * kk + (lane & 15)) * LDH + 16 * dd + (lane >> 4) * 8);
    mma16816(acc[2 * dd], a, b[0], b[1]);
    mma16816(acc[2 * dd + 1], a, b[2], b[3]);
  }
}

// this thread's rows (gq, gq + 8 of its warp's 16) of a [16 x HD] f32
// accumulator, times `mul`, as bf16 rows of one head; rows past L skipped
template <int HD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[HD / 8][4], const int (&row)[2],
                                           size_t head0, size_t rs, int L, float mul, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= L) continue;
    bf16* out = dst + head0 + (size_t)row[r] * rs;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n + 2 * tq) =
          __floats2bfloat162_rn(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
  }
}

}  // namespace
