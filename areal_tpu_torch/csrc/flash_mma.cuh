// The mma.sync flash-loop building blocks shared by the paged attention
// kernels (#1 decode, #3 suffix): the tile constants, the cp.async copies,
// ldmatrix, the m16n8k16 bf16 MMA, exp2 on the SFU, bf16 packing and the
// exact int8 / fp8 -> bf16 conversions. Moved verbatim from
// paged_suffix_attention.cu.

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

}  // namespace
