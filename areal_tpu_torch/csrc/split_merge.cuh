// The split-KV merge shared by the paged attention kernels: #3 (suffix
// rows, B a slot) and #1 (decode, B = 1, where the row map (slot, KV head,
// g) -> out[slot, KV head * G + g] is the decode output's layout). Moved
// verbatim from paged_suffix_attention.cu.

#pragma once

#include "flash_mma.cuh"

namespace {

// Merge P splits of rows (slot, KV head, i * G + g) into bf16
// out[slot, i, KV head * G + g]: weights exp(lse_p - max lse), in split
// order, no atomics. A split with lse = -inf is skipped (its O is never
// read); a row with no finite lse gets exact zeros. HD / 4 threads a row.
template <int HD>
__global__ void __launch_bounds__(kThreads) merge_kernel(
    const float* __restrict__ o_part,    // [P, rows, HD]
    const float* __restrict__ lse_part,  // [P, rows]
    bf16* __restrict__ out, int rows, int B, int G, int KH, int n_splits) {
  constexpr int kLanes = HD / 4;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = gid / kLanes, d = (gid % kLanes) * 4;
  if (r >= rows) return;
  const int BG = B * G;
  const int rho = r % BG, sk = r / BG;
  const int kh = sk % KH, s = sk / KH;
  const int i = rho / G, g = rho % G;
  float mx = -INFINITY;
  for (int p = 0; p < n_splits; ++p) mx = fmaxf(mx, lse_part[(size_t)p * rows + r]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float wsum = 0.f;
  if (mx > -INFINITY) {
    for (int p = 0; p < n_splits; ++p) {
      const float lp = lse_part[(size_t)p * rows + r];
      if (!(lp > -INFINITY)) continue;
      const float w = __expf(lp - mx);
      const float4 v = *reinterpret_cast<const float4*>(o_part + ((size_t)p * rows + r) * HD + d);
      wsum += w;
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
  }
  const float inv = wsum > 0.f ? 1.f / wsum : 0.f;
  bf16* orow = out + (((size_t)s * B + i) * (KH * G) + (size_t)kh * G + g) * HD + d;
  reinterpret_cast<__nv_bfloat162*>(orow)[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  reinterpret_cast<__nv_bfloat162*>(orow)[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
}

}  // namespace
