// Register-fragment building blocks of the bf16 kernels: shared-memory
// addresses, ldmatrix (plain and transposed) and bf16 packing and
// splitting, sm_80 and later. flash_attention.cu and ssd.cu take them to
// move operands between shared memory and wgmma's register fragments,
// which have the layouts of mma.sync m16n8k16 below.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4), each
// register holding two bf16 with the lower column index in its low half:
//   A (16 x 16, row-major): a[0] (g, 2t..2t+1), a[1] (g + 8, 2t..),
//                           a[2] (g, 2t + 8..), a[3] (g + 8, 2t + 8..);
//   B (16 x 8, k x n):      b[0] (k 2t..2t+1, n g), b[1] (k 2t + 8.., n g);
//   C (16 x 8, float32):    c[0..1] (g, 2t..2t+1), c[2..3] (g + 8, 2t..).
// So the C fragments of two neighbouring n-blocks are, rounded to bf16,
// the A fragment of the next product over those 16 columns.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, which lands in r[i].
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Two floats rounded to bf16 in one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a float32 or bf16 value to float32 and back (rounded to nearest), for
// kernels templated on their element type
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// v = hi + lo with hi = bf16(v) and lo = bf16(v - hi): a float32 operand
// as two bf16 passes through the tensor cores, exact to ~2^-17 relative.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}
