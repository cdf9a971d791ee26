// Shared device helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>

// Diagonal offsets travel by value as a kernel parameter (constant bank);
// settings.dia_max_diags caps D at 32.
#define STK_MAX_DIAGS 32
struct StkOffsets {
  long long o[STK_MAX_DIAGS];
};

// Explicitly rounded multiply / add / subtract: no FMA contraction, so the
// kernels' elementwise results equal the plain torch versions bit for bit.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

static inline int stk_copy_offsets(StkOffsets* dst, const long long* src, int D) {
  if (D < 1 || D > STK_MAX_DIAGS) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < D; ++k) dst->o[k] = src[k];
  return 0;
}
