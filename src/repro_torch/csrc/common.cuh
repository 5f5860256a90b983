// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that takes raw
// pointers and a cudaStream_t, launches on that stream and returns
// cudaGetLastError() (0 = launched).  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// by repro_torch/kernels/build.py and loaded with ctypes.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr float E4M3_MAX = 448.f;
constexpr int TILE = 128;

// Exact po2 scale of a tile from its amax: the frexp recipe of
// repro_torch/core/fp8.py::po2_exponent.  r = amax / 448 in f32; the
// exponent comes from r's bits (e = k-1 when the mantissa field is 0,
// i.e. r is a power of two, else k = E-126), clamped to [-126, 126], and
// the scale is built as (e+127)<<23.  amax == 0, a subnormal amax (which
// XLA and the TPU flush to zero) or NaN gives 1.0, as the reference's
// where(amax > 0, s, 1).
__device__ __forceinline__ float po2_scale(float amax) {
  if (!(amax >= 1.17549435e-38f)) return 1.f;  // 2**-126
  const int bits = __float_as_int(__fdiv_rn(amax, E4M3_MAX));
  const int biased = (bits >> 23) & 0xff;
  int e = (bits & 0x7fffff) == 0 ? biased - 127 : biased - 126;
  e = min(max(e, -126), 126);
  return __int_as_float((e + 127) << 23);
}

// The linear scale of repro_torch/core/fp8.py::linear_scale: amax / 448
// correctly rounded (a subnormal result is kept: no FTZ); 1.0 where amax
// is 0, subnormal or NaN, as the reference's where(amax > 0, ., 1) under
// XLA's flush of subnormals.
__device__ __forceinline__ float linear_scale(float amax) {
  if (!(amax >= 1.17549435e-38f)) return 1.f;  // 2**-126
  return __fdiv_rn(amax, E4M3_MAX);
}

// Clip to +-448, then round to nearest even into e4m3 (NaN stays NaN:
// the comparisons are false for it, as torch.clamp keeps it).
__device__ __forceinline__ uint32_t to_e4m3(float v) {
  v = v > E4M3_MAX ? E4M3_MAX : (v < -E4M3_MAX ? -E4M3_MAX : v);
  return (uint32_t)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
}

// NaN-propagating max (torch.amax and jnp.max propagate NaN; fmaxf drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// The exact reciprocal of a po2 scale from po2_scale: a normal power of
// two in 2**+-126, so v * (1 / s) rounds the same real number as v / s,
// subnormal results included (no --use_fast_math, no FTZ).
__device__ __forceinline__ float po2_inverse(float sc) {
  return __uint_as_float((254u - (__float_as_uint(sc) >> 23)) << 23);
}

// Clip to +-448 (NaN stays NaN, as to_e4m3), then two RNE conversions in
// one instruction: a in the low byte, b in the high one.
__device__ __forceinline__ uint32_t to_e4m3x2(float a, float b) {
  a = a > E4M3_MAX ? E4M3_MAX : (a < -E4M3_MAX ? -E4M3_MAX : a);
  b = b > E4M3_MAX ? E4M3_MAX : (b < -E4M3_MAX ? -E4M3_MAX : b);
  return (uint32_t)__nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE,
                                            __NV_E4M3);
}

// silu(g) * u in f32: the fused SwiGLU of swiglu_quant.cu and of the
// SwiGLU GEMM-1 epilogue (grouped_gemm_swiglu_quant.cu), one function so
// the two agree bit for bit.  The sigmoid is 1 / (1 + exp(-g)) with every
// rounding explicit (no contraction into an fma, whatever the caller).
__device__ __forceinline__ float swiglu(float g, float u) {
  const float sg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
  return __fmul_rn(__fmul_rn(g, sg), u);
}

}  // namespace repro
