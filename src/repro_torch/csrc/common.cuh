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

// Clip to +-448, then round to nearest even into e4m3 (NaN stays NaN:
// the comparisons are false for it, as torch.clamp keeps it).
__device__ __forceinline__ uint32_t to_e4m3(float v) {
  v = v > E4M3_MAX ? E4M3_MAX : (v < -E4M3_MAX ? -E4M3_MAX : v);
  return (uint32_t)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
}

__device__ __forceinline__ float e4m3_to_float(uint32_t byte) {
  const __half_raw hr =
      __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)(byte & 0xff), __NV_E4M3);
  return __half2float(__half(hr));
}

// NaN-propagating max (torch.amax and jnp.max propagate NaN; fmaxf drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float warp_amax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

// silu(g) * u in f32: the fused SwiGLU of swiglu_quant.cu and of the
// SwiGLU GEMM-1 epilogue (grouped_gemm_swiglu_quant.cu), one function so
// the two agree bit for bit.  The sigmoid is 1 / (1 + exp(-g)) with every
// rounding explicit (no contraction into an fma, whatever the caller).
__device__ __forceinline__ float swiglu(float g, float u) {
  const float sg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
  return __fmul_rn(__fmul_rn(g, sg), u);
}

// Four e4m3 bytes of one 32-bit word -> four floats at dst (16-byte store).
__device__ __forceinline__ void unpack4(uint32_t w, float* dst) {
  float4 f;
  f.x = e4m3_to_float(w);
  f.y = e4m3_to_float(w >> 8);
  f.z = e4m3_to_float(w >> 16);
  f.w = e4m3_to_float(w >> 24);
  *reinterpret_cast<float4*>(dst) = f;
}

// Row stride (floats) of a 128 x 128 tile staged transposed: odd, so the
// staging stores and the GEMM inner loop's reads are free of bank conflicts.
constexpr int TILE_T_STRIDE = TILE + 1;

// Stage the 128 x 128 e4m3 tile at src (128 rows n, each 128 bytes
// contiguous in k, rows ld bytes apart) into dst as f32, n-major with row
// stride TILE_T_STRIDE: dst[n * TILE_T_STRIDE + k].  For a block of 256
// threads: a warp loads 4 rows x 8 words (whole 32-byte sectors) and
// stores them to banks (n + 4 * kw + q) mod 32, all distinct.
__device__ __forceinline__ void stage_tile_n_major(const uint8_t* src,
                                                   size_t ld, float* dst,
                                                   int tid) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll 4
  for (int it = 0; it < TILE * 32 / 256; ++it) {
    const int g = warp + 8 * it;
    const int r = (g % 32) * 4 + (lane & 3);
    const int kw = (g / 32) * 8 + (lane >> 2);
    const uint32_t v =
        *reinterpret_cast<const uint32_t*>(src + (size_t)r * ld + kw * 4);
    float* d = dst + r * TILE_T_STRIDE + kw * 4;
    d[0] = e4m3_to_float(v);
    d[1] = e4m3_to_float(v >> 8);
    d[2] = e4m3_to_float(v >> 16);
    d[3] = e4m3_to_float(v >> 24);
  }
}

// Quantize the 128-wide tile a warp holds (4 values a lane, lane-major):
// warp amax -> po2 scale -> e4m3 payload.  Writes the lane's 4 bytes and,
// from lane 0, the tile's scale.
__device__ __forceinline__ void quantize_tile_store(const float v[4],
                                                    uint8_t* q, float* s,
                                                    int lane) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) amax = nan_max(amax, fabsf(v[i]));
  const float sc = po2_scale(warp_amax(amax));
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) packed |= to_e4m3(__fdiv_rn(v[i], sc)) << (8 * i);
  *reinterpret_cast<uint32_t*>(q) = packed;
  if (lane == 0) *s = sc;
}

}  // namespace repro
