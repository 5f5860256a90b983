// Row-wise FP8 quantize, po2 or linear scales.
//
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_rowwise_pallas
// (pallas_call at quantize.py:54; body _quantize_kernel :37, scale
// kernel_po2_scale :19).  (M, K) bf16 or f32 -> (M, K) e4m3 payload +
// (M, K/128) f32 scales, one per (row, 128-column tile).  LINEAR selects
// the conventional recipe's scale s = amax / 448 (the blockwise and
// naive_fp8 baselines), which the reference computes with XLA ops
// (repro/core/quant.py:321-346): its Pallas kernel has po2 scales only.
//
// Bound on H100: bytes.  One read of x and one write of payload + scales;
// the amax, the exponent and the cast are a few integer and float ops per
// element.  The first design (one warp a (row, tile), 8 bytes a lane, then
// a dependent chain of shuffles, the scale and four divisions) kept too
// few bytes in flight and ran at under half the memory rate.  This one:
// a contiguous (M, K) tensor is a flat run of M * K / 128 tiles, tile f at
// elements 128 f.., scale f.  A persistent grid, sized from the SM count,
// strides over passes of 8 tiles a warp: a lane holds 8 neighbouring
// values of a tile (16 lanes a tile) and starts its 4 loads of 16 bytes
// (bf16; two of them for f32), for 4 tile pairs, before it reduces any.
// Below 2**14 tiles (serve decode and prefill) the launch is latency, not
// bytes, and a pass is one tile pair, so each warp's chain is short.
// The amax is an integer max of the values' bits with the sign cleared
// (two bf16 at a time), over the 16 lanes of a tile: a NaN's bits exceed
// every number's, so NaN propagates as in the reference's max.  The
// payload is x times the exact reciprocal of the po2 scale (a normal power
// of two for scales in 2**+-126, so x * (1 / s) rounds the same real
// number as x / s, subnormal results included: no --use_fast_math, no
// FTZ), clipped to +-448 and converted two values at a time; each lane
// stores its 8 bytes, so a warp writes 256 contiguous bytes a store.
// The linear mode walks the same tiles; its scale is not a power of two,
// so a reciprocal would round twice: s = amax / 448 and every x / s are
// IEEE divisions (__fdiv_rn: no --use_fast_math, no FTZ), as the plain
// twin's f32 divisions.  Those divisions cost issue slots, not bytes.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// The 8 neighbouring values a lane holds, as raw bits.
template <typename T>
struct Vals;

template <>
struct Vals<__nv_bfloat16> {
  uint32_t w[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
  __device__ __forceinline__ void zero() { w[0] = w[1] = w[2] = w[3] = 0u; }
  // the f32 bits of max |v| (a bf16's are its own, shifted)
  __device__ __forceinline__ uint32_t amax_bits() const {
    uint32_t m = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) m = __vmaxu2(m, w[i] & 0x7fff7fffu);
    return max(m & 0xffffu, m >> 16) << 16;
  }
  __device__ __forceinline__ float get(int i) const {
    const uint32_t b = w[i >> 1];
    return __uint_as_float((i & 1) ? (b & 0xffff0000u) : (b << 16));
  }
};

template <>
struct Vals<float> {
  uint32_t w[8];
  __device__ __forceinline__ void load(const float* p) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint4 b = *reinterpret_cast<const uint4*>(p + 4);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ uint32_t amax_bits() const {
    uint32_t m = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) m = max(m, w[i] & 0x7fffffffu);
    return m;
  }
  __device__ __forceinline__ float get(int i) const {
    return __uint_as_float(w[i]);
  }
};

// UNITS: loads in flight a lane, for 2 * UNITS tiles a warp pass.
template <typename T, int UNITS, bool LINEAR>
__global__ void __launch_bounds__(THREADS)
quantize_rowwise_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
                        float* __restrict__ s, long ntiles) {
  constexpr int PASS_TILES = 2 * UNITS;
  const int lane = threadIdx.x & 31, half = lane >> 4, sub = lane & 15;
  const long warps = (long)gridDim.x * WARPS;
  const long passes = (ntiles + PASS_TILES - 1) / PASS_TILES;
  for (long p = (long)blockIdx.x * WARPS + (threadIdx.x >> 5); p < passes;
       p += warps) {
    Vals<T> v[UNITS];
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const long tile = p * PASS_TILES + 2 * u + half;
      if (tile < ntiles) v[u].load(x + tile * repro::TILE + sub * 8);
      else v[u].zero();
    }
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const long tile = p * PASS_TILES + 2 * u + half;
      uint32_t m = v[u].amax_bits();
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
      uint32_t pk[4];
      float sc;
      if (LINEAR) {
        sc = repro::linear_scale(__uint_as_float(m));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pk[i] = repro::to_e4m3x2(__fdiv_rn(v[u].get(2 * i), sc),
                                   __fdiv_rn(v[u].get(2 * i + 1), sc));
      } else {
        sc = repro::po2_scale(__uint_as_float(m));
        const float inv = repro::po2_inverse(sc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pk[i] = repro::to_e4m3x2(__fmul_rn(v[u].get(2 * i), inv),
                                   __fmul_rn(v[u].get(2 * i + 1), inv));
      }
      if (tile < ntiles) {
        *reinterpret_cast<uint2*>(q + tile * repro::TILE + sub * 8) =
            make_uint2(pk[0] | pk[1] << 16, pk[2] | pk[3] << 16);
        if (sub == 0) s[tile] = sc;
      }
    }
  }
}

template <typename T, int UNITS, bool LINEAR>
int launch(const void* x, void* q, void* s, long ntiles, cudaStream_t st) {
  auto kern = quantize_rowwise_kernel<T, UNITS, LINEAR>;
  static int sms[64], per_sm[64];  // by device, filled at first use
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    int n = 0, b = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kern, THREADS,
                                                          0);
    if (err != cudaSuccess) return (int)err;
    per_sm[dev] = b > 0 ? b : 1;
    sms[dev] = n;
  }
  const long passes = (ntiles + 2 * UNITS - 1) / (2 * UNITS);
  const long need = (passes + WARPS - 1) / WARPS;
  const long fit = (long)sms[dev] * per_sm[dev];
  const int grid = (int)(need < fit ? need : fit);
  kern<<<grid, THREADS, 0, st>>>((const T*)x, (uint8_t*)q, (float*)s, ntiles);
  return (int)cudaGetLastError();
}

// One load a lane below 2**14 tiles; four from there on (the 2048-token
// entry quantize is 65,536 tiles).
template <typename T, bool LINEAR>
int launch(const void* x, void* q, void* s, long ntiles, cudaStream_t st) {
  if (ntiles < (1L << 14)) return launch<T, 1, LINEAR>(x, q, s, ntiles, st);
  return launch<T, 4, LINEAR>(x, q, s, ntiles, st);
}

template <bool LINEAR>
int launch(const void* x, int x_is_bf16, void* q, void* s, long ntiles,
           cudaStream_t st) {
  if (x_is_bf16) return launch<__nv_bfloat16, LINEAR>(x, q, s, ntiles, st);
  return launch<float, LINEAR>(x, q, s, ntiles, st);
}

}  // namespace

REPRO_EXPORT int repro_quantize_rowwise(const void* x, int x_is_bf16,
                                        int linear, void* q, void* s, int M,
                                        int K, void* stream) {
  const long ntiles = (long)M * (K / repro::TILE);
  if (ntiles == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (linear) return launch<true>(x, x_is_bf16, q, s, ntiles, st);
  return launch<false>(x, x_is_bf16, q, s, ntiles, st);
}
