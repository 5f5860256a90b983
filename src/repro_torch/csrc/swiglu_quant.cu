// Fused SwiGLU + row-wise po2 FP8 quantize.
//
// Replaces the TPU kernel
// repro/kernels/fused_swiglu_quant.py::fused_swiglu_quant_pallas
// (pallas_call at fused_swiglu_quant.py:47; body _swiglu_quant_kernel :27).
// h (M, 2F) bf16 = [gate | up] -> silu(gate) * up in f32 (no bf16 round,
// as the Pallas kernel) -> (M, F) e4m3 + (M, F/128) f32 po2 scales.
//
// Bound on H100: bytes (4 read and ~1.03 written a value), with the
// instruction issue close behind: the sigmoid is an expf and an IEEE
// division a value, ~49 SASS instructions a value in all, so the issue
// time is near the byte time at every shape (chip_smoke.py counts the
// loop's SASS and prints the estimate beside the bound).  The first
// design (one warp a (row, tile), two 8-byte loads a lane, then the
// dependent chain of the sigmoid, a shuffle amax and four divisions)
// reached 0.41-0.55 of the bound.  This one: a lane holds 8 neighbouring
// values of a tile, 16 lanes a tile, so a warp takes two neighbouring
// tiles of the flat walk of the M * F / 128 output tiles (tile f is row
// f / (F/128), column tile f % (F/128): its gate at h + 128 f + F row,
// its up F further, its payload at 128 f, its scale at f); each lane makes
// one 16-byte load of gate and one of up.  Keeping the work a warp small
// keeps 64 warps (32 registers) on a SM, which hides the sigmoid's latency
// best: a persistent grid, 2-8 tile pairs a warp pass and loads issued a
// pass ahead were all no faster on the card.  The amax is an integer max
// of y's bits with the sign cleared over the tile's 16 lanes (NaN's bits
// exceed every number's, so a NaN gives scale 1.0 through po2_scale); the
// payload is y times the scale's exact reciprocal, clipped and converted
// two values an instruction; each lane stores 8 bytes.  No fast math
// (--use_fast_math, __expf, __fdividef): it changes bits.  The SwiGLU is
// common.cuh's repro::swiglu, which the fused GEMM-1 epilogue
// (grouped_gemm_swiglu_quant.cu) shares, so that kernel equals GEMM-1
// then this one bit for bit.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILES = THREADS / 16;  // tiles a block

// The f32 value of bf16 number i of the 8 a lane holds (exact: a bf16's
// bits are the f32's top half).
__device__ __forceinline__ float bf16_at(const uint4& v, int i) {
  const uint32_t w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

__global__ void __launch_bounds__(THREADS)
swiglu_quant_kernel(const __nv_bfloat16* __restrict__ h,
                    uint8_t* __restrict__ q, float* __restrict__ s,
                    int ntiles, int tiles_per_row) {
  const int sub = threadIdx.x & 15;
  const int tile = blockIdx.x * TILES + (threadIdx.x >> 4);
  // a half-warp past the last tile computes on zeros (its lanes take part
  // in the shuffles) and stores nothing
  uint4 g = make_uint4(0u, 0u, 0u, 0u), u = g;
  if (tile < ntiles) {
    const int row = (int)((unsigned)tile / (unsigned)tiles_per_row);
    const __nv_bfloat16* gp =
        h + ((long)tile + (long)row * tiles_per_row) * repro::TILE + sub * 8;
    g = *reinterpret_cast<const uint4*>(gp);
    u = *reinterpret_cast<const uint4*>(gp + (long)tiles_per_row *
                                                 repro::TILE);
  }
  float y[8];
  uint32_t m = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    y[i] = repro::swiglu(bf16_at(g, i), bf16_at(u, i));
    m = max(m, __float_as_uint(y[i]) & 0x7fffffffu);
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float sc = repro::po2_scale(__uint_as_float(m));
  const float inv = repro::po2_inverse(sc);
  uint32_t pk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    pk[i] = repro::to_e4m3x2(__fmul_rn(y[2 * i], inv),
                             __fmul_rn(y[2 * i + 1], inv));
  if (tile < ntiles) {
    *reinterpret_cast<uint2*>(q + (long)tile * repro::TILE + sub * 8) =
        make_uint2(pk[0] | pk[1] << 16, pk[2] | pk[3] << 16);
    if (sub == 0) s[tile] = sc;
  }
}

}  // namespace

REPRO_EXPORT int repro_swiglu_quant(const void* h, void* q, void* s, int M,
                                    int F, void* stream) {
  const int tiles_per_row = F / repro::TILE;
  const long ntiles = (long)M * tiles_per_row;
  if (ntiles == 0) return 0;
  if (ntiles > INT_MAX - TILES) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((ntiles + TILES - 1) / TILES);
  swiglu_quant_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (uint8_t*)q, (float*)s, (int)ntiles,
      tiles_per_row);
  return (int)cudaGetLastError();
}
