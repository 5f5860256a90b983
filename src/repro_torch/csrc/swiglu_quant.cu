// Fused SwiGLU + row-wise po2 FP8 quantize.
//
// Replaces the TPU kernel
// repro/kernels/fused_swiglu_quant.py::fused_swiglu_quant_pallas
// (pallas_call at fused_swiglu_quant.py:47; body _swiglu_quant_kernel :27).
// h (M, 2F) bf16 = [gate | up] -> silu(gate) * up in f32 (no bf16 round,
// as the Pallas kernel) -> (M, F) e4m3 + (M, F/128) f32 po2 scales.
//
// Bound on H100: bytes.  h is read once (4 bytes per output element) and
// the payload written once (1 byte); the sigmoid is one expf and one
// division per element, far below the memory time.  Design: one warp per
// (row, 128-column output tile); a lane loads 4 gate and the 4 matching
// up values (two 8-byte loads), computes y in registers, and the tile is
// quantized with a shuffle amax as in quantize.cu.  The activation never
// reaches device memory in bf16, which is the fusion the paper measures.
// The SwiGLU is common.cuh's repro::swiglu, which the fused GEMM-1
// epilogue (grouped_gemm_swiglu_quant.cu) shares.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
swiglu_quant_kernel(const __nv_bfloat16* __restrict__ h,
                    uint8_t* __restrict__ q, float* __restrict__ s, int M,
                    int F) {
  const int tiles = F / repro::TILE;
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)M * tiles) return;  // warp-uniform exit
  const long row = warp / tiles, t = warp % tiles;
  const long col = t * repro::TILE + lane * 4;
  const __nv_bfloat16* hr = h + row * 2 * F;
  float g[4], u[4], y[4];
  repro::load4(hr + col, g);
  repro::load4(hr + F + col, u);
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = repro::swiglu(g[i], u[i]);
  repro::quantize_tile_store(y, q + row * F + col, s + row * tiles + t, lane);
}

}  // namespace

REPRO_EXPORT int repro_swiglu_quant(const void* h, void* q, void* s, int M,
                                    int F, void* stream) {
  const long warps = (long)M * (F / repro::TILE);
  const int threads = 256;
  const long blocks = (warps * 32 + threads - 1) / threads;
  swiglu_quant_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (uint8_t*)q, (float*)s, M, F);
  return (int)cudaGetLastError();
}
