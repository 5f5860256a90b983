// Row-wise po2 FP8 quantize.
//
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_rowwise_pallas
// (pallas_call at quantize.py:54; body _quantize_kernel :37, scale
// kernel_po2_scale :19).  (M, K) bf16 or f32 -> (M, K) e4m3 payload +
// (M, K/128) f32 po2 scales, one per (row, 128-column tile).
//
// Bound on H100: bytes.  One read of x and one write of payload + scales;
// the amax, the exponent and the cast are a few integer and float ops per
// element.  Design: one warp per (row, tile); a lane loads 4 neighbouring
// values (8 bytes of bf16 / 16 bytes of f32, coalesced across the warp),
// the tile amax is a 5-step shuffle reduction, and each lane stores its 4
// payload bytes as one 32-bit word.  No shared memory and no second pass,
// so the kernel moves each byte once.  The TPU kernel's 128-row blocks and
// padded row counts are not needed: M is taken as it comes.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
quantize_rowwise_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
                        float* __restrict__ s, int M, int K) {
  const int tiles = K / repro::TILE;
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)M * tiles) return;  // warp-uniform exit
  const long row = warp / tiles, t = warp % tiles;
  const long base = row * K + t * repro::TILE + lane * 4;
  float v[4];
  repro::load4(x + base, v);
  repro::quantize_tile_store(v, q + base, s + row * tiles + t, lane);
}

}  // namespace

REPRO_EXPORT int repro_quantize_rowwise(const void* x, int x_is_bf16, void* q,
                                        void* s, int M, int K,
                                        void* stream) {
  const long warps = (long)M * (K / repro::TILE);
  const int threads = 256;
  const long blocks = (warps * 32 + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_bf16)
    quantize_rowwise_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (uint8_t*)q, (float*)s, M, K);
  else
    quantize_rowwise_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        (const float*)x, (uint8_t*)q, (float*)s, M, K);
  return (int)cudaGetLastError();
}
