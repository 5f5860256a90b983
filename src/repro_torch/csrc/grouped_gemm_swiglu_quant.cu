// Masked FP8 grouped GEMM-1 with the SwiGLU + row-wise e4m3 quantize fused
// into its epilogue (the paper's §3.3.2 fusion taken into the GEMM).
//
// Replaces the TPU kernel
// repro/kernels/grouped_gemm_fp8.py::masked_grouped_gemm_swiglu_quant_pallas
// (pallas_call at grouped_gemm_fp8.py:360; body
// _gg_masked_swiglu_quant_kernel :219).  For every expert e:
//   x    (E, C, K) e4m3, sx (E, C, K/128) f32 row scales
//   w13  (E, K, 2F) e4m3 = [gate | up], sw13 (E, K/128, 2F/128) f32 block
//        scales
//   masked_m (E,) int32 on the device: the live rows of each expert
//   out  q (E, C, F) e4m3 + s (E, C, F/128) f32 po2 scales of
//        silu(g) * u, where g and u are GEMM-1's gate and up columns,
//        each accumulated in f32 and rounded to bf16 (the paper's bf16
//        island, which lives only in registers here)
// A block computes output column tile n for BM rows with two f32
// accumulators, one for the gate columns n*128.. (w13 column tile n) and
// one for the up columns F + n*128.. (tile F/128 + n), each through the
// tile loop of gemm_tile.cuh that the unfused GEMM runs: per K step the x
// tile and both w tiles arrive through the cp.async ring, both w tiles
// are widened to f16 in shared memory, and each is multiplied by the same
// eight f16 wgmma instructions and promoted as the unfused GEMM's column
// tile is, gate first, then up through the same partial registers.  The
// epilogue rounds both to bf16 as the unfused GEMM stores h, applies
// common.cuh's repro::swiglu (the function the unfused swiglu_quant.cu
// applies) and quantizes each row's 128 values with the quad-of-lanes
// amax of the quantizing GEMM epilogue.  So this kernel equals
// grouped_gemm_fp8 (bf16 out) followed by swiglu_quant bit for bit, and h
// never reaches device memory.  A block in a dead 128-row group (it
// starts at or beyond masked_m[e], read from device memory) skips the K
// loop and writes payload 0 and scale 1.0, what the unfused pair writes
// for zero rows; live groups compute every row, as the reference's
// tile-granular masking does.
//
// Bound on H100: bytes at the serving and training shapes, as for the
// grouped GEMM: the live experts' w13 (K * 2F bytes each, 1.6 GB with all
// 128 live at full width) for 8-256 rows an expert; the output is a
// quarter of the unfused pair's (e4m3 F wide against bf16 2F wide written
// and read back).  Two accumulators and the partial are 192 registers of
// a thread's fragment (ptxas: ~240 a thread, no spills), and the two
// weight tiles with their f16 copies fill the shared memory, so a block
// runs alone on its SM and widens, then multiplies (no double buffer).
#include "gemm_tile.cuh"

namespace {

using namespace repro::gemm;

template <int BM>
__global__ void __launch_bounds__(2 * BM, 1)
grouped_gemm_swiglu_quant_kernel(const uint8_t* __restrict__ x,
                                 const float* __restrict__ sx,
                                 const uint8_t* __restrict__ w13,
                                 const float* __restrict__ sw13,
                                 const int* __restrict__ masked_m,
                                 uint8_t* __restrict__ q,
                                 float* __restrict__ s, int C, int K, int F) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int e = blockIdx.z, m0 = blockIdx.y * BM, nblk = blockIdx.x;
  const int tid = threadIdx.x;
  const int nf = F / BN;           // output column tiles = scale columns
  if (group_dead(masked_m, e, m0)) {  // block-uniform exit
    write_dead_tile<BM>(q, 1, s, e, m0, C, F, nblk * BN, nblk, tid);
    return;
  }
  const int N = 2 * F, nk = K / BK;
  const int cols[2] = {nblk, nf + nblk};  // gate, up
  float acc[2][64];
  mainloop<BM, false, 2>(x + (size_t)e * C * K, sx + (size_t)e * C * nk,
                         w13 + (size_t)e * K * N,
                         sw13 + (size_t)e * nk * (N / BN), m0, C, K, N, cols,
                         smem, acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    // the bf16 island: h as the unfused GEMM stores it
    const float g = __bfloat162float(__float2bfloat16_rn(acc[0][i]));
    const float u = __bfloat162float(__float2bfloat16_rn(acc[1][i]));
    acc[0][i] = repro::swiglu(g, u);
  }
  quantize_rows_store(acc[0], q + (size_t)e * C * F, s + (size_t)e * C * nf,
                      m0 + frag_row(tid), C, F, nblk, tid & 31);
}

template <int BM>
int launch(const void* x, const void* sx, const void* w13, const void* sw13,
           const void* masked_m, void* q, void* s, int E, int C, int K, int F,
           cudaStream_t st) {
  const size_t smem = smem_bytes<BM, false, 2>();
  auto kern = grouped_gemm_swiglu_quant_kernel<BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(F / BN, (C + BM - 1) / BM, E);
  kern<<<grid, 2 * BM, smem, st>>>((const uint8_t*)x, (const float*)sx,
                                   (const uint8_t*)w13, (const float*)sw13,
                                   (const int*)masked_m, (uint8_t*)q,
                                   (float*)s, C, K, F);
  return (int)cudaGetLastError();
}

}  // namespace

// w13 is stored (E, K, 2F) with sw13 (E, K/128, 2F/128); masked_m is (E,)
// int32 on the device; q (E, C, F) e4m3 and s (E, C, F/128) f32 are written.
REPRO_EXPORT int repro_grouped_gemm_swiglu_quant(const void* x, const void* sx,
                                                 const void* w13,
                                                 const void* sw13,
                                                 const void* masked_m,
                                                 void* q, void* s, int E,
                                                 int C, int K, int F,
                                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!aligned16(x, w13)) return (int)cudaErrorMisalignedAddress;
  if (block_rows(C) == 64)
    return launch<64>(x, sx, w13, sw13, masked_m, q, s, E, C, K, F, st);
  return launch<128>(x, sx, w13, sw13, masked_m, q, s, E, C, K, F, st);
}
