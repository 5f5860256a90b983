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
// tile loop of gemm_tile.cuh that the unfused GEMM runs.  Per K step the x
// tile is staged once and the w tile twice (gate, then up, in the same
// shared buffer).  The epilogue rounds both to bf16 as the unfused GEMM
// stores h, applies common.cuh's repro::swiglu (the function the unfused
// swiglu_quant.cu applies) and quantizes each row's 128 values with the
// half-warp amax of the quantizing GEMM epilogue.  So this kernel equals
// grouped_gemm_fp8 (bf16 out) followed by swiglu_quant bit for bit, and
// h never reaches device memory.  A block in a dead 128-row group (it
// starts at or beyond masked_m[e], read from device memory) skips the K
// loop and writes payload 0 and scale 1.0, what the unfused pair writes
// for zero rows; live groups compute every row, as the reference's
// tile-granular masking does.
//
// Bound on H100: bytes at the serving and training shapes, as for the
// grouped GEMM: the live experts' w13 (K * 2F bytes each, 1.6 GB with all
// 128 live at full width) for 8-256 rows an expert; the output is a
// quarter of the unfused pair's (e4m3 F wide against bf16 2F wide written
// and read back).  This first design is the CUDA-core FFMA loop of the
// unfused GEMM (no tensor cores, TMA or double buffering yet); its shared
// memory is the unfused kernel's (one x tile, one w tile), but the two
// accumulators take it to 178 registers a thread at BM = 64 (ptxas; the
// unfused GEMM: 128), so one block runs on an SM where the unfused GEMM
// runs two.
#include "gemm_tile.cuh"

namespace {

using namespace repro::gemm;

template <int BM>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_swiglu_quant_kernel(const uint8_t* __restrict__ x,
                                 const float* __restrict__ sx,
                                 const uint8_t* __restrict__ w13,
                                 const float* __restrict__ sw13,
                                 const int* __restrict__ masked_m,
                                 uint8_t* __restrict__ q,
                                 float* __restrict__ s, int C, int K, int F) {
  constexpr int TM = BM / 16;
  extern __shared__ float smem[];
  float* xs = smem;                // BM x XS
  float* ws = smem + BM * XS;      // BK x BN
  const int e = blockIdx.z, m0 = blockIdx.y * BM, nblk = blockIdx.x;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nf = F / BN;           // output column tiles = scale columns
  if (group_dead(masked_m, e, m0)) {  // block-uniform exit
    write_dead_tile<BM>(q, 1, s, e, m0, C, F, nblk * BN, nblk, tid);
    return;
  }
  const int N = 2 * F, nk = K / BK, nb = N / BN;
  const int n_gate = nblk * BN, n_up = F + nblk * BN;
  const uint8_t* xe = x + (size_t)e * C * K;
  const float* sxe = sx + (size_t)e * C * nk;
  const uint8_t* we = w13 + (size_t)e * K * N;
  const float* swe = sw13 + (size_t)e * nk * nb;

  float accg[TM][TN], accu[TM][TN], part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accg[i][j] = accu[i][j] = 0.f;

  for (int kb = 0; kb < nk; ++kb) {
    __syncthreads();  // the previous step's reads are done
    stage_x<BM>(xe, m0, C, K, kb, xs, tid);
    stage_w<false>(we, K, N, n_gate, kb, ws, tid);
    __syncthreads();
    tile_product<BM, false>(xs, ws, tx, ty, part);
    promote<BM>(accg, part, sxe, m0, C, nk, kb,
                swe[(size_t)kb * nb + nblk], ty);
    __syncthreads();  // the gate tile's reads are done
    stage_w<false>(we, K, N, n_up, kb, ws, tid);
    __syncthreads();
    tile_product<BM, false>(xs, ws, tx, ty, part);
    promote<BM>(accu, part, sxe, m0, C, nk, kb,
                swe[(size_t)kb * nb + nf + nblk], ty);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    float y[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      // the bf16 island: h as the unfused GEMM stores it
      const float g = __bfloat162float(__float2bfloat16_rn(accg[i][j]));
      const float u = __bfloat162float(__float2bfloat16_rn(accu[i][j]));
      y[j] = repro::swiglu(g, u);
    }
    quantize_row_store(y, row < C, q + ((size_t)e * C + row) * F + nblk * BN,
                       s + ((size_t)e * C + row) * nf + nblk, tx);
  }
}

template <int BM>
int launch(const void* x, const void* sx, const void* w13, const void* sw13,
           const void* masked_m, void* q, void* s, int E, int C, int K, int F,
           cudaStream_t st) {
  const size_t smem = smem_bytes<BM, false>();
  auto kern = grouped_gemm_swiglu_quant_kernel<BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(F / BN, (C + BM - 1) / BM, E);
  kern<<<grid, THREADS, smem, st>>>((const uint8_t*)x, (const float*)sx,
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
  if (C <= 16)
    return launch<16>(x, sx, w13, sw13, masked_m, q, s, E, C, K, F, st);
  return launch<64>(x, sx, w13, sw13, masked_m, q, s, E, C, K, F, st);
}
