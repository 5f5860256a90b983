// FP8 grouped GEMM, NT layout (the Wgrad form).
//
// Replaces the TPU kernel
// repro/kernels/grouped_gemm_nt_fp8.py::grouped_gemm_nt_fp8_pallas
// (pallas_call at grouped_gemm_nt_fp8.py:67; body _gg_nt_kernel :39).  For
// every expert e, with the contraction over the LAST axis of both operands:
//   out[e] = sum over 128-wide C steps k of
//            (a[e, :, k] @ b[e, :, k]^T) * (sa[e, :, k] (x) sb[e, :, k])
//   a  (E, M, C) e4m3, sa (E, M, C/128) f32 row scales
//   b  (E, N, C) e4m3, sb (E, N, C/128) f32 row scales
//   out (E, M, N) f32 or bf16 (a launch argument)
// These are the layouts the scaling-aware transpose produces: Wgrad takes
// T(activation) and T(gradient), both row-tiled over the token axis.  The
// partial of each C step is promoted with the outer product of the two
// scale columns, sa[m] * sb[n] per element, then added to the f32
// accumulator (the reference's acc += partial * (sa * sb.T)).  A bf16
// output is one rounding of that f32 sum, bitwise the reference's f32
// output followed by .astype(bf16).
//
// Bound on H100: bytes, by a small margin.  Wgrad at the training shapes
// (E = 128 experts, C = 256 tokens an expert, M x N = 4096 x 3072 or
// 1536 x 4096) is a long product over a short contraction: 825 / 412 GFLOP
// (0.42 / 0.21 ms at the fp8 peak) against 0.2 / 0.2 GB of operands and a
// 3.2 / 1.6 GB bf16 output (1.03 / 0.54 ms at 3.35 TB/s); an f32 output
// would double the bound.  This first design is the
// CUDA-core FFMA engine of grouped_gemm_fp8.cu: a block computes a 64 x 128
// output tile of one expert, stages each 128-deep step of both operands in
// shared memory as f32, and every thread accumulates 4 x 8 partials in
// registers.  Both operands are contraction-contiguous, so the b tile is
// kept n-major with an odd row stride (129 floats): the inner loop reads
// b[n = tx + 16j][k] without bank conflicts, and the staging stores (a warp
// loads 4 rows x 8 words, whole 32-byte sectors) hit 32 distinct banks.
// What it leaves: tensor cores (wgmma takes K-major fp8 operands, which is
// what both operands already are), TMA and double buffering.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 128;            // == the scale tile
constexpr int THREADS = 256;
static_assert(THREADS == 256, "stage_tile_n_major is written for 256 threads");
constexpr int AS = BK + 4;         // a tile row stride (floats), 16-byte aligned
constexpr int BS = repro::TILE_T_STRIDE;  // b tile row stride
constexpr size_t SMEM = (size_t)(BM * AS + BN * BS) * sizeof(float);

template <bool BF16_OUT>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_nt_fp8_kernel(const uint8_t* __restrict__ a,
                           const float* __restrict__ sa,
                           const uint8_t* __restrict__ b,
                           const float* __restrict__ sb,
                           void* __restrict__ out, int M, int N, int C) {
  constexpr int TM = BM / 16, TN = BN / 16;
  extern __shared__ float smem[];
  float* as = smem;                // BM x AS, k contiguous
  float* bs = smem + BM * AS;      // BN x BS, k contiguous
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nk = C / BK;
  const uint8_t* ae = a + (size_t)e * M * C;
  const float* sae = sa + (size_t)e * M * nk;
  const uint8_t* be = b + (size_t)e * N * C;
  const float* sbe = sb + (size_t)e * N * nk;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < nk; ++kb) {
    __syncthreads();  // the previous step's reads are done
    // a tile: BM rows x 32 words; a warp covers one 128-byte row
    for (int c = tid; c < BM * 32; c += THREADS) {
      const int r = c / 32, col = (c % 32) * 4;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          ae + (size_t)(m0 + r) * C + (size_t)kb * BK + col);
      repro::unpack4(v, as + r * AS + col);
    }
    // b tile: BN rows (k contiguous), staged n-major
    repro::stage_tile_n_major(be + (size_t)n0 * C + (size_t)kb * BK, C, bs,
                              tid);
    __syncthreads();

    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[(ty + 16 * i) * AS + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[(tx + 16 * j) * BS + k];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
    float sbv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) sbv[j] = sbe[(size_t)(n0 + tx + 16 * j) * nk + kb];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float sav = sae[(size_t)(m0 + ty + 16 * i) * nk + kb];
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j] * (sav * sbv[j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const size_t row = (size_t)e * M + m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const size_t idx = row * N + n0 + tx + 16 * j;
      if (BF16_OUT)
        reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(acc[i][j]);
      else
        reinterpret_cast<float*>(out)[idx] = acc[i][j];
    }
  }
}

template <bool BF16_OUT>
int launch(const void* a, const void* sa, const void* b, const void* sb,
           void* out, int E, int M, int N, int C, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm_nt_fp8_kernel<BF16_OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, M / BM, E);
  grouped_gemm_nt_fp8_kernel<BF16_OUT><<<grid, THREADS, SMEM, st>>>(
      (const uint8_t*)a, (const float*)sa, (const uint8_t*)b,
      (const float*)sb, out, M, N, C);
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int repro_grouped_gemm_nt_fp8(const void* a, const void* sa,
                                           const void* b, const void* sb,
                                           void* out, int out_bf16, int E,
                                           int M, int N, int C,
                                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16) return launch<true>(a, sa, b, sb, out, E, M, N, C, st);
  return launch<false>(a, sa, b, sb, out, E, M, N, C, st);
}
