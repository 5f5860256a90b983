// FP8 grouped GEMM with per-tile scaling.
//
// Replaces the TPU kernel
// repro/kernels/grouped_gemm_fp8.py::grouped_gemm_fp8_pallas (bf16-out form;
// pallas_call at grouped_gemm_fp8.py:135; body _gg_kernel :58).  For every
// expert e:
//   out[e] = sum over 128-wide K steps k of
//            (x[e, :, k] @ w[e, k, :]) * (sx[e, :, k] * sw[e, k, n-block])
//   x  (E, C, K) e4m3, sx (E, C, K/128) f32 row scales
//   w  (E, K, N) e4m3, sw (E, K/128, N/128) f32 block scales
//   out (E, C, N) bf16
// The partial of each K step is summed in f32 and promoted into the f32
// accumulator with its scales, as the reference does at
// grouped_gemm_fp8.py:71 (acc += partial * (sx * sw)).  Keep this per-step
// promotion in later designs: Hopper's FP8 MMA accumulator loses precision
// over a long K.
//
// Bound on H100: at the serving shapes, bytes.  Decode reads every
// expert's weights (K*N bytes each, 1.6 GB for GEMM-1 at full width) for a
// handful of rows; prefill at 128 rows per expert is also below the fp8
// ridge point.  This first design is simple and exact rather than fast:
// CUDA-core FFMA on operands converted to f32 in shared memory (no mma,
// wgmma or TMA yet).  A block computes a BM x 128 output tile of one
// expert; per K step it stages the BM x 128 x tile and the 128 x 128 w
// tile in shared memory as f32 (4-byte coalesced global loads, 16-byte
// conflict-free shared stores), every thread accumulates TM x 8 partials
// in registers (columns strided by 16 so shared reads are conflict-free
// or broadcast), then folds sx * sw into its accumulators.  Rows >= C are
// masked, so ragged row counts (decode's C = 8) need no padding: BM = 16
// serves C <= 16 and BM = 64 the rest.  What it leaves: tensor cores (the
// FFMA loop is shared-memory bound), double buffering of the tile loads,
// and the padded layout itself -- every expert's weights are read even
// when it has no live rows (the masked layout is the later fix).
#include "common.cuh"

namespace {

constexpr int BN = 128;
constexpr int BK = 128;            // == the scale tile
constexpr int THREADS = 256;
constexpr int XS = BK + 4;         // x tile row stride (floats): 16-byte
                                   // aligned, and rows 16 apart fall in
                                   // different banks

template <int BM>
constexpr size_t smem_bytes() {
  return (size_t)(BM * XS + BK * BN) * sizeof(float);
}

// Four e4m3 bytes of one 32-bit word -> four floats at dst (16-byte store).
__device__ __forceinline__ void unpack4(uint32_t w, float* dst) {
  float4 f;
  f.x = repro::e4m3_to_float(w);
  f.y = repro::e4m3_to_float(w >> 8);
  f.z = repro::e4m3_to_float(w >> 16);
  f.w = repro::e4m3_to_float(w >> 24);
  *reinterpret_cast<float4*>(dst) = f;
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_fp8_kernel(const uint8_t* __restrict__ x,
                        const float* __restrict__ sx,
                        const uint8_t* __restrict__ w,
                        const float* __restrict__ sw,
                        __nv_bfloat16* __restrict__ out, int C, int K, int N) {
  constexpr int TM = BM / 16, TN = BN / 16;
  extern __shared__ float smem[];
  float* xs = smem;                // BM x XS
  float* ws = smem + BM * XS;      // BK x BN
  const int e = blockIdx.z, m0 = blockIdx.y * BM, nblk = blockIdx.x;
  const int n0 = nblk * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nk = K / BK, nb = N / BN;
  const uint8_t* xe = x + (size_t)e * C * K;
  const float* sxe = sx + (size_t)e * C * nk;
  const uint8_t* we = w + (size_t)e * K * N;
  const float* swe = sw + (size_t)e * nk * nb;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < nk; ++kb) {
    __syncthreads();  // the previous step's reads are done
    // x tile: BM rows x 32 words; a warp covers one 128-byte row
    for (int c = tid; c < BM * 32; c += THREADS) {
      const int r = c / 32, col = (c % 32) * 4;
      const uint32_t v =
          (m0 + r < C)
              ? *reinterpret_cast<const uint32_t*>(
                    xe + (size_t)(m0 + r) * K + (size_t)kb * BK + col)
              : 0u;
      unpack4(v, xs + r * XS + col);
    }
    // w tile: 128 K-rows x 32 words
    for (int c = tid; c < BK * 32; c += THREADS) {
      const int r = c / 32, col = (c % 32) * 4;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          we + ((size_t)kb * BK + r) * N + n0 + col);
      unpack4(v, ws + r * BN + col);
    }
    __syncthreads();

    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[(ty + 16 * i) * XS + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
    const float swv = swe[(size_t)kb * nb + nblk];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty + 16 * i;
      const float f = (row < C ? sxe[(size_t)row * nk + kb] : 0.f) * swv;
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j] * f;
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= C) continue;
    __nv_bfloat16* o = out + ((size_t)e * C + row) * N + n0;
#pragma unroll
    for (int j = 0; j < TN; ++j) o[tx + 16 * j] = __float2bfloat16_rn(acc[i][j]);
  }
}

template <int BM>
int launch(const void* x, const void* sx, const void* w, const void* sw,
           void* out, int E, int C, int K, int N, cudaStream_t st) {
  const size_t smem = smem_bytes<BM>();
  cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm_fp8_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, (C + BM - 1) / BM, E);
  grouped_gemm_fp8_kernel<BM><<<grid, THREADS, smem, st>>>(
      (const uint8_t*)x, (const float*)sx, (const uint8_t*)w,
      (const float*)sw, (__nv_bfloat16*)out, C, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int repro_grouped_gemm_fp8(const void* x, const void* sx,
                                        const void* w, const void* sw,
                                        void* out, int E, int C, int K, int N,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C <= 16) return launch<16>(x, sx, w, sw, out, E, C, K, N, st);
  return launch<64>(x, sx, w, sw, out, E, C, K, N, st);
}
