// FP8 grouped GEMM with per-tile scaling: bf16 out, or FP8 out through a
// quantizing epilogue; the weight read as stored or transposed.
//
// Replaces the TPU kernel
// repro/kernels/grouped_gemm_fp8.py::grouped_gemm_fp8_pallas in both forms:
// bf16 out (pallas_call at grouped_gemm_fp8.py:135; body _gg_kernel :58)
// and quant_out=True (pallas_call at :147; body _gg_quant_kernel :87,
// epilogue _quant_epilogue :78).  For every expert e:
//   out[e] = sum over 128-wide K steps k of
//            (x[e, :, k] @ w[e, k, :]) * (sx[e, :, k] * sw[e, k, n-block])
//   x  (E, C, K) e4m3, sx (E, C, K/128) f32 row scales
//   w  (E, K, N) e4m3, sw (E, K/128, N/128) f32 block scales, or with
//      W_TRANS the stored (E, N, K) / (E, N/128, K/128) read as its
//      transpose (the Dgrad GEMMs' w^T: the reference's _block_t relabel)
//   out (E, C, N) bf16, or with QUANT_OUT (E, C, N) e4m3 + (E, C, N/128)
//      po2 scales quantized from the f32 accumulator (the Pallas epilogue;
//      the reference's XLA route rounds to bf16 first)
// The partial of each K step is summed in f32 and promoted into the f32
// accumulator with its scales, as the reference does at
// grouped_gemm_fp8.py:71 (acc += partial * (sx * sw)).  Keep this per-step
// promotion in later designs: Hopper's FP8 MMA accumulator loses precision
// over a long K.
//
// Bound on H100: at the serving shapes, bytes.  Decode reads every
// expert's weights (K*N bytes each, 1.6 GB for GEMM-1 at full width) for a
// handful of rows; prefill at 128 rows per expert and the training GEMMs at
// 256 are also at or below the fp8 ridge point.  This first design is
// simple and exact rather than fast: CUDA-core FFMA on operands converted
// to f32 in shared memory (no mma, wgmma or TMA yet).  A block computes a
// BM x 128 output tile of one expert; per K step it stages the BM x 128 x
// tile and the 128 x 128 w tile in shared memory as f32, every thread
// accumulates TM x 8 partials in registers (columns strided by 16 so
// shared reads are conflict-free or broadcast), then folds sx * sw into
// its accumulators.  Rows >= C are masked, so ragged row counts (decode's
// C = 8) need no padding: BM = 16 serves C <= 16 and BM = 64 the rest.
//
// W_TRANS reads the stored weight rows (n, contiguous in k) with whole
// 32-byte sectors and transposes the tile on its way into shared memory,
// keeping it n-major with an odd row stride (129 floats) so the staging
// stores and the inner loop's reads are free of bank conflicts.  The
// alternative, a physical transpose of the weight each step, would move
// 2.4 GB of payload and hold 1.6 GB of transient memory at full width.
//
// QUANT_OUT: BN = 128 = TILE, so one output row of a block tile is one
// quantization group, and its 128 values sit in the 16 lanes of a
// half-warp (tid % 16 holds columns tx + 16j, tid / 16 holds rows): the
// row amax is four __shfl_xor_sync steps, the scale is the bit-built po2
// recipe of the quantize kernel (common.cuh), then acc / s, clip +-448 and
// a saturating RNE cast.
//
// What it leaves: tensor cores (the FFMA loop is shared-memory bound),
// double buffering of the tile loads, and the padded layout itself --
// every expert's weights are read even when it has no live rows (the
// masked layout is the later fix).
#include "common.cuh"

namespace {

constexpr int BN = 128;
constexpr int BK = 128;            // == the scale tile
constexpr int THREADS = 256;
static_assert(THREADS == 256, "stage_tile_n_major is written for 256 threads");
constexpr int XS = BK + 4;         // x tile row stride (floats): 16-byte
                                   // aligned, and rows 16 apart fall in
                                   // different banks
constexpr int WTS = repro::TILE_T_STRIDE;  // W_TRANS w tile row stride

template <int BM, bool W_TRANS>
constexpr size_t smem_bytes() {
  return (size_t)(BM * XS + (W_TRANS ? BN * WTS : BK * BN)) * sizeof(float);
}

template <int BM, bool W_TRANS, bool QUANT_OUT>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_fp8_kernel(const uint8_t* __restrict__ x,
                        const float* __restrict__ sx,
                        const uint8_t* __restrict__ w,
                        const float* __restrict__ sw,
                        void* __restrict__ out, float* __restrict__ sout,
                        int C, int K, int N) {
  constexpr int TM = BM / 16, TN = BN / 16;
  extern __shared__ float smem[];
  float* xs = smem;                // BM x XS
  float* ws = smem + BM * XS;      // BK x BN, or (W_TRANS) BN x WTS
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
      repro::unpack4(v, xs + r * XS + col);
    }
    if (W_TRANS) {
      // stored rows n (k contiguous), staged n-major
      repro::stage_tile_n_major(we + (size_t)n0 * K + (size_t)kb * BK, K, ws,
                                tid);
    } else {
      // w tile: 128 K-rows x 32 words
      for (int c = tid; c < BK * 32; c += THREADS) {
        const int r = c / 32, col = (c % 32) * 4;
        const uint32_t v = *reinterpret_cast<const uint32_t*>(
            we + ((size_t)kb * BK + r) * N + n0 + col);
        repro::unpack4(v, ws + r * BN + col);
      }
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
      for (int j = 0; j < TN; ++j)
        b[j] = W_TRANS ? ws[(tx + 16 * j) * WTS + k] : ws[k * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
    const float swv = W_TRANS ? swe[(size_t)nblk * nk + kb]
                              : swe[(size_t)kb * nb + nblk];
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
    if (QUANT_OUT) {
      // the row's 128 values sit in this half-warp: amax over 16 lanes
      float amax = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) amax = repro::nan_max(amax, fabsf(acc[i][j]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        amax = repro::nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (row >= C) continue;
      const float s = repro::po2_scale(amax);
      uint8_t* q = reinterpret_cast<uint8_t*>(out) + ((size_t)e * C + row) * N + n0;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        q[tx + 16 * j] = (uint8_t)repro::to_e4m3(__fdiv_rn(acc[i][j], s));
      if (tx == 0) sout[((size_t)e * C + row) * nb + nblk] = s;
    } else {
      if (row >= C) continue;
      __nv_bfloat16* o =
          reinterpret_cast<__nv_bfloat16*>(out) + ((size_t)e * C + row) * N + n0;
#pragma unroll
      for (int j = 0; j < TN; ++j) o[tx + 16 * j] = __float2bfloat16_rn(acc[i][j]);
    }
  }
}

template <int BM, bool W_TRANS, bool QUANT_OUT>
int launch(const void* x, const void* sx, const void* w, const void* sw,
           void* out, void* sout, int E, int C, int K, int N,
           cudaStream_t st) {
  const size_t smem = smem_bytes<BM, W_TRANS>();
  auto kern = grouped_gemm_fp8_kernel<BM, W_TRANS, QUANT_OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, (C + BM - 1) / BM, E);
  kern<<<grid, THREADS, smem, st>>>((const uint8_t*)x, (const float*)sx,
                                    (const uint8_t*)w, (const float*)sw, out,
                                    (float*)sout, C, K, N);
  return (int)cudaGetLastError();
}

template <bool W_TRANS, bool QUANT_OUT>
int launch_bm(const void* x, const void* sx, const void* w, const void* sw,
              void* out, void* sout, int E, int C, int K, int N,
              cudaStream_t st) {
  if (C <= 16)
    return launch<16, W_TRANS, QUANT_OUT>(x, sx, w, sw, out, sout, E, C, K,
                                          N, st);
  return launch<64, W_TRANS, QUANT_OUT>(x, sx, w, sw, out, sout, E, C, K, N,
                                        st);
}

}  // namespace

// w_trans: w is stored (E, N, K) with sw (E, N/128, K/128).  sout is used
// only with quant_out (out is then the e4m3 payload, else bf16).
REPRO_EXPORT int repro_grouped_gemm_fp8(const void* x, const void* sx,
                                        const void* w, const void* sw,
                                        void* out, void* sout, int w_trans,
                                        int quant_out, int E, int C, int K,
                                        int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (w_trans) {
    if (quant_out)
      return launch_bm<true, true>(x, sx, w, sw, out, sout, E, C, K, N, st);
    return launch_bm<true, false>(x, sx, w, sw, out, sout, E, C, K, N, st);
  }
  if (quant_out)
    return launch_bm<false, true>(x, sx, w, sw, out, sout, E, C, K, N, st);
  return launch_bm<false, false>(x, sx, w, sw, out, sout, E, C, K, N, st);
}
