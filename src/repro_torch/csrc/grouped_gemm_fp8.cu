// FP8 grouped GEMM with per-tile scaling: bf16 out, or FP8 out through a
// quantizing epilogue; the weight read as stored or transposed; every
// capacity row computed (padded layout) or dead 128-row groups skipped
// (masked layout).
//
// Replaces the TPU kernels
// repro/kernels/grouped_gemm_fp8.py::grouped_gemm_fp8_pallas in both forms:
// bf16 out (pallas_call at grouped_gemm_fp8.py:135; body _gg_kernel :58)
// and quant_out=True (pallas_call at :147; body _gg_quant_kernel :87,
// epilogue _quant_epilogue :78); and masked_grouped_gemm_fp8_pallas in both
// forms (pallas_call at :297, body _gg_masked_kernel :168; :313,
// _gg_masked_quant_kernel :194).  For every expert e:
//   out[e] = sum over 128-wide K steps k of
//            (x[e, :, k] @ w[e, k, :]) * (sx[e, :, k] * sw[e, k, n-block])
//   x  (E, C, K) e4m3, sx (E, C, K/128) f32 row scales
//   w  (E, K, N) e4m3, sw (E, K/128, N/128) f32 block scales, or with
//      W_TRANS the stored (E, N, K) / (E, N/128, K/128) read as its
//      transpose (the Dgrad GEMMs' w^T: the reference's _block_t relabel)
//   out (E, C, N) bf16, or with QUANT_OUT (E, C, N) e4m3 + (E, C, N/128)
//      po2 scales quantized from the f32 accumulator (the Pallas epilogue;
//      the reference's XLA route rounds to bf16 first)
//   MASKED: masked_m (E,) int32 on the device, the live rows of each
//      expert.  A 128-row group (the reference's BM = 128 tile) is dead
//      when it starts at or beyond masked_m[e]; a block in a dead group
//      reads masked_m[e] from device memory, skips the K loop and writes
//      what the padded kernel writes for zero rows (bf16 +0; payload 0 and
//      scale 1.0).  Live groups run the padded arithmetic unchanged, rows
//      beyond masked_m included (the reference's tile-granular masking,
//      grouped_gemm_fp8.py:24-31), so on the dispatch layout, whose rows
//      beyond masked_m are zero, masked == padded bit for bit.  The host
//      never reads masked_m: the full grid launches and dead blocks exit.
// The partial of each K step is summed in f32 and promoted into the f32
// accumulator with its scales, as the reference does at
// grouped_gemm_fp8.py:71 (acc += partial * (sx * sw)).  Keep this per-step
// promotion in later designs: Hopper's FP8 MMA accumulator loses precision
// over a long K.
//
// Bound on H100: at the serving shapes, bytes.  Decode reads every live
// expert's weights (K*N bytes each, 1.6 GB for GEMM-1 at full width when
// all are live) for a handful of rows; prefill at 128 rows per expert and
// the training GEMMs at 256 are also at or below the fp8 ridge point.
// This first design is simple and exact rather than fast: CUDA-core FFMA
// on operands converted to f32 in shared memory (no mma, wgmma or TMA
// yet), the tile loop of gemm_tile.cuh.  Rows >= C are masked, so ragged
// row counts (decode's C = 8) need no padding: BM = 16 serves C <= 16 and
// BM = 64 the rest.  A 128-row group spans one block at BM = 16 or 64 when
// C <= 128, two blocks at BM = 64 otherwise.
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
// What it leaves: tensor cores (the FFMA loop is shared-memory bound) and
// double buffering of the tile loads.
#include "gemm_tile.cuh"

namespace {

using namespace repro::gemm;

template <int BM, bool W_TRANS, bool QUANT_OUT, bool MASKED>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_fp8_kernel(const uint8_t* __restrict__ x,
                        const float* __restrict__ sx,
                        const uint8_t* __restrict__ w,
                        const float* __restrict__ sw,
                        const int* __restrict__ masked_m,
                        void* __restrict__ out, float* __restrict__ sout,
                        int C, int K, int N) {
  constexpr int TM = BM / 16;
  extern __shared__ float smem[];
  float* xs = smem;                // BM x XS
  float* ws = smem + BM * XS;      // BK x BN, or (W_TRANS) BN x WTS
  const int e = blockIdx.z, m0 = blockIdx.y * BM, nblk = blockIdx.x;
  const int n0 = nblk * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (MASKED && group_dead(masked_m, e, m0)) {  // block-uniform exit
    write_dead_tile<BM>(out, QUANT_OUT ? 1 : 2, QUANT_OUT ? sout : nullptr,
                        e, m0, C, N, n0, nblk, tid);
    return;
  }
  const int nk = K / BK, nb = N / BN;
  const uint8_t* xe = x + (size_t)e * C * K;
  const float* sxe = sx + (size_t)e * C * nk;
  const uint8_t* we = w + (size_t)e * K * N;
  const float* swe = sw + (size_t)e * nk * nb;

  float acc[TM][TN], part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < nk; ++kb) {
    __syncthreads();  // the previous step's reads are done
    stage_x<BM>(xe, m0, C, K, kb, xs, tid);
    stage_w<W_TRANS>(we, K, N, n0, kb, ws, tid);
    __syncthreads();
    tile_product<BM, W_TRANS>(xs, ws, tx, ty, part);
    const float swv = W_TRANS ? swe[(size_t)nblk * nk + kb]
                              : swe[(size_t)kb * nb + nblk];
    promote<BM>(acc, part, sxe, m0, C, nk, kb, swv, ty);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (QUANT_OUT) {
      quantize_row_store(
          acc[i], row < C,
          reinterpret_cast<uint8_t*>(out) + ((size_t)e * C + row) * N + n0,
          sout + ((size_t)e * C + row) * nb + nblk, tx);
    } else {
      if (row >= C) continue;
      __nv_bfloat16* o =
          reinterpret_cast<__nv_bfloat16*>(out) + ((size_t)e * C + row) * N + n0;
#pragma unroll
      for (int j = 0; j < TN; ++j) o[tx + 16 * j] = __float2bfloat16_rn(acc[i][j]);
    }
  }
}

template <int BM, bool W_TRANS, bool QUANT_OUT, bool MASKED>
int launch(const void* x, const void* sx, const void* w, const void* sw,
           const void* masked_m, void* out, void* sout, int E, int C, int K,
           int N, cudaStream_t st) {
  const size_t smem = smem_bytes<BM, W_TRANS>();
  auto kern = grouped_gemm_fp8_kernel<BM, W_TRANS, QUANT_OUT, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, (C + BM - 1) / BM, E);
  kern<<<grid, THREADS, smem, st>>>((const uint8_t*)x, (const float*)sx,
                                    (const uint8_t*)w, (const float*)sw,
                                    (const int*)masked_m, out, (float*)sout,
                                    C, K, N);
  return (int)cudaGetLastError();
}

template <bool W_TRANS, bool QUANT_OUT, bool MASKED>
int launch_bm(const void* x, const void* sx, const void* w, const void* sw,
              const void* masked_m, void* out, void* sout, int E, int C,
              int K, int N, cudaStream_t st) {
  if (C <= 16)
    return launch<16, W_TRANS, QUANT_OUT, MASKED>(x, sx, w, sw, masked_m, out,
                                                  sout, E, C, K, N, st);
  return launch<64, W_TRANS, QUANT_OUT, MASKED>(x, sx, w, sw, masked_m, out,
                                                sout, E, C, K, N, st);
}

template <bool MASKED>
int launch_form(const void* x, const void* sx, const void* w, const void* sw,
                const void* masked_m, void* out, void* sout, int w_trans,
                int quant_out, int E, int C, int K, int N, cudaStream_t st) {
  if (w_trans) {
    if (quant_out)
      return launch_bm<true, true, MASKED>(x, sx, w, sw, masked_m, out, sout,
                                           E, C, K, N, st);
    return launch_bm<true, false, MASKED>(x, sx, w, sw, masked_m, out, sout,
                                          E, C, K, N, st);
  }
  if (quant_out)
    return launch_bm<false, true, MASKED>(x, sx, w, sw, masked_m, out, sout,
                                          E, C, K, N, st);
  return launch_bm<false, false, MASKED>(x, sx, w, sw, masked_m, out, sout, E,
                                         C, K, N, st);
}

}  // namespace

// w_trans: w is stored (E, N, K) with sw (E, N/128, K/128).  sout is used
// only with quant_out (out is then the e4m3 payload, else bf16).
// masked_m: (E,) int32 live-row counts on the device (masked layout), or
// null (padded layout).
REPRO_EXPORT int repro_grouped_gemm_fp8(const void* x, const void* sx,
                                        const void* w, const void* sw,
                                        const void* masked_m, void* out,
                                        void* sout, int w_trans,
                                        int quant_out, int E, int C, int K,
                                        int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (masked_m)
    return launch_form<true>(x, sx, w, sw, masked_m, out, sout, w_trans,
                             quant_out, E, C, K, N, st);
  return launch_form<false>(x, sx, w, sw, masked_m, out, sout, w_trans,
                            quant_out, E, C, K, N, st);
}
