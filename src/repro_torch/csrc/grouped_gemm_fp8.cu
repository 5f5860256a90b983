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
// The partial of each K step is summed on the tensor cores (eight f16
// wgmmas started from zero, exact products, f32 sums) and promoted into the f32
// accumulator with its scales, as the reference does at
// grouped_gemm_fp8.py:71 (acc += partial * (sx * sw)).  Keep this per-step
// promotion in later designs: an MMA accumulator with fewer bits than f32
// would lose precision over a long K.
//
// Bound on H100: at the serving shapes, bytes.  Decode reads every live
// expert's weights (K*N bytes each, 1.6 GB for GEMM-1 at full width when
// all are live) for a handful of rows; prefill at 128 rows per expert and
// the training GEMMs at 256 sit near the fp8 ridge point (bytes and FP8
// tensor-core operations bound them within 1.5x of each other).
//
// Design: the tensor-core tile loop of gemm_tile.cuh.  A block is one or
// two warpgroups (BM = 64 rows for C <= 64, else 128 rows: one masking
// group), a 128-column tile and one expert; its K loop streams the x and
// w tiles as e4m3 through a cp.async ring (3-4 stages), widens them
// exactly to f16 in the block (the (K, N) weight transposed on the way,
// never in device memory: a physical transpose would move 2.4 GB a train
// step) and multiplies each 128-deep step with eight f16 wgmma
// instructions into f32, then promotes the step's partial into the
// accumulator with its scales.  Rows >= C are zero-filled by the copies
// and never stored, so ragged C (decode's 8, any C in the tests) needs no
// padding.  The f16 path runs at half the FP8 tensor-core rate; FP8 wgmma
// itself was ruled out by the quantizing epilogue's gates (gemm_tile.cuh).
//
// QUANT_OUT: BN = 128 = TILE, so one output row of a block tile is one
// quantization group; under the wgmma accumulator layout its 128 values
// sit in one quad of lanes (32 each): the row amax is the thread's own
// and two __shfl_xor_sync steps, the scale the bit-built po2 recipe of
// the quantize kernel (common.cuh), then acc / s, clip +-448 and a
// saturating RNE cast.
//
// What it leaves: one role for every thread (no producer warp, TMA or
// register reallocation), so the widening, the promotion and the epilogue
// do not overlap the tensor cores within a block; no persistent blocks or
// clusters (a weight tile is fetched once per 128-row block); the epilogue
// stores straight from the fragment (16 bytes a row segment).
#include "gemm_tile.cuh"

namespace {

using namespace repro::gemm;

template <int BM, bool W_TRANS, bool QUANT_OUT, bool MASKED>
__global__ void __launch_bounds__(2 * BM, 1)
grouped_gemm_fp8_kernel(const uint8_t* __restrict__ x,
                        const float* __restrict__ sx,
                        const uint8_t* __restrict__ w,
                        const float* __restrict__ sw,
                        const int* __restrict__ masked_m,
                        void* __restrict__ out, float* __restrict__ sout,
                        int C, int K, int N) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int e = blockIdx.z, m0 = blockIdx.y * BM, nblk = blockIdx.x;
  const int tid = threadIdx.x;
  if (MASKED && group_dead(masked_m, e, m0)) {  // block-uniform exit
    write_dead_tile<BM>(out, QUANT_OUT ? 1 : 2, QUANT_OUT ? sout : nullptr,
                        e, m0, C, N, nblk * BN, nblk, tid);
    return;
  }
  const int nk = K / BK;
  const int cols[1] = {nblk};
  float acc[1][64];
  mainloop<BM, W_TRANS, 1>(x + (size_t)e * C * K, sx + (size_t)e * C * nk,
                           w + (size_t)e * K * N,
                           sw + (size_t)e * nk * (N / BN), m0, C, K, N, cols,
                           smem, acc);
  const int row_a = m0 + frag_row(tid), lane = tid & 31;
  if (QUANT_OUT)
    quantize_rows_store(acc[0], reinterpret_cast<uint8_t*>(out) +
                                    (size_t)e * C * N,
                        sout + (size_t)e * C * (N / BN), row_a, C, N, nblk,
                        lane);
  else
    store_bf16(acc[0], reinterpret_cast<__nv_bfloat16*>(out) +
                           (size_t)e * C * N,
               row_a, C, N, nblk * BN, lane);
}

template <int BM, bool W_TRANS, bool QUANT_OUT, bool MASKED>
int launch(const void* x, const void* sx, const void* w, const void* sw,
           const void* masked_m, void* out, void* sout, int E, int C, int K,
           int N, cudaStream_t st) {
  const size_t smem = smem_bytes<BM, W_TRANS, 1>();
  auto kern = grouped_gemm_fp8_kernel<BM, W_TRANS, QUANT_OUT, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, (C + BM - 1) / BM, E);
  kern<<<grid, 2 * BM, smem, st>>>((const uint8_t*)x, (const float*)sx,
                                   (const uint8_t*)w, (const float*)sw,
                                   (const int*)masked_m, out, (float*)sout,
                                   C, K, N);
  return (int)cudaGetLastError();
}

template <bool W_TRANS, bool QUANT_OUT, bool MASKED>
int launch_bm(const void* x, const void* sx, const void* w, const void* sw,
              const void* masked_m, void* out, void* sout, int E, int C,
              int K, int N, cudaStream_t st) {
  if (block_rows(C) == 64)
    return launch<64, W_TRANS, QUANT_OUT, MASKED>(x, sx, w, sw, masked_m, out,
                                                  sout, E, C, K, N, st);
  return launch<128, W_TRANS, QUANT_OUT, MASKED>(x, sx, w, sw, masked_m, out,
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
  if (!aligned16(x, w)) return (int)cudaErrorMisalignedAddress;
  if (masked_m)
    return launch_form<true>(x, sx, w, sw, masked_m, out, sout, w_trans,
                             quant_out, E, C, K, N, st);
  return launch_form<false>(x, sx, w, sw, masked_m, out, sout, w_trans,
                            quant_out, E, C, K, N, st);
}
