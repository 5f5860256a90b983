// The CUDA-core FFMA tile loop of the port's NN grouped GEMMs, shared by
// grouped_gemm_fp8.cu (bf16 out, quantizing epilogue, masked or padded)
// and grouped_gemm_swiglu_quant.cu (the fused SwiGLU GEMM-1), so that the
// fused kernel's gate and up accumulators are, bit for bit, the columns the
// unfused GEMM computes.
//
// A block of 256 threads computes a BM x 128 output tile of one expert.
// Per 128-deep K step it stages the BM x 128 x tile and a 128 x 128 w tile
// in shared memory as f32; every thread (tx = tid % 16 on columns tx + 16j,
// ty = tid / 16 on rows ty + 16i) sums TM x 8 partials in registers over
// the step in k order, then promotes them into its f32 accumulators with
// the step's scales: acc = fma(part, sx[row] * sw, acc), the reference's
// acc += partial * (sx * sw) (grouped_gemm_fp8.py:71) with one rounding.
#pragma once

#include "common.cuh"

namespace repro {
namespace gemm {

constexpr int BN = 128;
constexpr int BK = 128;            // == the scale tile
constexpr int THREADS = 256;
static_assert(THREADS == 256, "stage_tile_n_major is written for 256 threads");
static_assert(BK == TILE, "one K step is one scale tile");
constexpr int TN = BN / 16;
constexpr int XS = BK + 4;         // x tile row stride (floats): 16-byte
                                   // aligned, and rows 16 apart fall in
                                   // different banks
constexpr int WTS = TILE_T_STRIDE; // transposed w tile row stride

template <int BM, bool W_TRANS>
constexpr size_t smem_bytes() {
  return (size_t)(BM * XS + (W_TRANS ? BN * WTS : BK * BN)) * sizeof(float);
}

// The 128-row group (the reference's BM = 128 tile, grouped_gemm_fp8.py:53)
// holding row m0 is dead when it starts at or beyond masked_m[e].
__device__ __forceinline__ bool group_dead(const int* masked_m, int e,
                                           int m0) {
  return (m0 / TILE) * TILE >= __ldg(masked_m + e);
}

// x tile: BM rows x 32 words of step kb; rows >= C are zero.  A warp
// covers one 128-byte row.
template <int BM>
__device__ __forceinline__ void stage_x(const uint8_t* xe, int m0, int C,
                                        int K, int kb, float* xs, int tid) {
  for (int c = tid; c < BM * 32; c += THREADS) {
    const int r = c / 32, col = (c % 32) * 4;
    const uint32_t v =
        (m0 + r < C) ? *reinterpret_cast<const uint32_t*>(
                           xe + (size_t)(m0 + r) * K + (size_t)kb * BK + col)
                     : 0u;
    unpack4(v, xs + r * XS + col);
  }
}

// w tile of step kb, columns n0 .. n0+127.  Stored (K, N): 128 K-rows x 32
// words, k-major.  W_TRANS, stored (N, K): rows n (k contiguous) staged
// n-major with an odd stride, conflict-free both ways (common.cuh).
template <bool W_TRANS>
__device__ __forceinline__ void stage_w(const uint8_t* we, int K, int N,
                                        int n0, int kb, float* ws, int tid) {
  if (W_TRANS) {
    stage_tile_n_major(we + (size_t)n0 * K + (size_t)kb * BK, K, ws, tid);
  } else {
    for (int c = tid; c < BK * 32; c += THREADS) {
      const int r = c / 32, col = (c % 32) * 4;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          we + ((size_t)kb * BK + r) * N + n0 + col);
      unpack4(v, ws + r * BN + col);
    }
  }
}

// part[i][j] = sum over k in order of xs[row i][k] * ws[k][col j].
template <int BM, bool W_TRANS>
__device__ __forceinline__ void tile_product(const float* xs, const float* ws,
                                             int tx, int ty,
                                             float (&part)[BM / 16][TN]) {
  constexpr int TM = BM / 16;
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
}

// acc += part * (sx[row, kb] * swv), one rounding; rows >= C take 0.
template <int BM>
__device__ __forceinline__ void promote(float (&acc)[BM / 16][TN],
                                        const float (&part)[BM / 16][TN],
                                        const float* sxe, int m0, int C,
                                        int nk, int kb, float swv, int ty) {
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int row = m0 + ty + 16 * i;
    const float f = __fmul_rn(row < C ? sxe[(size_t)row * nk + kb] : 0.f, swv);
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(part[i][j], f, acc[i][j]);
  }
}

// Quantize row i of a block's accumulators: the row's 128 values sit in
// this half-warp (tx + 16j), so the amax is four shuffles; then the
// bit-built po2 scale and a saturating RNE cast of acc / s.  Every lane of
// the warp calls it (the shuffles); lanes of rows >= C write nothing.
__device__ __forceinline__ void quantize_row_store(const float (&v)[TN],
                                                   bool row_ok, uint8_t* q,
                                                   float* s, int tx) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < TN; ++j) amax = nan_max(amax, fabsf(v[j]));
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!row_ok) return;
  const float sc = po2_scale(amax);
#pragma unroll
  for (int j = 0; j < TN; ++j)
    q[tx + 16 * j] = (uint8_t)to_e4m3(__fdiv_rn(v[j], sc));
  if (tx == 0) *s = sc;
}

// What a dead 128-row group writes over the block's rows m0 .. m0+BM-1
// (< C) and columns n0 .. n0+127: zeros of `elt` bytes each and, with a
// scale array, scale 1.0 at column tile nblk -- the bits the padded
// kernels write for zero rows (bf16 +0; e4m3 payload 0 with scale 1.0).
template <int BM>
__device__ __forceinline__ void write_dead_tile(void* out, int elt, float* sout,
                                                int e, int m0, int C, int N,
                                                int n0, int nblk, int tid) {
  const int rows = min(BM, C - m0);
  const int words = BN * elt / 16;  // 16-byte stores a row
  for (int c = tid; c < rows * words; c += THREADS) {
    const int r = c / words, w = c % words;
    uint8_t* row = reinterpret_cast<uint8_t*>(out) +
                   (((size_t)e * C + m0 + r) * N + n0) * elt;
    reinterpret_cast<uint4*>(row)[w] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (sout)
    for (int r = tid; r < rows; r += THREADS)
      sout[((size_t)e * C + m0 + r) * (N / BN) + nblk] = 1.f;
}

}  // namespace gemm
}  // namespace repro
