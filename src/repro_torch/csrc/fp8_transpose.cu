// Scaling-aware FP8 direct transpose (paper Algorithm 1).
//
// Replaces the TPU kernel repro/kernels/fp8_transpose.py::fp8_transpose_pallas
// (pallas_call at fp8_transpose.py:102; body _transpose_kernel :72, integer
// rebase _rebase_exponent :44, _rshift_rne :31).  For every expert e and
// every 128 x 128 tile (rows m0.., columns k0..) of a row-wise quantized
// (E, M, K) e4m3 tensor with po2 row scales (E, M, K/128):
//   s_max  = max of the tile's 128 row scales
//   k_i    = log2(s_max / s_i), read from the f32 exponent bits (both are
//            normal powers of two, so no float math touches the payload)
//   out[e, k0 + j, m0 + i] = rebase(x[e, m0 + i, k0 + j], k_i)
//   sout[e, k0 + j, m0 / 128] = s_max
// where rebase divides an e4m3 encoding by 2**k exactly, with
// round-to-nearest-even shifts into the subnormal range -- the integer
// function of the reference, copied branch for branch, so the kernel
// equals its twin and the Pallas kernel bit for bit (NaN encodings too).
//
// Bound on H100: bytes (one read of the payload, one write of its
// transpose, plus the scales; a few integer ops per byte).  Design: one
// block of 256 threads per tile, grid (K/128, M/128, E), so a whole
// (E, M, K) batch is one launch.  The tile is staged in shared memory as
// 32-bit words with a row stride of 33 words: the 16-byte coalesced global
// loads store without bank conflicts (a warp covers 4 rows x 8 chunks,
// banks r + 4*chunk + q), and so do the transposed reads.  A thread then
// rebases 4 x 4 byte blocks (4 rows, one word each), transposes them in
// registers and writes 4 words, one to each of 4 output rows; a warp
// covers 8 row-blocks x 4 word columns, which makes the shared reads
// conflict-free (banks 4*ib + wc) and the global writes whole 32-byte
// sectors.  What it leaves: TMA and a persistent grid; at 16 KB a tile the
// kernel is already one read and one write of every byte.
#include "common.cuh"

namespace {

constexpr int T = repro::TILE;  // 128
constexpr int WORDS = T / 4;    // 32 words a tile row
constexpr int SROW = WORDS + 1; // shared row stride in words

__device__ __forceinline__ int rshift_rne(int v, int n) {
  n = min(max(n, 0), 15);
  const int floor_v = v >> n;
  const int rem = v - (floor_v << n);
  const int half = 1 << max(n - 1, 0);
  const bool up = n > 0 && (rem > half || (rem == half && (floor_v & 1)));
  return floor_v + (up ? 1 : 0);
}

// Divide one e4m3 encoding by 2**k (k >= 0), re-encoding exactly.
__device__ __forceinline__ uint32_t rebase(uint32_t enc, int k) {
  const int sign = enc & 0x80;
  const int e = (enc >> 3) & 0xF;
  const int m = enc & 0x7;
  const int e_new = e - k;
  const int normal_out = sign | ((e_new & 0xF) << 3) | m;
  const int m_sub = rshift_rne(8 + m, 1 - e_new);
  const int sub_from_normal = m_sub >= 8 ? (sign | 8) : (sign | m_sub);
  const int sub_from_sub = sign | rshift_rne(m, k);
  const int out = e == 0 ? sub_from_sub
                         : (e_new >= 1 ? normal_out : sub_from_normal);
  return (uint32_t)out & 0xffu;
}

__global__ void __launch_bounds__(256)
fp8_transpose_kernel(const uint8_t* __restrict__ x,
                     const float* __restrict__ s, uint8_t* __restrict__ xo,
                     float* __restrict__ so, int M, int K) {
  __shared__ uint32_t tile[T * SROW];
  __shared__ int sexp[T];
  __shared__ int wmax[8];
  const int kb = blockIdx.x, mb = blockIdx.y, e = blockIdx.z;
  const int k0 = kb * T, m0 = mb * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = K / T, nm = M / T;
  const uint8_t* xe = x + (size_t)e * M * K;

  // 128 rows x 8 chunks of 16 bytes
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int c = tid + 256 * it, r = c >> 3, ch = c & 7;
    const uint4 v = *reinterpret_cast<const uint4*>(
        xe + (size_t)(m0 + r) * K + k0 + ch * 16);
    uint32_t* dst = tile + r * SROW + ch * 4;
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  // row scales -> biased f32 exponents; the tile's max exponent is s_max's
  int ex = 0;
  if (tid < T) {
    ex = (__float_as_int(s[((size_t)e * M + m0 + tid) * nk + kb]) >> 23)
         & 0xff;
    sexp[tid] = ex;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ex = max(ex, __shfl_xor_sync(0xffffffffu, ex, o));
  if (lane == 0) wmax[warp] = ex;
  __syncthreads();
  int emax = wmax[0];
#pragma unroll
  for (int w = 1; w < 4; ++w) emax = max(emax, wmax[w]);

  // 32 x 32 blocks of 4 x 4 bytes; a warp takes 8 row-blocks x 4 words
  uint8_t* xoe = xo + (size_t)e * K * M;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int t = warp + 8 * it;
    const int ib = (t & 3) * 8 + (lane & 7);   // rows 4*ib .. 4*ib+3
    const int w = (t >> 2) * 4 + (lane >> 3);  // bytes 4*w .. 4*w+3
    uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * ib + r;
      const uint32_t word = tile[row * SROW + w];
      const int kshift = emax - sexp[row];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[c] |= rebase((word >> (8 * c)) & 0xffu, kshift) << (8 * r);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(
          xoe + (size_t)(k0 + 4 * w + c) * M + m0 + 4 * ib) = out[c];
  }
  if (tid < T)
    so[((size_t)e * K + k0 + tid) * nm + mb] = __int_as_float(emax << 23);
}

}  // namespace

REPRO_EXPORT int repro_fp8_transpose(const void* x, const void* s, void* xo,
                                     void* so, int E, int M, int K,
                                     void* stream) {
  const dim3 grid(K / T, M / T, E);
  fp8_transpose_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const float*)s, (uint8_t*)xo, (float*)so, M, K);
  return (int)cudaGetLastError();
}
