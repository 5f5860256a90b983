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
// round-to-nearest-even shifts into the subnormal range: the reference's
// integer function, so the kernel equals its twin and the Pallas kernel
// bit for bit (NaN encodings too).
//
// Bound on H100: bytes (one read of the payload, one write of its
// transpose, plus the scales).  The first design, one block a tile that
// rebased every byte through all three branches of the reference, ran
// ~45 integer operations a byte and stayed at a quarter of the memory rate.
// This one does the work a 32-bit word at a time, because k is constant
// along an input row, so the four bytes of a row's word share one k:
//   k = 0        the word as it is;
//   k >= 19      the sign bits alone (every encoding, NaN included, rebases
//                to enc & 0x80 from k = 19 on; scales span 2**+-126, so k
//                reaches 252);
//   every exponent field > k   one subtraction of k << 3 from each byte
//                (no byte borrows and the sign bit is untouched);
//   otherwise    one lookup a byte in a 19 x 256 table of the reference's
//                rebase, built by the compiler (kTable) and copied into
//                shared memory once a block.
// Design: persistent blocks walk the (expert, m-tile, k-tile) tiles, k-tile
// fastest; one thread a block loads the next tile with a TMA copy (128-byte
// swizzle, one mbarrier a stage, two stages) while the block works on the
// current one, and the tile's row-scale exponents for the next tile are
// loaded into registers meanwhile.  Five blocks a SM (39 KB of shared
// memory each; the launch bound holds the registers to that), so up to
// five tiles a SM are in flight while five more are worked on.  A thread
// takes 16 rows x one word: a warp covers all 128 rows of 4 word columns,
// lanes 4 apart holding 16-row blocks ib = 0..7.  Lane ib reads its rows
// in the order r ^ ib, which puts the 32 lanes on 32 distinct banks of the
// swizzled tile (bank 4 * (word / 4 ^ r ^ ib) + word % 4).  It rebases the
// 16 words, transposes each 4 x 4 byte block with two rounds of byte
// permutes whose selectors undo the lane's row order, and writes 4 output
// rows of 16 bytes: eight lanes fill each 128-byte output row segment.
// About 10 operations a word on the copy and subtraction paths; a word
// that takes the table costs four shared-memory byte loads more
// (chip_smoke.py's t_phases times the kernel with no table words, with
// many, and with flush tiles).
#include <cuda.h>          // CUtensorMap; the CUDA driver is reached via
#include <cudaTypedefs.h>  // the runtime's entry-point query, no -lcuda

#include "common.cuh"

namespace {

constexpr int T = repro::TILE;        // 128
constexpr int THREADS = 256;
constexpr int STAGES = 2;
constexpr int BLOCKS_PER_SM = 5;      // what the shared memory allows
constexpr int TILE_BYTES = T * T;     // 16 KB a tile
constexpr int KSAT = 19;              // from here on, every encoding -> sign
// dynamic shared memory: [align to 1,024][stages][table][mbarriers]
constexpr int TABLE_OFF = STAGES * TILE_BYTES;
constexpr int BAR_OFF = TABLE_OFF + KSAT * 256;
constexpr size_t SMEM = 1024 + BAR_OFF + STAGES * 8;

// The reference's round-to-nearest-even right shift and rebase, evaluated
// by the compiler for the table.
__host__ __device__ constexpr int rshift_rne(int v, int n) {
  n = n < 0 ? 0 : (n > 15 ? 15 : n);
  const int floor_v = v >> n;
  const int rem = v - (floor_v << n);
  const int half = 1 << (n > 1 ? n - 1 : 0);
  const bool up = n > 0 && (rem > half || (rem == half && (floor_v & 1)));
  return floor_v + (up ? 1 : 0);
}

// Divide one e4m3 encoding by 2**k (k >= 0), re-encoding exactly.
__host__ __device__ constexpr uint32_t rebase(uint32_t enc, int k) {
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

// rebase(b, k) for k < KSAT at byte 256 * k + b, four to a word.
struct RebaseTable {
  uint32_t w[KSAT * 64];
};

__host__ __device__ constexpr RebaseTable make_table() {
  RebaseTable t{};
  for (int k = 0; k < KSAT; ++k)
    for (int b = 0; b < 256; b += 4)
      t.w[k * 64 + b / 4] = rebase(b, k) | rebase(b + 1, k) << 8 |
                            rebase(b + 2, k) << 16 | rebase(b + 3, k) << 24;
  return t;
}

static_assert(rebase(0x7f, KSAT) == 0 && rebase(0xff, KSAT) == 0x80 &&
                  rebase(0x7e, KSAT - 1) != 0,
              "k = 19 is the first k that leaves the sign bits alone");

__device__ const RebaseTable kTable = make_table();

// Four encodings of one row (one k) divided by 2**k.
__device__ __forceinline__ uint32_t rebase_word(uint32_t w, int k,
                                                const uint8_t* table) {
  if (k >= KSAT) return w & 0x80808080u;
  const uint32_t k8 = (uint32_t)k * 0x08080808u;
  if (k == 0 || __vcmpgtu4(w & 0x78787878u, k8) == 0xffffffffu)
    return w - k8;
  const uint8_t* row = table + 256 * k;
  return (uint32_t)row[w & 0xff] | (uint32_t)row[(w >> 8) & 0xff] << 8 |
         (uint32_t)row[(w >> 16) & 0xff] << 16 | (uint32_t)row[w >> 24] << 24;
}

// Selector of the second byte-permute round: output byte i takes the byte
// at pool position pos[i ^ sl] (pos of the 4 x 4 block's rows 0..3 in the
// pool of the first round's two words).
__device__ __forceinline__ uint32_t second_round(int sl, uint32_t pos) {
  uint32_t sel = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    sel |= ((pos >> (4 * (i ^ sl))) & 0xfu) << (4 * i);
  return sel;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// One arrival that also expects `bytes` of copies to complete on bar.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until bar has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// The 128 x 128 box at columns x.., rows y.. of the payload's tensor map
// -> dst (128-byte swizzle: row r's 16-byte chunk c in slot c ^ (r % 8)).
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, int x, int y) {
  mbar_expect(bar, TILE_BYTES);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(x), "r"(y) : "memory");
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
fp8_transpose_kernel(const __grid_constant__ CUtensorMap x_map,
                     const float* __restrict__ s, uint8_t* __restrict__ xo,
                     float* __restrict__ so, int E, int M, int K) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int sexp[2][T];
  __shared__ int wmax[2][4];
  // the 128-byte swizzle repeats every 1,024 bytes: stages start there
  uint8_t* stages =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint32_t* table = reinterpret_cast<uint32_t*>(stages + TABLE_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + BAR_OFF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = K / T, nm = M / T;
  const int tiles = E * nm * nk;
  // this thread's rows 16 * ib.., word column w = 4 * warp + (lane & 3)
  const int ib = lane >> 2, w = 4 * warp + (lane & 3);
  const int sh = ib >> 2;                          // group order flip
  const uint32_t sel0 = second_round(ib & 3, 0x5410u);
  const uint32_t sel1 = second_round(ib & 3, 0x7632u);

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < KSAT * 64; i += THREADS) table[i] = kTable.w[i];
  const uint8_t* tab = reinterpret_cast<const uint8_t*>(table);

  // biased exponent of row `tid` of tile t's scales
  auto scale_exp = [&](int t) {
    const int kb = t % nk, rest = t / nk;
    const long row = (long)(rest / nm) * M + (long)(rest % nm) * T + tid;
    return (__float_as_int(s[row * nk + kb]) >> 23) & 0xff;
  };
  auto load = [&](int t, int st) {
    const int kb = t % nk, rest = t / nk;
    tma_load(&x_map, stages + st * TILE_BYTES, full + st, kb * T,
             (rest / nm) * M + (rest % nm) * T);
  };

  int t = blockIdx.x;
  int ex = (tid < T && t < tiles) ? scale_exp(t) : 0;
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < STAGES - 1; ++j)
      if (t + j * (int)gridDim.x < tiles) load(t + j * (int)gridDim.x, j);

  for (int i = 0; t < tiles; ++i, t += gridDim.x) {
    const int b = i & 1;
    const int tn = t + gridDim.x;
    if (tid < T) {
      sexp[b][tid] = ex;
      int mx = ex;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) wmax[b][warp] = mx;
      if (tn < tiles) ex = scale_exp(tn);
    }
    // every thread is done with tile i - 1: its stage takes the tile
    // STAGES - 1 ahead
    __syncthreads();
    const int ahead = t + (STAGES - 1) * (int)gridDim.x;
    if (tid == 0 && ahead < tiles) load(ahead, (i + STAGES - 1) % STAGES);
    mbar_wait(full + i % STAGES, (i / STAGES) & 1);

    const int emax = max(max(wmax[b][0], wmax[b][1]),
                         max(wmax[b][2], wmax[b][3]));
    const int* sx = sexp[b];
    const uint8_t* buf = stages + (i % STAGES) * TILE_BYTES;
    uint32_t a[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = 16 * ib + (r ^ ib);
      const uint32_t word = *reinterpret_cast<const uint32_t*>(
          buf + row * T + (((w >> 2) ^ row) & 7) * 16 + (w & 3) * 4);
      a[r] = rebase_word(word, emax - sx[row], tab);
    }
    // slot 4g + i holds row 16 ib + 4 (g ^ sh) + (i ^ (ib & 3)); o[g][c] is
    // byte c of the 4 rows of slot group g, in row order
    uint32_t o[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const uint32_t t0 = __byte_perm(a[4 * g], a[4 * g + 1], 0x5140);
      const uint32_t t1 = __byte_perm(a[4 * g], a[4 * g + 1], 0x7362);
      const uint32_t t2 = __byte_perm(a[4 * g + 2], a[4 * g + 3], 0x5140);
      const uint32_t t3 = __byte_perm(a[4 * g + 2], a[4 * g + 3], 0x7362);
      o[g][0] = __byte_perm(t0, t2, sel0);
      o[g][1] = __byte_perm(t0, t2, sel1);
      o[g][2] = __byte_perm(t1, t3, sel0);
      o[g][3] = __byte_perm(t1, t3, sel1);
    }
    const int kb = t % nk, rest = t / nk, e = rest / nm, mb = rest % nm;
    uint8_t* dst = xo + ((size_t)e * K + (size_t)kb * T + 4 * w) * M +
                   (size_t)mb * T + 16 * ib;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint4 v;
      v.x = sh ? o[1][c] : o[0][c];
      v.y = sh ? o[0][c] : o[1][c];
      v.z = sh ? o[3][c] : o[2][c];
      v.w = sh ? o[2][c] : o[3][c];
      *reinterpret_cast<uint4*>(dst + (size_t)c * M) = v;
    }
    if (tid < T)
      so[((size_t)e * K + (size_t)kb * T + tid) * nm + mb] =
          __int_as_float(emax << 23);
  }
}

// The (E * M, K) payload as a copy-engine tensor map: 128 x 128 boxes,
// 128-byte swizzle.  cuTensorMapEncodeTiled comes from the CUDA driver via
// the runtime.
int tensor_map(CUtensorMap* map, const void* base, long rows, int cols) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return err != cudaSuccess ? (int)err : (int)cudaErrorSymbolNotFound;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {T, T}, unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

REPRO_EXPORT int repro_fp8_transpose(const void* x, const void* s, void* xo,
                                     void* so, int E, int M, int K,
                                     void* stream) {
  const long tiles = (long)E * (M / T) * (K / T);
  if (tiles == 0) return 0;
  static int sms[64], per_sm[64];  // by device, filled at first use
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    int n = 0, b = 0;
    err = cudaFuncSetAttribute(fp8_transpose_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, fp8_transpose_kernel, THREADS, SMEM);
    if (err != cudaSuccess) return (int)err;
    per_sm[dev] = b > 0 ? b : 1;
    sms[dev] = n;
  }
  CUtensorMap map = {};
  const int r = tensor_map(&map, x, (long)E * M, K);
  if (r) return r;
  // persistent: as many blocks as fit on the card at once, at most a tile each
  const long fit = (long)sms[dev] * per_sm[dev];
  const int grid = (int)(tiles < fit ? tiles : fit);
  fp8_transpose_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      map, (const float*)s, (uint8_t*)xo, (float*)so, E, M, K);
  return (int)cudaGetLastError();
}
