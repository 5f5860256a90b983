// FP8 grouped GEMM, NT layout (the Wgrad form), padded or masked.
//
// Replaces the TPU kernels
// repro/kernels/grouped_gemm_nt_fp8.py::grouped_gemm_nt_fp8_pallas
// (pallas_call at grouped_gemm_nt_fp8.py:67; body _gg_nt_kernel :39) and
// masked_grouped_gemm_nt_fp8_pallas (pallas_call at :131; body
// _gg_nt_masked_kernel :86).  For every expert e, with the contraction
// over the LAST axis of both operands:
//   out[e] = sum over 128-wide C steps k of
//            (a[e, :, k] @ b[e, :, k]^T) * (sa[e, :, k] (x) sb[e, :, k])
//   a  (E, M, C) e4m3, sa (E, M, C/128) f32 row scales
//   b  (E, N, C) e4m3, sb (E, N, C/128) f32 row scales
//   out (E, M, N) f32 or bf16 (a launch argument)
//   MASKED: masked_m (E,) int32 on the device, the live tokens of each
//      expert.  The token axis is the contraction here, so a tile runs
//      only the C steps k with k * 128 < masked_m[e] (read from device
//      memory; the host never does) and an expert with none stores +0.  A
//      skipped step's tokens are zero on the dispatch layout, so its
//      promoted partial is +0 and adding it changes no bit: masked ==
//      padded bit for bit.
// These are the layouts the scaling-aware transpose produces: Wgrad takes
// T(activation) and T(gradient), both row-tiled over the token axis.  Each
// step's partial starts from zero and is promoted with the outer product
// of the two scale columns, acc = fma(part, sa[m] * sb[n], acc): the
// reference's acc += partial * (sa * sb.T) with one rounding.  A bf16
// output is one rounding of that f32 sum.
//
// Bound on H100: bytes, the output's.  At the training shapes (E = 128
// experts, C = 256 tokens an expert, M x N = 4096 x 3072 or 1536 x 4096)
// the bf16 output is 3.2 / 1.6 GB of the 3.46 / 1.78 GB the kernel moves
// (1.03 / 0.54 ms at 3.35 TB/s); the products, 825 / 412 GFLOP, take 0.42
// / 0.21 ms at the fp8 peak (0.83 / 0.42 at the f16 peak this loop runs
// at).  An f32 output doubles the bound.
//
// Arithmetic: f16 tensor cores on exactly widened operands.  Both operands
// are contraction-contiguous, the layout FP8 wgmma reads with no
// conversion, but FP8 wgmma keeps ~14 bits inside an instruction and so
// failed the rtol=atol=2e-2 gate against the twin at both Wgrad shapes:
// near-zero outputs of long cancelling sums fell outside it (7 of 1.6e9
// lanes at Wgrad-1, 5.3% of bf16 lanes off the twin against 3e-6 here;
// chip_smoke.py fails above 1e-3).  So, as in the NN loop, each e4m3
// value is widened exactly to f16 and a step is eight wgmma.m64n128k16.f32.f16.f16
// a warpgroup (exact products, f32 sums), with gemm_tile.cuh's widening
// and wgmma code: a as the A fragment in registers (load_a, as x there),
// b as the K-major f16 B tile in shared memory (convert_w, as a weight
// stored (N, K) there).
//
// Design: a persistent block of two warpgroups a SM computes 128 x 128
// output tiles, walking panels (an expert's 128 b rows, a column tile of
// the output) round-robin across the grid and, inside a panel, the row
// tiles in order.  So the SMs work on a few neighbouring panels at once
// (their operands stay in L2 and are read from device memory about once),
// and a panel's widened f16 b tiles serve all of its row tiles.
//   b cache: NB f16 tiles, step k's in slot k % NB, each tagged with its
//   (panel, step) and kept with its 128 sb.  A step whose slot holds it
//   loads and widens no b; at C <= NB * 128 (training: C = 256) a panel's
//   b is loaded and widened once for its M / 128 row tiles, at larger C
//   the slots turn over and b streams with a.  A miss is the only point
//   where the two warpgroups wait for each other (the slot is shared).
//   Warpgroups: each owns 64 rows of the tile and runs its own loads,
//   products, promotion and stores between named barriers.  They take
//   turns at the tensor cores (each issues its step's eight wgmmas on its
//   turn and passes it on), so one's widening, promotion and stores run
//   while the other's products do.
//   Loads: the copy engine (TMA) brings each warpgroup's 64 rows x 128
//   bytes of a (and on a miss of b) into a ring of A_STAGES steps, in the
//   128-byte swizzle (row r's 16-byte chunk c in slot c ^ (r % 8)) that
//   load_a and convert_w read without bank conflicts, completing on a full
//   barrier a stage; the scales come by cp.async.  The ring runs up to
//   A_STAGES - 1 steps ahead across tiles and panels.  The loader keeps its
//   own copy of the tags, updated in the order the product loop updates
//   them, so both agree on every miss; misses' b tiles take a ring of
//   their own, B_RING entries in turn.
//   Promotion: per element, sa of the thread's two fragment rows from the
//   stage, sb of its 32 fragment columns from the slot.
//   Stores: straight from registers, in whole 32-byte sectors.  For bf16 a
//   4 x 4 word transpose inside each quad of lanes (two xor shuffles)
//   gives every lane 8 contiguous columns, so a lane stores 16 bytes and a
//   quad 64 bytes of one row; for f32 a quad's 8-byte pairs already cover
//   32 contiguous bytes.  Staging the tile in shared memory and storing it
//   by TMA was measured as no faster and needs two barriers a tile.
// Registers: part[64] + acc[64] + 32 A-fragment registers a thread, one
// block a SM (ptxas: 228-240 registers, no spills).
#include <cuda.h>          // CUtensorMap; the driver is reached through
#include <cudaTypedefs.h>  // the runtime's entry-point query, no -lcuda

#include "gemm_tile.cuh"

namespace {

using namespace repro::gemm;

constexpr int BM = 128;                     // two warpgroups of 64 rows
constexpr int THREADS = 2 * BM;
constexpr int TILE_BYTES = BM * BK;         // 128 rows x 128 e4m3
constexpr int A_STAGES = 5;                 // a ring: a tiles, their sa
constexpr int B_RING = 2;                   // b ring: a miss's b tile, its sb
constexpr int NB = 2;                       // cached f16 b tiles
constexpr int SLOT_BYTES = WH_BYTES + BN * 4;  // f16 b tile, its sb
constexpr int BOX_BYTES = 64 * BK;          // a warpgroup's rows of a tile
// [align to 1,024][a ring][b ring][sa ring][sb ring][NB slots][a full
// barrier a stage and warpgroup]
constexpr int SA_OFF = (A_STAGES + B_RING) * TILE_BYTES;
constexpr int SLOT_OFF = SA_OFF + (A_STAGES + B_RING) * BM * 4;
constexpr int BAR_OFF = SLOT_OFF + NB * SLOT_BYTES;
constexpr size_t SMEM = 1024 + BAR_OFF + A_STAGES * 2 * 8;
static_assert(BM == BN && NB == 2 && B_RING == 2,
              "the tags are two scalars; at most one miss a step");

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

// Box (128 bytes of C x 64 rows, 128-byte swizzle: row r's 16-byte chunk c
// in slot c ^ (r % 8), the layout load_a and convert_w read) at columns
// x.., rows y.. of an operand's tensor map -> smem dst, completing on bar.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(x), "r"(y) : "memory");
}

// The 128 threads of warpgroup wg (named barrier 1 + wg; 0 is the block's).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// The tensor cores' turn (named barriers 3 and 4, both warpgroups): a
// warpgroup waits for its turn, issues its step's wgmmas and passes the
// turn, so the two issue in alternation and one's promotion and stores run
// under the other's products.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(3 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - wg) : "memory");
}

template <bool BF16_OUT, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm_nt_fp8_kernel(const uint8_t* __restrict__ a,
                           const float* __restrict__ sa,
                           const uint8_t* __restrict__ b,
                           const float* __restrict__ sb,
                           const int* __restrict__ masked_m,
                           void* __restrict__ out,
                           const __grid_constant__ CUtensorMap a_map,
                           const __grid_constant__ CUtensorMap b_map,
                           int E, int M, int N, int C) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles start on 1,024-byte boundaries
  uint8_t* aring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* bring = aring + A_STAGES * TILE_BYTES;       // [B_RING] tiles
  float* sar = reinterpret_cast<float*>(aring + SA_OFF);  // [A_STAGES][BM]
  float* sbr = sar + A_STAGES * BM;                       // [B_RING][BN]
  uint8_t* slots = aring + SLOT_OFF;                      // [NB]
  uint64_t* full = reinterpret_cast<uint64_t*>(aring + BAR_OFF);  // [s][wg]
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, wt = tid & 127;
  const int nk = C / BK, tn = N / BN, tm = M / BM;
  const int panels = E * tn, G = gridDim.x;

  // the C steps expert e runs: all, or (MASKED) those with k*BK < masked_m[e]
  auto steps = [&](int e) {
    if (!MASKED) return nk;
    return min(nk, (max(__ldg(masked_m + e), 0) + BK - 1) / BK);
  };
  // How far the loads run ahead.  The b ring holds the misses' tiles in
  // turn, so the loader may refill an entry only once the product loop has
  // widened it.  At C <= NB * 128 a panel misses only in its first row
  // tile, so two misses of one entry are at least tm + 1 steps apart and
  // A_STAGES - 1 steps ahead is safe when tm >= A_STAGES; otherwise (C >
  // 256 turns the slots over every step, or few row tiles) one step.
  const bool deep = nk <= NB && tm >= A_STAGES;
  const int ahead = deep ? A_STAGES - 1 : B_RING - 1;

  // one arrival (the loading thread's) and the copies' bytes a phase
  if (tid < 2 * A_STAGES) mbar_init(full + tid, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // Loader: step lk of row tile li of panel lp, run ahead of the product
  // loop over the block's panels (blockIdx.x, + G, ...), past the experts
  // that run no step; one cp.async commit group (the scales) a step, empty
  // past the end.
  int lp = blockIdx.x, li = 0, lk = 0, ls = 0, lmiss = 0;  // ls: stage
  int ltag0 = -1, ltag1 = -1, le = lp / tn, ln0 = lp % tn * BN;
  int lns = steps(le);
  auto next_live = [&]() {
    while (lp < panels && lk >= lns) {
      lk = 0;
      if (lns == 0 || ++li == tm) {
        li = 0;
        lp += G;
        le = lp / tn;
        ln0 = lp % tn * BN;
        lns = lp < panels ? steps(le) : 0;
      }
    }
  };
  auto load_next = [&]() {
    if (lp < panels) {
      // the warpgroup's 64 rows of a (and on a miss of b): one copy-engine
      // box each, on the stage's full barrier; their scales by cp.async
      const int m0 = li * BM + 64 * wg, n0 = ln0 + 64 * wg, key = lp * nk + lk;
      const bool miss = ((lk & 1) ? ltag1 : ltag0) != key;
      const int bi = lmiss & 1;
      if (wt == 0) {
        uint64_t* bar = full + 2 * ls + wg;
        mbar_expect(bar, (miss ? 2 : 1) * BOX_BYTES);
        tma_load(&a_map, aring + ls * TILE_BYTES + 64 * wg * BK, bar, lk * BK,
                 le * M + m0);
        if (miss)
          tma_load(&b_map, bring + bi * TILE_BYTES + 64 * wg * BK, bar,
                   lk * BK, le * N + n0);
      }
      if (wt < 64)
        cp_async4(smem_addr(sar + ls * BM + 64 * wg + wt),
                  sa + ((size_t)le * M + m0 + wt) * nk + lk, true);
      if (miss) {  // the product loop will miss: bring b's sb too
        if (lk & 1) ltag1 = key; else ltag0 = key;
        ++lmiss;
        if (wt >= 64)
          cp_async4(smem_addr(sbr + bi * BN + 64 * wg + wt - 64),
                    sb + ((size_t)le * N + n0 + wt - 64) * nk + lk, true);
      }
      ++lk;
      ls = ls + 1 == A_STAGES ? 0 : ls + 1;
      next_live();
    }
    cp_async_commit();
  };
  next_live();
  for (int s = 0; s < ahead; ++s) load_next();

  const int fr = frag_row(tid);              // rows fr, fr + 8 of the tile
  int ctag0 = -1, ctag1 = -1, cmiss = 0;
  int cs = 0, phase = 0;                     // the step's stage, its parity
  float acc[64], part[64];
  uint32_t afr[8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  if (wg == 1) turn_pass(wg);                // warpgroup 0 goes first
  for (int p = blockIdx.x; p < panels; p += G) {
    const int e = p / tn, n0 = p % tn * BN, ns = steps(e);
    for (int m0 = 0; m0 < M; m0 += BM) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int k = 0; k < ns; ++k) {
        // this thread's copies of this step landed (ahead - 1 groups pending)
        if (deep) cp_async_wait<A_STAGES - 2>();
        else cp_async_wait<B_RING - 2>();
        mbar_wait(full + 2 * cs + wg, phase);
        wg_sync(wg);  // the warpgroup's copies landed; its last step is done
        load_next();
        // the warpgroup's 64 rows of the step's a tile
        const uint8_t* as = aring + cs * TILE_BYTES + 64 * wg * BK;
        uint8_t* slot = slots + (k & 1) * SLOT_BYTES;
        const int key = p * nk + k;
        if (((k & 1) ? ctag1 : ctag0) != key) {  // widen b into the slot
          if (k & 1) ctag1 = key; else ctag0 = key;
          // both warpgroups here: the slot's old products are done and
          // both halves of b have landed
          __syncthreads();
          const int bi = cmiss++ & 1;
          convert_w<THREADS, true>(bring + bi * TILE_BYTES, slot, tid);
          if (tid < BN)
            reinterpret_cast<float*>(slot + WH_BYTES)[tid] = sbr[bi * BN + tid];
          fence_async_smem();  // the f16 tile is a wgmma operand
          __syncthreads();
        }
        // widen the step's A fragments, then take the tensor cores' turn:
        // eight k16 chunks into part (started from zero), the turn passed
        // as soon as they are issued
#pragma unroll
        for (int i = 0; i < 8; ++i) load_a(as, i, tid, afr[i]);
        turn_wait(wg);
        fence_operands(afr);
        fence_operands(part);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < 8; ++i)
          wgmma_k16(part, afr[i], desc(smem_addr(slot) + i * 2 * CM, WH_SBO),
                    i);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        turn_pass(wg);
        wait_chunks<8>(afr, part);
        // acc += part * (sa[row] * sb[col]); columns 8j + 2(lane % 4) (+ 1)
        const float* sq = sar + cs * BM;
        const float ra = sq[fr], rb = sq[fr + 8];
        const float* scol =
            reinterpret_cast<const float*>(slot + WH_BYTES) + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 cb = *reinterpret_cast<const float2*>(scol + 8 * j);
          acc[4 * j] =
              __fmaf_rn(part[4 * j], __fmul_rn(ra, cb.x), acc[4 * j]);
          acc[4 * j + 1] =
              __fmaf_rn(part[4 * j + 1], __fmul_rn(ra, cb.y), acc[4 * j + 1]);
          acc[4 * j + 2] =
              __fmaf_rn(part[4 * j + 2], __fmul_rn(rb, cb.x), acc[4 * j + 2]);
          acc[4 * j + 3] =
              __fmaf_rn(part[4 * j + 3], __fmul_rn(rb, cb.y), acc[4 * j + 3]);
        }
        if (++cs == A_STAGES) {
          cs = 0;
          phase ^= 1;
        }
      }
      // the thread's rows m0 + fr (+ 8), columns n0 + 8j + 2(lane % 4) (+ 1)
      if constexpr (BF16_OUT) {
        // a quad of lanes holds a row's 8-column slices j = 0..15 as
        // bf16 pairs; a 4 x 4 transpose of words across the quad (two
        // xor shuffles) gives lane c the whole slices j = 4i + c, so each
        // lane stores 16 bytes and a quad 64 contiguous bytes of the row
        const int c = lane & 3, c0 = c & 1, c1 = c >> 1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) +
                             ((size_t)e * M + m0 + fr + 8 * h) * N + n0 + 8 * c;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t x[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const __nv_bfloat162 v = __floats2bfloat162_rn(
                  acc[4 * (4 * i + t) + 2 * h], acc[4 * (4 * i + t) + 2 * h + 1]);
              x[t] = *reinterpret_cast<const uint32_t*>(&v);
            }
            // lane bit 1: trade the words whose index bit 1 differs
            uint32_t r0 = __shfl_xor_sync(0xffffffffu, c1 ? x[0] : x[2], 2);
            uint32_t r1 = __shfl_xor_sync(0xffffffffu, c1 ? x[1] : x[3], 2);
            if (c1) { x[0] = r0; x[1] = r1; } else { x[2] = r0; x[3] = r1; }
            // lane bit 0: the same with index bit 0
            r0 = __shfl_xor_sync(0xffffffffu, c0 ? x[0] : x[1], 1);
            r1 = __shfl_xor_sync(0xffffffffu, c0 ? x[2] : x[3], 1);
            if (c0) { x[0] = r0; x[2] = r1; } else { x[1] = r0; x[3] = r1; }
            *reinterpret_cast<uint4*>(o + 32 * i) =
                make_uint4(x[0], x[1], x[2], x[3]);
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* o = static_cast<float*>(out) +
                     ((size_t)e * M + m0 + fr + 8 * h) * N + n0 + 2 * (lane & 3);
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<float2*>(o + 8 * j) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
  if (wg == 0) turn_wait(wg);  // warpgroup 1's last pass
}

// A row-major (rows, cols) e4m3 operand as a copy-engine tensor map: boxes
// of 128 bytes of a row x 64 rows, 128-byte swizzle.
// cuTensorMapEncodeTiled comes from the driver through the runtime.
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
  const cuuint32_t box[2] = {BK, 64}, unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool BF16_OUT, bool MASKED>
int launch(const void* a, const void* sa, const void* b, const void* sb,
           const void* masked_m, void* out, int E, int M, int N, int C,
           cudaStream_t st) {
  auto kern = grouped_gemm_nt_fp8_kernel<BF16_OUT, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // one persistent block a SM (its registers allow no second)
  const long panels = (long)E * (N / BN);
  if (panels == 0 || M == 0) return 0;
  CUtensorMap a_map = {}, b_map = {};  // C = 0: no step loads; zeros out
  int r = C ? tensor_map(&a_map, a, (long)E * M, C) : 0;
  if (!r && C) r = tensor_map(&b_map, b, (long)E * N, C);
  if (r) return r;
  const int grid = (int)(panels < sms ? panels : sms);
  kern<<<grid, THREADS, SMEM, st>>>((const uint8_t*)a, (const float*)sa,
                                    (const uint8_t*)b, (const float*)sb,
                                    (const int*)masked_m, out, a_map, b_map,
                                    E, M, N, C);
  return (int)cudaGetLastError();
}

template <bool MASKED>
int launch_out(const void* a, const void* sa, const void* b, const void* sb,
               const void* masked_m, void* out, int out_bf16, int E, int M,
               int N, int C, cudaStream_t st) {
  if (out_bf16)
    return launch<true, MASKED>(a, sa, b, sb, masked_m, out, E, M, N, C, st);
  return launch<false, MASKED>(a, sa, b, sb, masked_m, out, E, M, N, C, st);
}

}  // namespace

// masked_m: (E,) int32 live-token counts on the device (masked layout), or
// null (padded layout).
REPRO_EXPORT int repro_grouped_gemm_nt_fp8(const void* a, const void* sa,
                                           const void* b, const void* sb,
                                           const void* masked_m, void* out,
                                           int out_bf16, int E, int M, int N,
                                           int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // the tensor maps and the 16-byte stores move 16-byte-aligned chunks
  if (!repro::gemm::aligned16(a, b) || !repro::gemm::aligned16(out, out))
    return (int)cudaErrorMisalignedAddress;
  if (masked_m)
    return launch_out<true>(a, sa, b, sb, masked_m, out, out_bf16, E, M, N, C,
                            st);
  return launch_out<false>(a, sa, b, sb, masked_m, out, out_bf16, E, M, N, C,
                           st);
}
