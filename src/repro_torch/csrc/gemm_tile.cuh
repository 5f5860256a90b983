// The tensor-core tile loop of the port's NN FP8 grouped GEMMs, shared by
// grouped_gemm_fp8.cu (bf16 out, quantizing epilogue, masked or padded)
// and grouped_gemm_swiglu_quant.cu (the fused SwiGLU GEMM-1), so that the
// fused kernel's gate and up accumulators are, bit for bit, the columns the
// unfused GEMM computes.  The NT Wgrad kernel (grouped_gemm_nt_fp8.cu)
// runs its own loop on the widening and wgmma helpers here (convert_w,
// load_a, wgmma_k16, wait_chunks, frag_row).
//
// A block of BM/64 warpgroups (128 threads each) computes a BM x 128
// output tile of one expert, a 64-row slice per warpgroup, for each of NW
// weight column tiles (1, or 2 for [gate | up]).
//   Loads: every thread issues 16-byte cp.async copies into a ring of
//   STAGES shared-memory stages, STAGES - 1 K steps ahead of the product,
//   so the loads of later steps overlap the work on this one.  Operands
//   arrive as e4m3 (a byte an element moved from device memory).  Rows >=
//   C are zero-filled by the copy (src-size 0): an expert never reads the
//   next expert's rows.
//   Arithmetic: each e4m3 operand is widened exactly to f16 on its way to
//   the tensor cores, and each 128-deep K step is eight
//   wgmma.m64n128k16.f32.f16.f16 instructions: x as the A fragment in
//   registers (converted from the staged bytes), w as a K-major f16 tile in
//   shared memory.  An e4m3 x e4m3 product is exact in that path and the
//   sum is kept in f32.  FP8 wgmma (e4m3 x e4m3 -> f32) is not used: its
//   adder keeps ~14 bits, so the quantizing epilogue's codes and po2
//   scales departed from the twin's beyond the gates (payload codes within
//   one on < 0.1% of lanes, scales equal) with the partial promoted every
//   128 k and every 32 k alike: the loss is inside each instruction.
//   Layouts: x and a weight stored (E, N, K) (W_TRANS) are K-major and are
//   staged row by row, each row's 16-byte chunk c in slot c ^ (row % 8), so
//   the copies and the 4-byte reads of the conversions hit distinct banks.
//   A weight stored (E, K, N) is N-major: it is staged row by row (rows
//   144 bytes apart) and transposed while it is widened, with byte
//   permutes.  The f16 w tile is K-major in 8-row x 16-byte core matrices
//   as wgmma reads it, its 8-row groups 2,064 bytes apart so that the
//   conversions' writes hit 32 distinct banks a warp.  Neither weight is
//   ever transposed in device memory.
//   Overlap: a block of one weight tile and two warpgroups (C > 64)
//   double-buffers its f16 tile and widens step k+1's while the tensor
//   cores run step k; the others widen, then multiply, and overlap across
//   the two blocks an SM holds (BM = 64, decode) or not at all (the fused
//   GEMM-1, whose two weight tiles fill the shared memory).
//   Promotion: the step's partial, started from zero, is folded into the
//   f32 accumulator with the step's scales: acc = fma(part, sx[row] * sw,
//   acc), the reference's acc += partial * (sx * sw)
//   (grouped_gemm_fp8.py:71) with one rounding.  The scales travel with
//   their step's tiles through the ring, so no register waits on device
//   memory across the wgmmas.
// Accumulator layout (the wgmma D fragment): thread t of a warpgroup holds
// rows 16 * (t / 32) + (t % 32) / 4 (+ 8) of the warpgroup's 64 and, for
// j = 0..15, columns 8j + 2 * (t % 4) (+ 1): acc[4j + 2h + c] is row
// (+ 8h), column (+ c).  A row's 128 columns sit in one quad of lanes.
#pragma once

#include "common.cuh"

namespace repro {
namespace gemm {

constexpr int BN = 128;
constexpr int BK = 128;                 // == the scale tile
static_assert(BK == TILE, "one K step is one scale tile");
constexpr int CM = 128;                 // bytes of a core matrix (8 x 16)
constexpr int STAGE_LD = BN + 16;       // row stride of a staged (K, N) tile
constexpr int WH_SBO = 16 * CM + 16;    // 8-row group stride, f16 w tile
constexpr int WH_BYTES = (BN / 8) * WH_SBO;

template <bool W_TRANS>
__host__ __device__ constexpr int w_stage_bytes() {
  return W_TRANS ? BN * BK : BK * STAGE_LD;
}

// Double-buffered f16 tiles under a 4-stage ring for a block of one weight
// tile and two warpgroups (one block an SM); otherwise one f16 tile under
// a 3-stage ring (BM = 64: two blocks an SM).
template <int BM, int NW>
__host__ __device__ constexpr int wh_buffers() {
  return (BM == 128 && NW == 1) ? 2 : 1;
}

template <int BM, int NW>
__host__ __device__ constexpr int stages() {
  return wh_buffers<BM, NW>() == 2 ? 4 : 3;
}

// A stage's scales: the block's BM row scales of the step, then NW block
// scales, padded to 16 bytes.
template <int BM>
__host__ __device__ constexpr int scale_stage_bytes() {
  return (BM + 4) * 4;
}

template <int BM, bool W_TRANS, int NW>
constexpr size_t smem_bytes() {
  return (size_t)stages<BM, NW>() * (BM * BK + NW * w_stage_bytes<W_TRANS>() +
                                     scale_stage_bytes<BM>())
         + wh_buffers<BM, NW>() * NW * WH_BYTES;
}

// The 128-row group (the reference's BM = 128 tile, grouped_gemm_fp8.py:53)
// holding row m0 is dead when it starts at or beyond masked_m[e].
__device__ __forceinline__ bool group_dead(const int* masked_m, int e,
                                           int m0) {
  return (m0 / TILE) * TILE >= __ldg(masked_m + e);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// 4 bytes global -> shared, asynchronous; zero-filled when !ok.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared-memory writes of this thread become visible to the async proxy
// (wgmma's operand reads).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x tile of step kb: BM rows x 128 bytes, row r's chunk c in slot
// c ^ (r % 8); rows >= C zero.  Eight threads copy one 128-byte row.
template <int BM>
__device__ __forceinline__ void load_x(const uint8_t* xe, int m0, int C,
                                       int K, int kb, uint8_t* xs, int tid) {
  const uint32_t base = smem_addr(xs);
#pragma unroll
  for (int c = tid; c < BM * 8; c += 2 * BM) {
    const int r = c >> 3, kc = c & 7;
    const bool ok = m0 + r < C;
    const uint8_t* src =
        xe + (ok ? (size_t)(m0 + r) * K + (size_t)kb * BK + kc * 16 : 0);
    cp_async16(base + r * BK + ((kc ^ (r & 7)) << 4), src, ok);
  }
}

// w tile of step kb, columns n0 .. n0+127.  W_TRANS (stored (N, K)): rows
// n (k contiguous), swizzled as x.  Stored (K, N): rows k, STAGE_LD bytes
// apart.
template <int THREADS, bool W_TRANS>
__device__ __forceinline__ void load_w(const uint8_t* we, int K, int N,
                                       int n0, int kb, uint8_t* ws,
                                       int tid) {
  const uint32_t base = smem_addr(ws);
#pragma unroll
  for (int c = tid; c < BK * 8; c += THREADS) {
    const int r = c >> 3, cc = c & 7;
    if (W_TRANS)
      cp_async16(base + r * BK + ((cc ^ (r & 7)) << 4),
                 we + (size_t)(n0 + r) * K + (size_t)kb * BK + cc * 16, true);
    else
      cp_async16(base + r * STAGE_LD + cc * 16,
                 we + ((size_t)kb * BK + r) * N + n0 + cc * 16, true);
  }
}

// Two e4m3 (the low 16 bits of w, low byte first) -> f16x2, exact.
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t w) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w & 0xffff), __NV_E4M3);
  return (uint32_t)h.x | ((uint32_t)h.y << 16);
}

// The f16 operands' K order inside each 16-deep chunk.  The f16 wgmma
// A fragment gives lane c (= lane % 4) the chunk's k 2c, 2c+1 (register 0)
// and 8+2c, 9+2c (register 2); a 4-byte read of x gives it k 4c .. 4c+3.
// So the kernel feeds e4m3 k 4c, 4c+1 at the instruction's k 2c, 2c+1 and
// k 4c+2, 4c+3 at 8+2c, 9+2c, in x and in w alike: the same product and
// sum, its terms in another order.
//
// Four e4m3 of w row n at k 16g + 4c .. (the 32-bit word) -> the f16
// K-major tile (WH_SBO between 8-row groups, CM between 8-deep k groups).
__device__ __forceinline__ void store_w4(uint8_t* wh, int n, int g, int c,
                                         uint32_t word) {
  uint8_t* p = wh + (n >> 3) * WH_SBO + 2 * g * CM + (n & 7) * 16 + 4 * c;
  *reinterpret_cast<uint32_t*>(p) = e4m3x2_to_f16x2(word);
  *reinterpret_cast<uint32_t*>(p + CM) = e4m3x2_to_f16x2(word >> 16);
}

// Staged e4m3 w tile -> f16 K-major tile at wh.  Every 4-byte read and
// write of a warp hits 32 distinct banks.
//   W_TRANS (staged K-major, swizzled): task (q, g) covers rows n = 8q ..
//   8q+7 and k 16g .. 16g+15; lane (p = lane / 4, c = lane % 4) reads row
//   8q + p's word c of chunk g (bank 4(g ^ p) + c) and writes it converted
//   (bank 4(q + p) + c).
//   Stored (K, N) (staged row-major, STAGE_LD apart): task (g, h) covers k
//   16g .. 16g+15 and n 32h .. 32h+31; lane (kq = lane / 8, nw = 8h +
//   lane % 8) reads a 4 x 4 byte block (rows 16g + 4kq + t, n-word nw),
//   transposes it with byte permutes and writes four rows n = 4nw + j.
//   Lanes kq >= 2 read their rows rotated by two, so the reads (bank 4k +
//   nw mod 32 at 36 words a row) and the writes (bank 4(n/8 + n%8) + kq at
//   516 words a group) are conflict-free.
template <int THREADS, bool W_TRANS>
__device__ __forceinline__ void convert_w(const uint8_t* st, uint8_t* wh,
                                          int tid) {
  const int lane = tid & 31;
  if (W_TRANS) {
    const int p = lane >> 2, c = lane & 3;
#pragma unroll 4
    for (int task = tid >> 5; task < 128; task += THREADS / 32) {
      const int q = task >> 3, g = task & 7;
      store_w4(wh, 8 * q + p, g, c,
               *reinterpret_cast<const uint32_t*>(
                   st + (8 * q + p) * BK + ((g ^ p) << 4) + 4 * c));
    }
    return;
  }
  const int kq = lane >> 3, rot = (kq >> 1) * 2;
#pragma unroll 2
  for (int task = tid >> 5; task < 32; task += THREADS / 32) {
    const int g = task >> 2, nw = 8 * (task & 3) + (lane & 7);
    const uint8_t* src = st + (16 * g + 4 * kq) * STAGE_LD + 4 * nw;
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(src + ((i + rot) & 3) *
                                                          STAGE_LD);
    if (rot) {  // back to row order: r[t] is row 16g + 4kq + t
      uint32_t t0 = r[0], t1 = r[1];
      r[0] = r[2]; r[1] = r[3]; r[2] = t0; r[3] = t1;
    }
    const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
    store_w4(wh, 4 * nw, g, kq, __byte_perm(lo01, lo23, 0x5410));
    store_w4(wh, 4 * nw + 1, g, kq, __byte_perm(lo01, lo23, 0x7632));
    store_w4(wh, 4 * nw + 2, g, kq, __byte_perm(hi01, hi23, 0x5410));
    store_w4(wh, 4 * nw + 3, g, kq, __byte_perm(hi01, hi23, 0x7632));
  }
}

// The f16 A fragment of k16 chunk j for the warpgroup's 64 rows at xs
// (staged x): rows 16 * warp + lane / 4 (+ 8), e4m3 k 16j + 4c .. 4c+3
// (c = lane % 4) converted (registers 0 / 2: row, 1 / 3: row + 8).  Reads
// hit banks 4 * (j ^ row % 8) + c: conflict-free.
__device__ __forceinline__ void load_a(const uint8_t* xs, int j, int tid,
                                       uint32_t (&a)[4]) {
  const int lane = tid & 31, r = 16 * ((tid >> 5) & 3) + (lane >> 2);
  const uint8_t* p = xs + r * BK + ((j ^ (r & 7)) << 4) + 4 * (lane & 3);
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + 8 * BK);
  a[0] = e4m3x2_to_f16x2(w0);
  a[1] = e4m3x2_to_f16x2(w1);
  a[2] = e4m3x2_to_f16x2(w0 >> 16);
  a[3] = e4m3x2_to_f16x2(w1 >> 16);
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset (next core matrix along K) CM, stride byte offset (next 8-row
// group) sbo, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(CM >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// d (+)= A (64 x 16 f16, registers) . B^T (128 x 16 f16, K-major at b),
// f32 accumulator; accumulate = 0 starts from zero.
__device__ __forceinline__ void wgmma_k16(float (&d)[64],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Issue k16 chunks c0 .. c0+N-1 of one K step for the warpgroup: their A
// fragments converted from the staged x at xs, B from the f16 w tile at
// wh, into part (started from zero at chunk 0); committed, not waited for
// (wait_chunks ends them), so the block can widen the next step's w tile
// meanwhile.  Whether a step is issued as one group of eight or two of
// four, the instructions, their order and their operands are the same.
template <int N>
__device__ __forceinline__ void issue_chunks(const uint8_t* xs,
                                             const uint8_t* wh, int c0,
                                             int tid, uint32_t (&a)[N][4],
                                             float (&part)[64]) {
  const uint32_t b = smem_addr(wh);
#pragma unroll
  for (int i = 0; i < N; ++i) load_a(xs, c0 + i, tid, a[i]);
  fence_operands(a);
  fence_operands(part);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < N; ++i)
    wgmma_k16(part, a[i], desc(b + (c0 + i) * 2 * CM, WH_SBO), c0 + i);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_chunks(uint32_t (&a)[N][4],
                                            float (&part)[64]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(part);
  fence_operands(a);
}

// The product of one K step, waited for: two groups of four chunks, so
// only 16 A registers are live (the fused GEMM-1 holds two accumulators).
__device__ __forceinline__ void step_product(const uint8_t* xs,
                                             const uint8_t* wh, int tid,
                                             float (&part)[64]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t a[4][4];
    issue_chunks<4>(xs, wh, 4 * half, tid, a, part);
    wait_chunks<4>(a, part);
  }
}

// acc += part * f, one rounding; fa for the thread's first row, fb for the
// row 8 below.
__device__ __forceinline__ void promote(float (&acc)[64],
                                        const float (&part)[64], float fa,
                                        float fb) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[4 * j] = __fmaf_rn(part[4 * j], fa, acc[4 * j]);
    acc[4 * j + 1] = __fmaf_rn(part[4 * j + 1], fa, acc[4 * j + 1]);
    acc[4 * j + 2] = __fmaf_rn(part[4 * j + 2], fb, acc[4 * j + 2]);
    acc[4 * j + 3] = __fmaf_rn(part[4 * j + 3], fb, acc[4 * j + 3]);
  }
}

// The block-local row of a thread's first accumulator row.
__device__ __forceinline__ int frag_row(int tid) {
  return 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);
}

// The K loop of one block: acc[w] (the thread's fragment of the BM x 128
// tile) = sum over K steps kb of (x rows m0.. . w column tile nblk[w]) *
// (sx[row, kb] * sw[kb, nblk[w]]).  Rows >= C read as zero and take scale
// 0.  Every thread of the block calls it.
template <int BM, bool W_TRANS, int NW>
__device__ __forceinline__ void mainloop(const uint8_t* __restrict__ xe,
                                         const float* __restrict__ sxe,
                                         const uint8_t* __restrict__ we,
                                         const float* __restrict__ swe,
                                         int m0, int C, int K, int N,
                                         const int (&nblk)[NW], uint8_t* smem,
                                         float (&acc)[NW][64]) {
  constexpr int THREADS = 2 * BM, STAGES = stages<BM, NW>();
  constexpr int XB = BM * BK, WB = w_stage_bytes<W_TRANS>();
  constexpr int SB = scale_stage_bytes<BM>();
  uint8_t* xs = smem;                          // [STAGES][XB] e4m3
  uint8_t* ws = smem + STAGES * XB;            // [STAGES][NW][WB] e4m3
  float* ss = reinterpret_cast<float*>(ws + STAGES * NW * WB);  // [STAGES][SB]
  uint8_t* wh = ws + STAGES * (NW * WB + SB);  // [buffers][NW][WH_BYTES] f16
  const int tid = threadIdx.x, nk = K / BK, nb = N / BN;
  const int fr = frag_row(tid);

#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[w][i] = 0.f;

  // A stage is step kb's x tile, w tile(s) and scales (the promotion's
  // operands travel with the tiles, so no register waits on device memory
  // across the wgmmas); rows >= C take scale 0.
  auto load = [&](int kb) {
    const int s = kb % STAGES;
    load_x<BM>(xe, m0, C, K, kb, xs + s * XB, tid);
#pragma unroll
    for (int w = 0; w < NW; ++w)
      load_w<THREADS, W_TRANS>(we, K, N, nblk[w] * BN, kb,
                               ws + (s * NW + w) * WB, tid);
    const uint32_t sdst = smem_addr(ss + s * (SB / 4));
    if (tid < BM) {
      const bool ok = m0 + tid < C;
      cp_async4(sdst + 4 * tid, sxe + (ok ? (size_t)(m0 + tid) * nk + kb : 0),
                ok);
    } else if (tid < BM + NW) {
      const int w = tid - BM;
      cp_async4(sdst + 4 * tid,
                swe + (W_TRANS ? (size_t)nblk[w] * nk + kb
                               : (size_t)kb * nb + nblk[w]),
                true);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();  // one group a step, empty past the end
  }

  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  const uint8_t* xw = xs + (tid >> 7) * 64 * BK;  // the warpgroup's rows
  // acc[w] += part * (sx[row] * sw[w]) with step kb's staged scales
  auto promote_step = [&](int kb, int w) {
    const float* sc = ss + (kb % STAGES) * (SB / 4);
    promote(acc[w], part, __fmul_rn(sc[fr], sc[BM + w]),
            __fmul_rn(sc[fr + 8], sc[BM + w]));
  };

  if constexpr (wh_buffers<BM, NW>() == 2) {
    // Step kb: its f16 w tile (buffer kb % 2) was widened during step
    // kb-1; the wgmmas of kb run while the block widens kb+1's.
    cp_async_wait<STAGES - 2>();  // step 0 landed
    __syncthreads();
    convert_w<THREADS, W_TRANS>(ws, wh, tid);
    fence_async_smem();
    uint32_t a[8][4];
    for (int kb = 0; kb < nk; ++kb) {
      cp_async_wait<STAGES - 3>();  // this thread's copies of kb+1 landed
      __syncthreads();  // all landed; kb's f16 tile is whole; kb-1 is done
      issue_chunks<8>(xw + (kb % STAGES) * XB, wh + (kb & 1) * WH_BYTES, 0,
                      tid, a, part);
      if (kb + STAGES - 1 < nk) load(kb + STAGES - 1);  // into kb-1's stage
      cp_async_commit();
      if (kb + 1 < nk) {
        convert_w<THREADS, W_TRANS>(ws + ((kb + 1) % STAGES) * WB,
                                    wh + ((kb + 1) & 1) * WH_BYTES, tid);
        fence_async_smem();  // the f16 tile is a wgmma operand
      }
      wait_chunks<8>(a, part);
      promote_step(kb, 0);
    }
  } else {
    for (int kb = 0; kb < nk; ++kb) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of kb landed
      __syncthreads();  // everyone's landed; step kb-1's reads are done
      if (kb + STAGES - 1 < nk) load(kb + STAGES - 1);
      cp_async_commit();
      const int s = kb % STAGES;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        convert_w<THREADS, W_TRANS>(ws + (s * NW + w) * WB,
                                    wh + w * WH_BYTES, tid);
      fence_async_smem();  // the f16 tiles, written here, are wgmma operands
      __syncthreads();
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        step_product(xw + s * XB, wh + w * WH_BYTES, tid, part);
        promote_step(kb, w);
      }
    }
  }
}

// bf16 stores of the thread's fragment: rows row_a, row_a + 8 (< C) of
// the expert's (C, N) output, columns n0 + 8j + 2 * (lane % 4) (+ 1).
__device__ __forceinline__ void store_bf16(const float (&v)[64],
                                           __nv_bfloat16* oe, int row_a,
                                           int C, int N, int n0, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row >= C) continue;
    __nv_bfloat16* o = oe + (size_t)row * N + n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
  }
}

// Quantize the thread's two fragment rows: a row's 128 values sit in one
// quad of lanes, so the amax is the thread's 32 and two shuffles; then the
// bit-built po2 scale and a saturating RNE cast of v / s into the
// expert's (C, N) payload and (C, N/128) scales at column tile nblk.
// Every lane calls it (the shuffles); rows >= C write nothing.
__device__ __forceinline__ void quantize_rows_store(const float (&v)[64],
                                                    uint8_t* qe, float* se,
                                                    int row_a, int C, int N,
                                                    int nblk, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      amax = nan_max(amax, fabsf(v[4 * j + 2 * h]));
      amax = nan_max(amax, fabsf(v[4 * j + 2 * h + 1]));
    }
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
    const int row = row_a + 8 * h;
    if (row >= C) continue;
    const float sc = po2_scale(amax);
    uint8_t* q = qe + (size_t)row * N + nblk * BN + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint16_t*>(q + 8 * j) = (uint16_t)(
          to_e4m3(__fdiv_rn(v[4 * j + 2 * h], sc)) |
          (to_e4m3(__fdiv_rn(v[4 * j + 2 * h + 1], sc)) << 8));
    if ((lane & 3) == 0) se[(size_t)row * (N / BN) + nblk] = sc;
  }
}

// What a dead 128-row group writes over the block's rows m0 .. m0+BM-1
// (< C) and columns n0 .. n0+127: zeros of `elt` bytes each and, with a
// scale array, scale 1.0 at column tile nblk -- the bits the padded
// kernels write for zero rows (bf16 +0; e4m3 payload 0 with scale 1.0).
template <int BM>
__device__ __forceinline__ void write_dead_tile(void* out, int elt, float* sout,
                                                int e, int m0, int C, int N,
                                                int n0, int nblk, int tid) {
  constexpr int THREADS = 2 * BM;
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

// The launchers' row tile: one warpgroup for C <= 64 (decode), else two
// (a block is one 128-row masking group).
inline int block_rows(int C) { return C <= 64 ? 64 : 128; }

// cp.async moves 16-byte chunks: every operand base must be 16-byte aligned.
inline bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

}  // namespace gemm
}  // namespace repro
