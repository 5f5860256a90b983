// Fused permute + pad of an FP8 payload and its scale rows.
//
// Replaces the TPU kernel
// repro/kernels/fused_permute_pad.py::fused_permute_pad_pallas
// (pallas_call at fused_permute_pad.py:52; body _permute_kernel :23).
// out[i] = x[row_map[i]] and sout[i] = s[row_map[i]] for every output row;
// a row_map entry outside [0, T) (-1 by convention) writes payload 0 and
// scale 1.0, the bits quantizing a zero row produces.
//
// Bound on H100: bytes.  A live output row is one gathered read of
// D + 4 Ds bytes and one write; a padding row is a write.  The rate a
// device copy reaches on the same traffic (chip_smoke.py's copy_ms) is the
// practical ceiling; the serve shapes (640 and 1,024 rows) sit on the
// launch floor instead.  The first design gave a row to a block of 256
// threads, each a dependent row_map load and then one 16-byte load: 0.72-
// 0.85 of the bound at the train shapes.  This one gives a row to two
// warps: every lane reads the row's row_map entry (one broadcast load),
// then starts all its 16-byte loads of the row (4 a lane for a 4096-byte
// row) and its scale before it stores any, so a SM holds up to 32 rows in
// flight where it held 8.  Blocks hold 2 rows in a small launch, spreading
// it over more SMs, and 4 from 4,096 rows.  A padding row skips the read
// and stores zeros and scale 1.0.  A row of more than 256 chunks of 16
// bytes (or 64 scales) goes in segments, so any D % 16 == 0 works.  A
// persistent grid with row_map read a run of rows at a time, one warp or
// two rows a warp, was slower on the card at five of the six main-path
// shapes.  Payload bytes move as integers, so NaN encodings pass through
// unchanged.
#include "common.cuh"

namespace {

constexpr int LANES = 64;         // threads a row
constexpr int SEG = 256 / LANES;  // 16-byte chunks a thread a segment

// ROWS: rows a block (2 or 4).
template <int ROWS>
__global__ void __launch_bounds__(ROWS * LANES)
permute_pad_kernel(const uint8_t* __restrict__ x, const float* __restrict__ s,
                   const int32_t* __restrict__ row_map,
                   uint8_t* __restrict__ xo, float* __restrict__ so, int T,
                   int D, int Ds, int n_out) {
  const int t = threadIdx.x % LANES;
  const long row = (long)blockIdx.x * ROWS + threadIdx.x / LANES;
  if (row >= n_out) return;
  const int m = row_map[row];
  const bool live = m >= 0 && m < T;
  const long src = live ? m : 0;
  const int chunks = D / 16;
  const int segs = max((chunks + 255) / 256, (Ds + LANES - 1) / LANES);
  const uint4* from = reinterpret_cast<const uint4*>(x + src * D);
  uint4* to = reinterpret_cast<uint4*>(xo + row * D);
  for (int g = 0; g < segs; ++g) {
    const int c0 = g * 256 + t, sc = g * LANES + t;
    uint4 v[SEG];
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      const int c = c0 + LANES * i;
      v[i] = live && c < chunks ? from[c] : make_uint4(0u, 0u, 0u, 0u);
    }
    const float sv = live && sc < Ds ? s[src * Ds + sc] : 1.f;
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      const int c = c0 + LANES * i;
      if (c < chunks) to[c] = v[i];
    }
    if (sc < Ds) so[row * Ds + sc] = sv;
  }
}

template <int ROWS>
int launch(const void* x, const void* s, const void* row_map, void* xo,
           void* so, int T, int D, int Ds, int n_out, cudaStream_t st) {
  permute_pad_kernel<ROWS>
      <<<(unsigned)((n_out + ROWS - 1) / ROWS), ROWS * LANES, 0, st>>>(
          (const uint8_t*)x, (const float*)s, (const int32_t*)row_map,
          (uint8_t*)xo, (float*)so, T, D, Ds, n_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Two rows a block below 4,096 output rows (the serve send and decode
// gather: more blocks to spread a latency-bound launch over the SMs); four
// from there on (the serve prefill grouping and the train shapes).
REPRO_EXPORT int repro_permute_pad(const void* x, const void* s,
                                   const void* row_map, void* xo, void* so,
                                   int T, int D, int Ds, int n_out,
                                   void* stream) {
  if (n_out == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_out < 4096)
    return launch<2>(x, s, row_map, xo, so, T, D, Ds, n_out, st);
  return launch<4>(x, s, row_map, xo, so, T, D, Ds, n_out, st);
}
