// Fused permute + pad of an FP8 payload and its scale rows.
//
// Replaces the TPU kernel
// repro/kernels/fused_permute_pad.py::fused_permute_pad_pallas
// (pallas_call at fused_permute_pad.py:52; body _permute_kernel :23).
// out[i] = x[row_map[i]] and sout[i] = s[row_map[i]] for every output row;
// a row_map entry outside [0, T) (-1 by convention) writes payload 0 and
// scale 1.0, the bits quantizing a zero row produces.
//
// Bound on H100: bytes.  Each output row is one gathered read of D + 4*D/128
// bytes and one write.  Design: one block per output row; the row index is
// read once by the block (the TPU kernel's scalar prefetch becomes a plain
// load), then 256 threads move the payload 16 bytes at a time (a 4096-byte
// row is one 16-byte load and store per thread, fully coalesced) and the
// first D/128 threads move the scales.  Payload bytes move as integers, so
// NaN encodings pass through unchanged.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
permute_pad_kernel(const uint8_t* __restrict__ x, const float* __restrict__ s,
                   const int32_t* __restrict__ row_map,
                   uint8_t* __restrict__ xo, float* __restrict__ so, int T,
                   int D, int Ds) {
  const long i = blockIdx.x;
  const int src = row_map[i];
  const bool valid = src >= 0 && src < T;
  const int chunks = D / 16;
  uint4* dst = reinterpret_cast<uint4*>(xo + i * D);
  if (valid) {
    const uint4* from = reinterpret_cast<const uint4*>(x + (long)src * D);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) dst[c] = from[c];
  } else {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) dst[c] = zero;
  }
  for (int c = threadIdx.x; c < Ds; c += blockDim.x)
    so[i * Ds + c] = valid ? s[(long)src * Ds + c] : 1.f;
}

}  // namespace

REPRO_EXPORT int repro_permute_pad(const void* x, const void* s,
                                   const void* row_map, void* xo, void* so,
                                   int T, int D, int Ds, int n_out,
                                   void* stream) {
  permute_pad_kernel<<<(unsigned)n_out, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const float*)s, (const int32_t*)row_map,
      (uint8_t*)xo, (float*)so, T, D, Ds);
  return (int)cudaGetLastError();
}
