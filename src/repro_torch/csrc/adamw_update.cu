// The fused AdamW update of one chunk of one parameter leaf, in place.
//
// Not a TPU kernel: the reference's optimizer is XLA
// (repro/optim/adamw.py:38-49, :110-162).  One launch reads the gradient
// (bf16, or the f32 sums of gradient accumulation), the clip factor (a
// device scalar: no host sync), m, v and the master weights, runs
// adamw_math in f32, and writes m, v, the master and the parameter (bf16,
// or f32 for the leaves the model keeps in f32: norms, the router).
//
// Each state leaf has one of four encodings (dist/opt_state.py):
//   f32, bf16   leaf-shaped, element i at flat index i;
//   e4m3, f16   flat (rows, 128) payload, zero-padded at the tail, times a
//               po2 scale a row (the f16 master normalised to (-1, 1]).
// The master may be absent (master_weights=False): the update then starts
// from the parameter.  The FP8-split policy is e4m3 m, bf16 v, f16
// master; f32 everywhere is the default state.
//
// One warp updates one 128-element row: lane j holds elements j, j+32,
// j+64, j+96, so every load and store of the warp is one contiguous run.
// An e4m3 or f16 leaf needs the row amax of the new value before it can
// encode it: a warp shuffle reduction, NaN-propagating as torch.amax.  The
// tail row of a leaf whose size is not a multiple of 128 updates only its
// live elements and treats the rest as the reference's zero padding (0
// in the amax, 0 in the payload).
//
// Bit for bit the plain twin on the card (kernels/adamw_update.py): every
// rounding is explicit (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn,
// so nothing contracts into an fma), in adamw_math's order, and a division
// by the bias correction (a Python scalar there, which ATen's CUDA
// division turns into a multiply by its f32 reciprocal) is the same
// multiply here.  Decoding a payload is exact (a po2 scale); encoding is
// the port's exact po2 scale from the bits of the amax, then an RNE cast.
//
// Skip-step: with `flags` given and (*flags & skip_mask) != 0 the launch
// returns before any store, so a step the guardrails refuse leaves every
// byte as it was (the reference keeps its previous state instead).
//
// What bounds it on H100: bytes.  f32 state reads the gradient (2 B), m,
// v and the master (12 B) and writes them back with the parameter (14 B):
// 28 B an element; the split state 14 B an element and 16 B a row of
// scales (two scales, each read and written).  This first design is a
// simple one: one pass, no vector loads.
#include "common.cuh"

namespace {

enum Kind : int { F32 = 0, BF16 = 1, E4M3 = 2, F16 = 3, NONE = -1 };

constexpr int WARPS = 8;          // rows a block

struct Args {
  const void* g;                  // gradient chunk
  int g_f32;                      // 1: f32 sums, 0: bf16
  const float* clip;              // device scalar
  const int* flags;               // device scalar or null
  int skip_mask;
  void* m; float* m_scale; int m_kind;
  void* v; float* v_scale; int v_kind;
  void* w; float* w_scale; int w_kind;
  void* p;                        // the parameter chunk
  int p_f32;                      // 1: f32 parameter, 0: bf16
  long long n;                    // live elements of the chunk
  float b1, omb1, b2, omb2, inv_b1c, inv_b2c, eps, wd, lr;
};

__device__ __forceinline__ float load(int kind, const void* base,
                                      long long i, float scale) {
  switch (kind) {
    case F32: return static_cast<const float*>(base)[i];
    case BF16: return __bfloat162float(
        static_cast<const __nv_bfloat16*>(base)[i]);
    case E4M3: {
      __nv_fp8_e4m3 q;
      q.__x = static_cast<const __nv_fp8_storage_t*>(base)[i];
      return __fmul_rn(static_cast<float>(q), scale);
    }
    default: return __fmul_rn(__half2float(
        static_cast<const __half*>(base)[i]), scale);
  }
}

// amax / fmax's po2 for the f16 master (fmax 1: r is amax itself), as
// repro_torch/core/fp8.py::po2_scale(amax, 1.0)
__device__ __forceinline__ float po2_scale_unit(float amax) {
  if (!(amax >= 1.17549435e-38f)) return 1.f;
  const int bits = __float_as_int(amax);
  const int biased = (bits >> 23) & 0xff;
  int e = (bits & 0x7fffff) == 0 ? biased - 127 : biased - 126;
  e = min(max(e, -126), 126);
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ float warp_amax(float a) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    a = repro::nan_max(a, __shfl_xor_sync(~0u, a, o));
  return a;
}

// Encode the four values of a lane (zeros where not live) into leaf
// `kind`; a scaled kind writes the row's scale from lane 0.
__device__ __forceinline__ void store(int kind, void* base, float* scales,
                                      long long row, int lane,
                                      const float (&x)[4],
                                      const bool (&live)[4]) {
  const long long r0 = row * repro::TILE;
  if (kind == F32 || kind == BF16) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!live[k]) continue;
      const long long i = r0 + lane + 32 * k;
      if (kind == F32) static_cast<float*>(base)[i] = x[k];
      else static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x[k]);
    }
    return;
  }
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) a = repro::nan_max(a, fabsf(x[k]));
  a = warp_amax(a);
  const float sc = kind == E4M3 ? repro::po2_scale(a) : po2_scale_unit(a);
  if (lane == 0) scales[row] = sc;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = r0 + lane + 32 * k;
    const float q = __fdiv_rn(x[k], sc);
    if (kind == E4M3)
      static_cast<uint8_t*>(base)[i] = (uint8_t)repro::to_e4m3(q);
    else
      static_cast<__half*>(base)[i] = __float2half_rn(q);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
adamw_update_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row * repro::TILE >= a.n) return;
  if (a.flags != nullptr && (*a.flags & a.skip_mask)) return;
  const float clip = *a.clip;
  const bool sm = a.m_kind >= E4M3, sv = a.v_kind >= E4M3,
             sw = a.w_kind >= E4M3;
  const float msc = sm ? a.m_scale[row] : 1.f;
  const float vsc = sv ? a.v_scale[row] : 1.f;
  const float wsc = sw ? a.w_scale[row] : 1.f;
  float mn[4], vn[4], wn[4];
  bool live[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = row * repro::TILE + lane + 32 * k;
    live[k] = i < a.n;
    mn[k] = vn[k] = wn[k] = 0.f;
    if (!live[k]) continue;
    const float g0 = a.g_f32 ? static_cast<const float*>(a.g)[i]
                             : __bfloat162float(
                                   static_cast<const __nv_bfloat16*>(a.g)[i]);
    const float g = __fmul_rn(g0, clip);
    const float m = load(a.m_kind, a.m, i, msc);
    const float v = load(a.v_kind, a.v, i, vsc);
    const float base = a.w_kind == NONE ? load(a.p_f32 ? F32 : BF16, a.p,
                                               i, 1.f)
                                        : load(a.w_kind, a.w, i, wsc);
    // adamw_math, one rounding an operation, in its order
    const float m_new = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
    const float v_new = __fadd_rn(__fmul_rn(a.b2, v),
                                  __fmul_rn(__fmul_rn(a.omb2, g), g));
    const float mhat = __fmul_rn(m_new, a.inv_b1c);
    const float vhat = __fmul_rn(v_new, a.inv_b2c);
    const float upd = __fadd_rn(
        __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), a.eps)),
        __fmul_rn(a.wd, base));
    mn[k] = m_new;
    vn[k] = v_new;
    wn[k] = __fsub_rn(base, __fmul_rn(a.lr, upd));
  }
  // every lane of the warp is still here: the shuffles need all 32
  store(a.m_kind, a.m, a.m_scale, row, lane, mn, live);
  store(a.v_kind, a.v, a.v_scale, row, lane, vn, live);
  if (a.w_kind != NONE) store(a.w_kind, a.w, a.w_scale, row, lane, wn, live);
  store(a.p_f32 ? F32 : BF16, a.p, nullptr, row, lane, wn, live);
}

}  // namespace

REPRO_EXPORT int repro_adamw_update(
    const void* g, int g_f32, const float* clip, const int* flags,
    int skip_mask, void* m, float* m_scale, int m_kind, void* v,
    float* v_scale, int v_kind, void* w, float* w_scale, int w_kind,
    void* p, int p_f32, long long n, float b1, float omb1, float b2,
    float omb2,
    float inv_b1c, float inv_b2c, float eps, float wd, float lr,
    cudaStream_t stream) {
  const Args a{g, g_f32, clip, flags, skip_mask, m, m_scale, m_kind,
               v, v_scale, v_kind, w, w_scale, w_kind, p, p_f32, n,
               b1, omb1, b2, omb2, inv_b1c, inv_b2c, eps, wd, lr};
  const long long rows = (n + repro::TILE - 1) / repro::TILE;
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0)
    adamw_update_kernel<<<(unsigned)blocks, WARPS * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
