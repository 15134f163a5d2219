// LayerNorm + adaLN modulation: out = LN(x) [* g + b] * (1 + ms_b) + mt_b.
//
// Replaces the TPU kernel _ln_mod_kernel (founddiff_tpu/ops/norm_pallas.py:123,
// launched by _ln_mod_forward :154 from layer_norm_modulated :207).
//
// Bound on the H100: bytes.  Each element is read once and written once
// with ~10 flops between, far below the card's ~20 flop/byte fp32 ridge.
// Design: one warp per row (C <= 512 on the serving path), fp32 statistics
// from registers-width strided loads, a second read of the row for the
// normalisation that hits L1/L2; no shared memory, no atomics.  The TPU
// kernel's row blocks and padding are Mosaic tiling rules and are not kept.
#include "common.cuh"

template <typename T>
static int run(const void* x, const float* g, const float* b, const float* ms,
               const float* mt, void* out, int B, int R, int C, float eps,
               cudaStream_t s) {
  FD_TRY((fd::ln_rows<T, T>(static_cast<const T*>(x), g, b, ms, mt, static_cast<T*>(out),
                            nullptr, (long long)B * R, R, C, eps, s)));
  return 0;
}

extern "C" int ln_mod_forward(const void* x, const float* g, const float* b,
                              const float* ms, const float* mt, void* out, int B, int R,
                              int C, float eps, int has_affine, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!has_affine) g = b = nullptr;
  if (dtype == 0) return run<float>(x, g, b, ms, mt, out, B, R, C, eps, s);
  if (dtype == 1) return run<__nv_bfloat16>(x, g, b, ms, mt, out, B, R, C, eps, s);
  return (int)cudaErrorInvalidValue;
}

// LayerNorm alone: out = LN(x) [* g + b] over the rows of x [R, C].
//
// Replaces the TPU kernel _ln_kernel (founddiff_tpu/ops/norm_pallas.py:23,
// launched by _ln_forward :48 from layer_norm :99), the out_norm of the SS2D
// blocks on an odd grid (LNorm, founddiff_tpu/models/blocks.py:200-220).
//
// Bound on the H100: bytes, as ln_mod_forward.  Design: the row kernel of
// ln_mod_forward with no modulation (its ms == nullptr branch is uniform
// across the grid), so both entries share one body and the modulated
// entry's code is the one it always was.
extern "C" int ln_forward(const void* x, const float* g, const float* b, void* out, int R,
                          int C, float eps, int has_affine, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!has_affine) g = b = nullptr;
  if (dtype == 0) return run<float>(x, g, b, nullptr, nullptr, out, 1, R, C, eps, s);
  if (dtype == 1) return run<__nv_bfloat16>(x, g, b, nullptr, nullptr, out, 1, R, C, eps, s);
  return (int)cudaErrorInvalidValue;
}
