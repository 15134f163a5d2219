// LayerNorm + adaLN modulation: out = LN(x) [* g + b] * (1 + ms_b) + mt_b.
//
// Replaces the TPU kernel _ln_mod_kernel (founddiff_tpu/ops/norm_pallas.py:123,
// launched by _ln_mod_forward :154 from layer_norm_modulated :207).
//
// Bound on the H100: bytes.  Each element is read once and written once
// with ~10 flops between, far below the card's ~20 flop/byte fp32 ridge.
// Design: fd::ln_rows_vec (common.cuh): a group of up to 32 threads per row
// (fewer for a narrow row, so a warp takes several rows), 16-byte vector
// loads and stores where the rows are aligned and C % (16 bytes) == 0, the
// row held in registers for C <= 1024 so x is read once, fp32 one-pass
// statistics; the modulation is read through its row stride, so the adaLN
// chunks need no copy.  No shared memory, no atomics.  The TPU kernel's row
// blocks and padding are Mosaic tiling rules and are not kept.
#include "common.cuh"

template <typename T>
static int run(const void* x, const float* g, const float* b, const float* ms,
               const float* mt, int ldm, void* out, int B, int R, int C, float eps,
               cudaStream_t s) {
  FD_TRY((fd::ln_rows_vec<T, T>(static_cast<const T*>(x), g, b, ms, mt, ldm,
                                static_cast<T*>(out), nullptr, (long long)B * R, R, C, eps,
                                s)));
  return 0;
}

// x [B, R, C] and out at the io dtype; g, b [C] fp32 (or has_affine 0); ms, mt
// fp32 rows of stride ldm, row b for image b.
extern "C" int ln_mod_forward(const void* x, const float* g, const float* b,
                              const float* ms, const float* mt, void* out, int B, int R,
                              int C, int ldm, float eps, int has_affine, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!has_affine) g = b = nullptr;
  if (dtype == 0) return run<float>(x, g, b, ms, mt, ldm, out, B, R, C, eps, s);
  if (dtype == 1) return run<__nv_bfloat16>(x, g, b, ms, mt, ldm, out, B, R, C, eps, s);
  return (int)cudaErrorInvalidValue;
}

// LayerNorm alone: out = LN(x) [* g + b] over the rows of x [R, C].
//
// Replaces the TPU kernel _ln_kernel (founddiff_tpu/ops/norm_pallas.py:23,
// launched by _ln_forward :48 from layer_norm :99), the out_norm of the SS2D
// blocks on an odd grid (LNorm, founddiff_tpu/models/blocks.py:200-220).
//
// Bound on the H100: bytes, as ln_mod_forward; the same row kernel with no
// modulation (ms == nullptr is uniform across the grid).
extern "C" int ln_forward(const void* x, const float* g, const float* b, void* out, int R,
                          int C, float eps, int has_affine, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!has_affine) g = b = nullptr;
  if (dtype == 0) return run<float>(x, g, b, nullptr, nullptr, 0, out, 1, R, C, eps, s);
  if (dtype == 1) return run<__nv_bfloat16>(x, g, b, nullptr, nullptr, 0, out, 1, R, C, eps, s);
  return (int)cudaErrorInvalidValue;
}
