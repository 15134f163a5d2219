// Unified MambaBlock first half, from the raw block input x:
//
//   out = x + gate * out_proj(LN(scan(xs)) * silu(z) + local),
//   xc  = round_io((x - mean) * rstd)                   (LN without affine)
//   U   = round_io(xc Wxg_b + bx_b),  z = round_io(xc Wzg_b + bz_b)
//   xs  = round_io(silu(dwconv3x3(U) + dw_bias))
//
// where Wxg_b = round_io(Wx * geff_b), bx_b = beff_b Wx (and the same for
// Wz) fold image b's LN affine and adaLN modulation (geff = ln_scale *
// (1 + mod_scale), beff = ln_bias * (1 + mod_scale) + mod_shift) into the
// in_proj weights, as the TPU kernels do; the wrapper folds them in plain
// PyTorch, as JAX computes them outside its kernel bodies.
//
// Replaces the TPU kernels _mblock_row_kernel
// (founddiff_tpu/ops/experimental_unified.py:173) and _mblock_col_kernel
// (:265), both launched by _mblock_call (:533) from ss2d_mamba_block :674:
// the row kernel writes the even-row plane (the row scans), the column
// kernel the odd-row plane (the column scans).  Here one host entry does the
// whole block for both planes.
//
// Bound on the H100 (as chip_smoke.py counts it): the products (in_proj's
// 2*C0*D multiply-adds per pixel, delta/B/C through their rank-R factors,
// out_proj's D*C0) on the tensor cores in bf16, the scan's and the depthwise
// conv's fp32 operations, or the bytes of x in and out.  This first version runs its
// products on the fp32 CUDA cores through the simple tiled GEMM of
// common.cuh and passes xc, U, xs, the projections, y and the LN statistics
// through device memory, so it sits far above that bound (PERF.md).
// Design, on the caller's stream:
//   1. LN-center rows, one warp per pixel (fd::ln_rows without affine);
//   2. in_proj's x half as a GEMM batched over images (B operand Wxg_b),
//      the bias bx_b and the io rounding in its epilogue -> U;
//   3. the depthwise 3x3 over U with a zero halo (SAME padding), fd::dwconv3x3
//      summing by column as the TPU kernel does: io taps, fp32 sums, fp32
//      bias, fp32 silu, rounded -> xs;
//   4. the SS2D tail of ss2d_tail.cuh on xs, per image (PER_IMAGE): z =
//      xc Wzg_b + bz_b.
// The TPU kernels' halo rows carried between grid steps in VMEM scratch, the
// column kernel's strip loop and the output alias are Mosaic's schedule and
// are not ported.
#include "ss2d_tail.cuh"

namespace {

template <typename T>
struct EpiBiasRound {  // out = round_io(acc + bias[z]), z the image
  T* out;
  const float* bias;
  int D;
  long long zrows;
  __device__ __forceinline__ void operator()(int z, int m, int n, float acc) const {
    out[(z * zrows + m) * D + n] = fd::from_f<T>(acc + bias[(long long)z * D + n]);
  }
};

template <typename T>
struct EpiBiasSilu {  // xs = round_io(silu(acc + bias[d]))
  T* xs;
  const float* bias;
  __device__ __forceinline__ void operator()(long long i, int d, float acc) const {
    acc += bias[d];
    xs[i] = fd::from_f<T>(acc * (1.f / (1.f + expf(-acc))));
  }
};

template <typename T>
int run(const void* x_, const void* wxg_, const float* bx, const void* wzg_, const float* bz,
        const void* taps_, const float* dwb, const void* wproj_, const float* A,
        const float* Ds, const float* dbias, const float* lng, const float* lnb,
        const float* local, const void* pw_, const float* gate, void* out_, void* xc_,
        void* U_, void* xs_, float* proj, float* csum, float* cstate, float* ybuf,
        float* stats, void* og_, int B, int H, int W, int C0, int D, int NS, int TC,
        float eps_ln, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(x_);
  T* xc = static_cast<T*>(xc_);
  T* U = static_cast<T*>(U_);
  T* xs = static_cast<T*>(xs_);
  const int HW = H * W;
  const long long P = (long long)B * HW;
  FD_TRY((fd::ln_rows<T, T>(x, nullptr, nullptr, nullptr, nullptr, xc, nullptr, P, 1, C0,
                            eps_ln, s)));
  FD_TRY((fd::gemm<T>(B, HW, D, C0, fd::RowStrided<T>{xc, (long long)HW * C0, C0},
                      static_cast<const T*>(wxg_), (long long)C0 * D, B, D,
                      EpiBiasRound<T>{U, bx, D, HW}, s)));
  const long long total = P * D;
  FD_TRY((fd::dwconv3x3<T, true>(U, static_cast<const T*>(taps_), H, W, D, total,
                                  EpiBiasSilu<T>{xs, dwb}, s)));
  return fd::ss2d_tail<T, true>(xc, xs, x, static_cast<const T*>(wzg_), bz,
                                static_cast<const T*>(wproj_), A, Ds, dbias, lng, lnb, local,
                                static_cast<const T*>(pw_), gate, static_cast<T*>(out_), proj,
                                csum, cstate, ybuf, stats, static_cast<T*>(og_), B, H, W, C0, D,
                                NS, TC, eps, s);
}

}  // namespace

extern "C" int mamba_block_forward(
    const void* x, const void* wxg, const float* bx, const void* wzg, const float* bz,
    const void* taps, const float* dwb, const void* wproj, const float* A, const float* Ds,
    const float* dbias, const float* lng, const float* lnb, const float* local, const void* pw,
    const float* gate, void* out, void* xc, void* U, void* xs, float* proj, float* csum,
    float* cstate, float* ybuf, float* stats, void* og, int B, int H, int W, int C0, int D,
    int NS, int TC, float eps_ln, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, wxg, bx, wzg, bz, taps, dwb, wproj, A, Ds, dbias, lng, lnb, local, pw,
                      gate, out, xc, U, xs, proj, csum, cstate, ybuf, stats, og, B, H, W, C0,
                      D, NS, TC, eps_ln, eps, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, wxg, bx, wzg, bz, taps, dwb, wproj, A, Ds, dbias, lng, lnb,
                              local, pw, gate, out, xc, U, xs, proj, csum, cstate, ybuf, stats,
                              og, B, H, W, C0, D, NS, TC, eps_ln, eps, s);
  return (int)cudaErrorInvalidValue;
}
