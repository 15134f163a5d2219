// Image-direct selective scan: the four step-2 decimated direction scans
// of an NHWC image, with the delta/B/C projections inside, written as
// [B, 4, L, D] direction sequences at the io dtype.
//
// Replaces the TPU kernel _scan_kernel_image (founddiff_tpu/ops/scan_pallas.py:895,
// pallas_call :1005 in _image_call, through _scan_image :1032), the forward of
// the scan that the SS2D block's backward rematerialises at the shallow UNet
// scales (ops/ss2d_block.py:489-496).
//
// Bound on the H100: the fp32 scan operations (about 6*N*D per step) and,
// in bf16, the bytes of xs and ys.  The delta projection is folded into one
// [D, D] matrix as on the TPU (scan_pallas.py:1129-1134), so the projection
// GEMM does 6x to 8.5x the multiply-adds the rank-R factors need, on the
// fp32 CUDA cores; the projections pass through device memory as fp32.
// Design, in four launches on the caller's stream: the projection GEMM of
// ss2d_block.cu (A rows gathered from the image in direction order, softplus
// of delta + bias in its epilogue), then the three-pass chunked scan of
// scan_common.cuh, whose second pass writes y = C.h + D*u rounded to the io
// dtype.  The TPU kernel's Hillis-Steele tiles and 128-lane padding are
// Mosaic constraints and are not ported.
#include "scan_common.cuh"

namespace {

template <typename T>
int run(const void* xs_, const void* wproj_, const float* A, const float* Ds,
        const float* dbias, void* ys_, float* proj, float* csum, float* cstate, float* yacc,
        int B, int H, int W, int D, int NS, int TC, cudaStream_t s) {
  const T* xs = static_cast<const T*>(xs_);
  const T* wproj = static_cast<const T*>(wproj_);
  const int H2 = H / 2, W2 = W / 2, L = H2 * W2, NP = D + 2 * NS;
  const int NC = (L + TC - 1) / TC;
  FD_TRY((fd::gemm<T>(B * 4, L, NP, D, fd::RowGather<T>{xs, H, W, H2, W2, D}, wproj,
                      (long long)D * NP, 4, NP, fd::EpiProj{proj, dbias, L, D, NP}, s)));
  return fd::image_scan_n<T>(xs, proj, A, Ds, csum, cstate,
                             fd::StoreSeq<T>{static_cast<T*>(ys_), L}, yacc, B, H, W, D, NS, L,
                             TC, NC, s);
}

}  // namespace

// xs [B, H, W, D] and wproj [4, D, D+2N] (delta | B | C) at the io dtype;
// A [4, D, N], Ds and dbias [4, D] fp32; ys [B, 4, L, D] at the io dtype;
// N in {4, 8, 16, 32} or a multiple of 64 (the wrapper pads other sizes).
// Scratch: proj [B*4*L*(D+2N)], csum [B*4*NC*D], cstate [B*4*NC*D*N] fp32,
// and for N > 64 yacc [B*4*L*D] fp32 (else unused).
extern "C" int scan_image_forward(const void* xs, const void* wproj, const float* A,
                                  const float* Ds, const float* dbias, void* ys, float* proj,
                                  float* csum, float* cstate, float* yacc, int B, int H, int W,
                                  int D, int NS, int TC, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(xs, wproj, A, Ds, dbias, ys, proj, csum, cstate, yacc, B, H, W, D, NS,
                      TC, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(xs, wproj, A, Ds, dbias, ys, proj, csum, cstate, yacc, B, H, W,
                              D, NS, TC, s);
  return (int)cudaErrorInvalidValue;
}
