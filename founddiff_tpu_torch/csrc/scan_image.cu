// Image-direct selective scan: the four step-2 decimated direction scans
// of an NHWC image, with the delta/B/C projections inside, written as
// [B, 4, L, D] direction sequences at the io dtype.
//
// Replaces the TPU kernel _scan_kernel_image (founddiff_tpu/ops/scan_pallas.py:895,
// pallas_call :1005 in _image_call, through _scan_image :1032), the forward of
// the scan that the SS2D block's backward rematerialises at the shallow UNet
// scales (ops/ss2d_block.py:489-496).
//
// Bound on the H100: the bytes of xs and ys (read and written once) against
// the projections and the scan's fp32 operations (about 6 N D per step).
// The delta projection is folded into one [D, D] matrix as on the TPU
// (scan_pallas.py:1129-1134), 6x to 8.5x the multiply-adds of its rank-R
// factors.  The first port ran that product on the fp32 CUDA cores in both
// dtypes (half of the kernel's time in an fp32 train step), a chunk pass
// of one thread per channel reading B and C from device memory at every
// step, and a carry serial over the chunks (512 dependent steps at 512^2).
//
// Design, on the caller's stream:
//   1. the projection product on the tensor cores (fd::gemm_mma: bf16
//      mma, fp32 as three TF32 products, which hold the fp32 tolerance),
//      A rows gathered from the image in direction order, softplus(delta +
//      bias) in its epilogue (fast exponential and logarithm, to about
//      4e-6 of the value); the fp32 projections [B*4, L, D+2N] pass
//      through device memory once (written once, read by both chunk passes:
//      computing them inside each pass would double the product, the
//      larger cost in fp32);
//   2. pass 1 (bounds only): per (direction, chunk, 128 channels) block, the
//      chunk from a zero state, writing only what the carry needs: the end
//      state and the sum of delta';
//   3. the parallel carry of scan.cu (fd::carry_scan_kernel: segments of
//      chunks per warp, composed associatively, the loads of 8 chunks in
//      flight), on the state layout [z, chunk, n, d] it shares with it;
//   4. pass 2: the chunk again from its entry state, y = C.h + D*u rounded
//      to the io dtype.
// The passes are scan_common.cuh's chunk_passes_n, which scan.cu's
// fused-projection forward shares (u rows gathered here, strided there):
// in both passes the chunk's B (and C) rows are copied into shared memory
// once per block and delta' and the gathered u rows move in sub-tiles of 16
// steps by 16-byte cp.async, the next sub-tile in flight while the steps
// read the current one.  A chunk is 1024 / N steps (32 to 256), so its B
// and C rows take at most 16 KB.  A thread holds the N (up to 64) states
// of its channel in registers; N above 64 runs in groups of 64 whose y
// meet in an fp32 buffer in order (D*u with the first), one carry over all.
// The TPU kernel's Hillis-Steele tiles and 128-lane padding are Mosaic
// constraints and are not ported.
#include "scan_common.cuh"

namespace {

template <typename T>
int run(const void* xs_, const void* wproj_, const float* A, const float* Ds,
        const float* dbias, void* ys_, float* proj, float* hb, float* dsum, float* yacc, int B,
        int H, int W, int D, int NS, int TC, cudaStream_t s) {
  const T* xs = static_cast<const T*>(xs_);
  const T* wproj = static_cast<const T*>(wproj_);
  T* ys = static_cast<T*>(ys_);
  const int H2 = H / 2, W2 = W / 2, L = H2 * W2, NP = D + 2 * NS;
  const fd::RowGather<T> rows{xs, H, W, H2, W2, D};
  FD_TRY((fd::gemm_mma<T>(B * 4, L, NP, D, rows, D, xs, wproj, (long long)D * NP, 4, NP,
                          fd::EpiProjFast{proj, dbias, L, D, NP}, s)));
  return fd::chunk_passes_n<T, false>(rows, proj, A, Ds, hb, dsum, ys, yacc, nullptr, B * 4, D,
                                      NS, L, TC, TC, false, s);
}

}  // namespace

// xs [B, H, W, D] and wproj [4, D, D+2N] (delta | B | C) at the io dtype;
// A [4, D, N], Ds and dbias [4, D] fp32; ys [B, 4, L, D] at the io dtype;
// N in {4, 8, 16, 32} or a multiple of 64 (the wrapper pads other sizes);
// TC steps a chunk.  Scratch, fp32: proj [B*4*L*(D+2N)], hb [B*4*NC*N*D],
// dsum [B*4*NC*D], and for N > 64 yacc [B*4*L*D] (else unused).
extern "C" int scan_image_forward(const void* xs, const void* wproj, const float* A,
                                  const float* Ds, const float* dbias, void* ys, float* proj,
                                  float* hb, float* dsum, float* yacc, int B, int H, int W,
                                  int D, int NS, int TC, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(xs, wproj, A, Ds, dbias, ys, proj, hb, dsum, yacc, B, H, W, D, NS, TC, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(xs, wproj, A, Ds, dbias, ys, proj, hb, dsum, yacc, B, H, W, D, NS,
                              TC, s);
  return (int)cudaErrorInvalidValue;
}
