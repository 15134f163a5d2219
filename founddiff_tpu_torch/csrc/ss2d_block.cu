// Fused SS2D block: x_raw + gate * out_proj(LN(scan(xs)) * silu(x1 W_z) + local)
// over the four step-2 decimated scan directions.
//
// Replaces the TPU kernel _scan_block_kernel (founddiff_tpu/ops/ss2d_block.py:50,
// launched twice per SS2D by _block_call :372 from ss2d_image_block :542).
//
// Bound on the H100 (as chip_smoke.py counts it): in bf16 the bytes at most
// serving shapes and the scan's fp32 operations at the 64^2 grids; in fp32
// the operations everywhere.  Per pixel the projections
// need 2*D*R + 2*N*D + 2*C0*D multiply-adds (delta through its rank-R
// factors, B/C, z, out_proj) and the scan about 6*N*D fp32 operations.  This
// first version folds the rank-R delta projection into one [D, D] matrix
// (D*(D+2N) multiply-adds for delta/B/C, 6x to 8.5x the rank-R count), runs
// the products in bf16 on the tensor cores (fd::gemm_tc: mma.sync with fp32
// sums; fp32 stays on the CUDA cores through fd::gemm), and passes the
// projections, y and the LN statistics through device memory, so it sits
// above that bound (PERF.md has the times).  tc = 0 keeps bf16 on fd::gemm,
// the earlier route, for the checks that hold one against the other.
// Design: the five launches of ss2d_tail.cuh (projection GEMM, chunked scan,
// LN statistics, the z GEMM with the gated epilogue, out_proj with the gated
// residual), with one W_z and no z bias.
// Chunking gives B*4*(L/T)*D threads per scan pass (512 channels at bs1 on
// the 512^2 scale would not fill 132 SMs with one thread per channel).  The
// TPU kernel's Hillis-Steele tiles, 128-lane padding and row-parity
// aliasing are Mosaic constraints and are not ported.
#include "ss2d_tail.cuh"

namespace {

template <typename T>
int run(const void* x1_, const void* xs_, const void* xr_, const void* wz_,
        const void* wproj_, const float* A, const float* Ds, const float* dbias,
        const float* lng, const float* lnb, const float* local, const void* pw_,
        const float* gate, void* out_, float* proj, float* csum, float* cstate, float* ybuf,
        float* yacc, float* stats, void* og_, int B, int H, int W, int C0, int D, int NS, int TC,
        float eps, bool tc, cudaStream_t s) {
  return fd::ss2d_tail<T, false>(static_cast<const T*>(x1_), static_cast<const T*>(xs_),
                                 static_cast<const T*>(xr_), static_cast<const T*>(wz_),
                                 nullptr, static_cast<const T*>(wproj_), A, Ds, dbias, lng,
                                 lnb, local, static_cast<const T*>(pw_), gate,
                                 static_cast<T*>(out_), proj, csum, cstate, ybuf, yacc, stats,
                                 static_cast<T*>(og_), B, H, W, C0, D, NS, TC, eps, tc, s);
}

}  // namespace

extern "C" int ss2d_block_forward(
    const void* x1, const void* xs, const void* xr, const void* wz, const void* wproj,
    const float* A, const float* Ds, const float* dbias, const float* lng,
    const float* lnb, const float* local, const void* pw, const float* gate, void* out,
    float* proj, float* csum, float* cstate, float* ybuf, float* yacc, float* stats, void* og,
    int B, int H, int W, int C0, int D, int NS, int TC, float eps, int tc, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x1, xs, xr, wz, wproj, A, Ds, dbias, lng, lnb, local, pw, gate, out,
                      proj, csum, cstate, ybuf, yacc, stats, og, B, H, W, C0, D, NS, TC, eps,
                      tc != 0, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x1, xs, xr, wz, wproj, A, Ds, dbias, lng, lnb, local, pw,
                              gate, out, proj, csum, cstate, ybuf, yacc, stats, og, B, H, W, C0,
                              D, NS, TC, eps, tc != 0, s);
  return (int)cudaErrorInvalidValue;
}
