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
// the products on the fp32 CUDA cores through a simple tiled GEMM, not the
// tensor cores, and passes the projections, y and the LN statistics through
// device memory, so it sits far above that bound (PERF.md has the times).
// Design, in six launches on the caller's stream:
//   1. proj: a tiled GEMM whose A rows are gathered straight from the NHWC
//      image in direction order (no decimated copy), with the delta bias and
//      softplus fused into its epilogue -> [B, 4, L, D+2N] fp32;
//   2. scan pass 1 (steps 1-4 live in scan_common.cuh, shared with
//      scan_image.cu): L is cut into chunks of T steps; one thread per
//      (direction, chunk, channel) runs the recurrence from a zero state with
//      all N states in registers and keeps the chunk's end state and sum of
//      delta (so the chunk's decay is exp(A * sum), never a positive exponent);
//   3. carry: one thread per (direction, channel, state) walks the chunks
//      and turns end states into entry states;
//   4. scan pass 2: each chunk reruns from its entry state and writes
//      y = C.h + D*u straight into its pixel of the merged [B, H, W, D] map
//      (EfficientMerge: out[2i,2j]=dir0, [2i+1,2j]=dir1, [2i,2j+1]=dir2,
//      [2i+1,2j+1]=dir3; dirs 1 and 3 run column-major);
//   5. per-pixel LayerNorm statistics of y (one warp per pixel);
//   6. z = x1 W_z as a GEMM whose epilogue applies LN, silu(z), +local and
//      rounds to the io dtype; then out_proj as a GEMM whose epilogue adds
//      gate * acc to the residual.
// Chunking gives B*4*(L/T)*D threads per scan pass (512 channels at bs1 on
// the 512^2 scale would not fill 132 SMs with one thread per channel).  The
// TPU kernel's Hillis-Steele tiles, 128-lane padding and row-parity
// aliasing are Mosaic constraints and are not ported.
#include "scan_common.cuh"

namespace {

using fd::EpiProj;
using fd::RowGather;

template <typename T>
struct EpiGate {  // og = (LN(y) * g + b) * silu(round(z)) + local, rounded
  const float* y;
  const float* stats;
  const float* g;
  const float* bln;
  const float* local;
  T* og;
  int D, HW;
  __device__ __forceinline__ void operator()(int, int m, int n, float acc) const {
    const float zf = fd::round_io<T>(acc);
    const long long i = (long long)m * D + n;
    const float yn = (y[i] - stats[2 * m]) * stats[2 * m + 1] * g[n] + bln[n];
    float o = yn * (zf / (1.f + expf(-zf)));
    if (local != nullptr) o += local[(long long)(m / HW) * D + n];
    og[i] = fd::from_f<T>(o);
  }
};

template <typename T>
struct EpiResidual {  // out = x_raw + gate * acc
  const T* xr;
  const float* gate;
  T* out;
  int C0, HW;
  __device__ __forceinline__ void operator()(int, int m, int n, float acc) const {
    const long long i = (long long)m * C0 + n;
    out[i] = fd::from_f<T>(fd::to_f<T>(xr[i]) + gate[(long long)(m / HW) * C0 + n] * acc);
  }
};

template <typename T>
int run(const void* x1_, const void* xs_, const void* xr_, const void* wz_,
        const void* wproj_, const float* A, const float* Ds, const float* dbias,
        const float* lng, const float* lnb, const float* local, const void* pw_,
        const float* gate, void* out_, float* proj, float* csum, float* cstate, float* ybuf,
        float* stats, void* og_, int B, int H, int W, int C0, int D, int NS, int TC,
        float eps, cudaStream_t s) {
  const T* x1 = static_cast<const T*>(x1_);
  const T* xs = static_cast<const T*>(xs_);
  const T* xr = static_cast<const T*>(xr_);
  const T* wz = static_cast<const T*>(wz_);
  const T* wproj = static_cast<const T*>(wproj_);
  const T* pw = static_cast<const T*>(pw_);
  T* out = static_cast<T*>(out_);
  T* og = static_cast<T*>(og_);
  const int H2 = H / 2, W2 = W / 2, L = H2 * W2, NP = D + 2 * NS;
  const int NC = (L + TC - 1) / TC;
  const int P = B * H * W, HW = H * W;

  FD_TRY((fd::gemm<T>(B * 4, L, NP, D, RowGather<T>{xs, H, W, H2, W2, D}, wproj,
                      (long long)D * NP, 4, NP, EpiProj{proj, dbias, L, D, NP}, s)));
  const int rc = fd::image_scan_n<T>(xs, proj, A, Ds, csum, cstate, fd::StoreMerged{ybuf}, B,
                                     H, W, D, NS, L, TC, NC, s);
  if (rc) return rc;
  FD_TRY((fd::ln_rows<T, float>(ybuf, nullptr, nullptr, nullptr, nullptr, nullptr, stats, P,
                                1, D, eps, s)));
  FD_TRY((fd::gemm<T>(1, P, D, C0, fd::RowStrided<T>{x1, 0, C0}, wz, 0, 1, D,
                      EpiGate<T>{ybuf, stats, lng, lnb, local, og, D, HW}, s)));
  FD_TRY((fd::gemm<T>(1, P, C0, D, fd::RowStrided<T>{og, 0, D}, pw, 0, 1, C0,
                      EpiResidual<T>{xr, gate, out, C0, HW}, s)));
  return 0;
}

}  // namespace

extern "C" int ss2d_block_forward(
    const void* x1, const void* xs, const void* xr, const void* wz, const void* wproj,
    const float* A, const float* Ds, const float* dbias, const float* lng,
    const float* lnb, const float* local, const void* pw, const float* gate, void* out,
    float* proj, float* csum, float* cstate, float* ybuf, float* stats, void* og, int B,
    int H, int W, int C0, int D, int NS, int TC, float eps, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x1, xs, xr, wz, wproj, A, Ds, dbias, lng, lnb, local, pw, gate, out,
                      proj, csum, cstate, ybuf, stats, og, B, H, W, C0, D, NS, TC, eps, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x1, xs, xr, wz, wproj, A, Ds, dbias, lng, lnb, local, pw,
                              gate, out, proj, csum, cstate, ybuf, stats, og, B, H, W, C0,
                              D, NS, TC, eps, s);
  return (int)cudaErrorInvalidValue;
}
