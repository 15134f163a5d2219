// The SS2D tail shared by ss2d_block.cu and mamba_block.cu:
//
//   out = x_raw + gate * out_proj(LN(scan(xs)) * silu(z) + local),
//   z   = round_io(x1 W_z (+ z_bias))
//
// over the four step-2 decimated scan directions, in five launches on the
// caller's stream (steps 1-4 of the scan live in scan_common.cuh):
//   1. proj: a tiled GEMM whose A rows are gathered straight from the NHWC
//      image in direction order (no decimated copy), with the delta bias and
//      softplus fused into its epilogue -> [B, 4, L, D+2N] fp32;
//   2. the three-pass chunked scan, writing y = C.h + D*u straight into its
//      pixel of the merged [B, H, W, D] map (EfficientMerge: out[2i,2j]=dir0,
//      [2i+1,2j]=dir1, [2i,2j+1]=dir2, [2i+1,2j+1]=dir3; dirs 1 and 3 run
//      column-major);
//   3. per-pixel LayerNorm statistics of y (one warp per pixel);
//   4. z as a GEMM whose epilogue applies LN, silu(z), +local and rounds to
//      the io dtype: one W_z and no bias for the fused SS2D block; with
//      PER_IMAGE (the unified MambaBlock) one GEMM slice per image with that
//      image's W_z (its folded LN affine) at b * C0 * D and bias at b * D;
//   5. out_proj as a GEMM whose epilogue adds gate * acc to the residual.
#pragma once

#include "scan_common.cuh"

namespace fd {

template <typename T, bool PER_IMAGE>
struct EpiGate {  // og = (LN(y) * g + b) * silu(round(z)) + local, rounded
  const float* y;
  const float* stats;
  const float* g;
  const float* bln;
  const float* local;
  const float* zb;  // PER_IMAGE: the z bias of each image, [B, D]
  T* og;
  int D, HW, zrows;
  __device__ __forceinline__ void operator()(int z, int m, int n, float acc) const {
    if constexpr (PER_IMAGE) {  // GEMM slice z is image z: its bias and its rows
      acc += zb[(long long)z * D + n];
      m += z * zrows;
    }
    const float zf = round_io<T>(acc);
    const long long i = (long long)m * D + n;
    const float yn = (y[i] - stats[2 * m]) * stats[2 * m + 1] * g[n] + bln[n];
    float o = yn * (zf / (1.f + expf(-zf)));
    if (local != nullptr) o += local[(long long)(m / HW) * D + n];
    og[i] = from_f<T>(o);
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
    out[i] = from_f<T>(to_f<T>(xr[i]) + gate[(long long)(m / HW) * C0 + n] * acc);
  }
};

template <typename T, bool PER_IMAGE>
int ss2d_tail(const T* x1, const T* xs, const T* xr, const T* wz, const float* zbias,
              const T* wproj, const float* A, const float* Ds, const float* dbias,
              const float* lng, const float* lnb, const float* local, const T* pw,
              const float* gate, T* out, float* proj, float* csum, float* cstate, float* ybuf,
              float* stats, T* og, int B, int H, int W, int C0, int D, int NS, int TC,
              float eps, cudaStream_t s) {
  const int H2 = H / 2, W2 = W / 2, L = H2 * W2, NP = D + 2 * NS;
  const int NC = (L + TC - 1) / TC;
  const int P = B * H * W, HW = H * W;
  const int zgroups = PER_IMAGE ? B : 1, zrows = P / zgroups;

  FD_TRY((gemm<T>(B * 4, L, NP, D, RowGather<T>{xs, H, W, H2, W2, D}, wproj,
                  (long long)D * NP, 4, NP, EpiProj{proj, dbias, L, D, NP}, s)));
  const int rc = image_scan_n<T>(xs, proj, A, Ds, csum, cstate, StoreMerged{ybuf}, B, H, W, D,
                                 NS, L, TC, NC, s);
  if (rc) return rc;
  FD_TRY((ln_rows<T, float>(ybuf, nullptr, nullptr, nullptr, nullptr, nullptr, stats, P, 1, D,
                            eps, s)));
  FD_TRY((gemm<T>(zgroups, zrows, D, C0, RowStrided<T>{x1, (long long)zrows * C0, C0}, wz,
                  (long long)C0 * D, zgroups, D,
                  EpiGate<T, PER_IMAGE>{ybuf, stats, lng, lnb, local, zbias, og, D, HW, zrows},
                  s)));
  FD_TRY((gemm<T>(1, P, C0, D, RowStrided<T>{og, 0, D}, pw, 0, 1, C0,
                  EpiResidual<T>{xr, gate, out, C0, HW}, s)));
  return 0;
}

}  // namespace fd
