// Device code shared by the image-direct scans (ss2d_tail.cuh, scan_image.cu):
// the pixel map of the four step-2 decimated directions, the projection
// GEMM's row gather and epilogue, and the three-pass chunked scan.
//
// The scan cuts each direction's L steps into chunks of TC steps:
//   1. pass 1: one thread per (direction, chunk, channel) runs the
//      recurrence from a zero state with all N states in registers and keeps
//      the chunk's end state and its sum of delta (so the chunk's decay is
//      exp(A * sum), never a positive exponent);
//   2. carry: one thread per (direction, channel, state) walks the chunks
//      and turns end states into entry states;
//   3. pass 2: each chunk reruns from its entry state and hands
//      y = C.h + D*u to an output functor.
#pragma once

#include "common.cuh"

namespace fd {

constexpr int SCAN_THREADS = 128;

// pixel (py, px) of step l of direction k (efficient_scan order)
__device__ __forceinline__ void dir_pixel(int k, int l, int H2, int W2, int& py, int& px) {
  if (k == 0 || k == 2) {
    py = 2 * (l / W2);
    px = 2 * (l % W2) + (k == 2);
  } else {
    py = 2 * (l % H2) + 1;
    px = 2 * (l / H2) + (k == 3);
  }
}

template <typename T>
struct RowGather {  // A rows of the projection GEMM: xs pixels in direction order
  const T* xs;
  int H, W, H2, W2, D;
  __device__ __forceinline__ const T* operator()(int z, int l) const {
    int py, px;
    dir_pixel(z & 3, l, H2, W2, py, px);
    return xs + (((long long)(z >> 2) * H + py) * W + px) * D;
  }
};

struct EpiProj {  // delta = softplus(acc + bias) | B | C, fp32
  float* out;
  const float* dbias;
  int L, D, NP;
  __device__ __forceinline__ void operator()(int z, int l, int n, float acc) const {
    float v = acc;
    if (n < D) v = softplus(v + dbias[(z & 3) * D + n]);
    out[((long long)z * L + l) * NP + n] = v;
  }
};

// y into its pixel of the merged [B, H, W, D] fp32 map (EfficientMerge)
struct StoreMerged {
  float* y;
  __device__ __forceinline__ void operator()(int, int, long long pix, int d, int D,
                                             float v) const {
    y[pix * D + d] = v;
  }
};

// y into [B, 4, L, D] direction sequences at the io dtype
template <typename T>
struct StoreSeq {
  T* ys;
  int L;
  __device__ __forceinline__ void operator()(int z, int l, long long, int d, int D,
                                             float v) const {
    ys[((long long)z * L + l) * D + d] = from_f<T>(v);
  }
};

template <typename T, int NS, bool FINAL, class Out>
__global__ void __launch_bounds__(SCAN_THREADS)
image_scan_chunk_kernel(const T* __restrict__ xs, const float* __restrict__ proj,
                        const float* __restrict__ A, const float* __restrict__ Dskip,
                        float* __restrict__ chunk_sum, float* __restrict__ chunk_state,
                        Out out, int H, int W, int D, int L, int TC, int NC) {
  const int d = blockIdx.x * SCAN_THREADS + threadIdx.x;
  const int c = blockIdx.y, z = blockIdx.z;
  if (d >= D) return;
  const int b = z >> 2, k = z & 3;
  const int H2 = H / 2, W2 = W / 2, NP = D + 2 * NS;
  float a[NS], h[NS];
  float* st = chunk_state + (((long long)z * NC + c) * D + d) * NS;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a[n] = A[((long long)k * D + d) * NS + n];
    h[n] = FINAL ? st[n] : 0.f;
  }
  const float dsk = FINAL ? Dskip[k * D + d] : 0.f;
  float dsum = 0.f;
  const int l1 = min(L, (c + 1) * TC);
  for (int l = c * TC; l < l1; ++l) {
    int py, px;
    dir_pixel(k, l, H2, W2, py, px);
    const long long pix = ((long long)b * H + py) * W + px;
    const float* pr = proj + ((long long)z * L + l) * NP;
    const float dl = pr[d];
    const float u = to_f<T>(xs[pix * D + d]);
    const float du = dl * u;
    float y = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      h[n] = expf(dl * a[n]) * h[n] + du * pr[D + n];
      if (FINAL) y = fmaf(pr[D + NS + n], h[n], y);
    }
    if (FINAL) {
      out(z, l, pix, d, D, y + dsk * u);
    } else {
      dsum += dl;
    }
  }
  if (!FINAL) {
#pragma unroll
    for (int n = 0; n < NS; ++n) st[n] = h[n];
    chunk_sum[((long long)z * NC + c) * D + d] = dsum;
  }
}

// end states -> entry states, one thread per (z, d, n); state layout [z, c, d, n]
__global__ void image_scan_carry_kernel(const float* __restrict__ A,
                                        const float* __restrict__ chunk_sum,
                                        float* __restrict__ chunk_state, int D, int NS,
                                        int NC, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = idx % NS;
  const int d = (idx / NS) % D;
  const long long z = idx / ((long long)NS * D);
  const float a = A[((z & 3) * D + d) * NS + n];
  float carry = 0.f;
  for (int c = 0; c < NC; ++c) {
    const long long si = (z * NC + c) * D + d;
    const float hend = chunk_state[si * NS + n];
    chunk_state[si * NS + n] = carry;
    carry = expf(a * chunk_sum[si]) * carry + hend;
  }
}

// The three passes on the caller's stream; proj is [B*4, L, D+2N] from the
// RowGather/EpiProj GEMM, csum [B*4, NC, D], cstate [B*4, NC, D, N].
template <typename T, int NS, class Out>
int image_scan(const T* xs, const float* proj, const float* A, const float* Ds, float* csum,
               float* cstate, Out out, int B, int H, int W, int D, int L, int TC, int NC,
               cudaStream_t s) {
  dim3 grid((D + SCAN_THREADS - 1) / SCAN_THREADS, NC, B * 4);
  image_scan_chunk_kernel<T, NS, false, Out><<<grid, SCAN_THREADS, 0, s>>>(
      xs, proj, A, Ds, csum, cstate, out, H, W, D, L, TC, NC);
  FD_TRY(cudaGetLastError());
  const long long total = (long long)B * 4 * D * NS;
  image_scan_carry_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(A, csum, cstate, D,
                                                                         NS, NC, total);
  FD_TRY(cudaGetLastError());
  image_scan_chunk_kernel<T, NS, true, Out><<<grid, SCAN_THREADS, 0, s>>>(
      xs, proj, A, Ds, csum, cstate, out, H, W, D, L, TC, NC);
  FD_TRY(cudaGetLastError());
  return 0;
}

// image_scan for a runtime state size in {4, 8, 16, 32}
template <typename T, class Out>
int image_scan_n(const T* xs, const float* proj, const float* A, const float* Ds, float* csum,
                 float* cstate, Out out, int B, int H, int W, int D, int NS, int L, int TC,
                 int NC, cudaStream_t s) {
  switch (NS) {
    case 4: return image_scan<T, 4>(xs, proj, A, Ds, csum, cstate, out, B, H, W, D, L, TC, NC, s);
    case 8: return image_scan<T, 8>(xs, proj, A, Ds, csum, cstate, out, B, H, W, D, L, TC, NC, s);
    case 16: return image_scan<T, 16>(xs, proj, A, Ds, csum, cstate, out, B, H, W, D, L, TC, NC, s);
    case 32: return image_scan<T, 32>(xs, proj, A, Ds, csum, cstate, out, B, H, W, D, L, TC, NC, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fd
