// Shared device code of the port's kernels: dtype conversion, 16-byte
// vector loads and stores, warp reductions, the LayerNorm+modulation row
// kernel, a tiled GEMM with a gathered A operand and a fused epilogue, and
// the depthwise 3x3.
//
// Element types: float or __nv_bfloat16 activations ("io" dtype); every sum
// and every piece of arithmetic runs in fp32, and values are rounded to the
// io dtype exactly where the TPU kernels round them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fd {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the io dtype and widened back
template <typename T> __device__ __forceinline__ float round_io(float v) {
  return to_f<T>(from_f<T>(v));
}

// 16 bytes of T: Vec<T>::N elements moved as one Vec<T>::U
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  using U = float4;
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using U = uint4;
};

// Vec<T>::N elements at p (16-byte aligned) widened to fp32 into v
template <typename T> __device__ __forceinline__ void load_vec(const T* p, float* v) {
  const typename Vec<T>::U u = *reinterpret_cast<const typename Vec<T>::U*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) v[i] = to_f<T>(e[i]);
}

// v[0 .. Vec<T>::N) rounded to T and stored at p (16-byte aligned)
template <typename T> __device__ __forceinline__ void store_vec(T* p, const float* v) {
  typename Vec<T>::U u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(v[i]);
  *reinterpret_cast<typename Vec<T>::U*>(p) = u;
}

// Host side: whether every pointer meets load_vec/store_vec's 16-byte alignment
template <typename... P> inline bool aligned16(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// One warp per row of x [B*R, C]: fp32 mean and one-pass variance
// E[x^2] - mean^2 (as _ln_mod_kernel), optional affine g/b [C], then
// * (1 + ms[b]) + mt[b] with ms/mt [B, C].  ms == nullptr skips the
// modulation; out == nullptr writes (mean, rstd) pairs to stats instead.
// ---------------------------------------------------------------------------
constexpr int LN_THREADS = 256;

template <typename T, typename Y>
__global__ void __launch_bounds__(LN_THREADS)
ln_rows_kernel(const Y* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ b, const float* __restrict__ ms,
               const float* __restrict__ mt, T* __restrict__ out,
               float* __restrict__ stats, long long rows, int R, int C, float eps) {
  const long long row = (long long)blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const Y* xr = x + row * C;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f<Y>(xr[c]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / C;
  const float rstd = rsqrtf(ss / C - mean * mean + eps);
  if (out == nullptr) {
    if (lane == 0) {
      stats[2 * row] = mean;
      stats[2 * row + 1] = rstd;
    }
    return;
  }
  const long long bi = row / R;
  for (int c = lane; c < C; c += 32) {
    float y = (to_f<Y>(xr[c]) - mean) * rstd;
    if (g != nullptr) y = y * g[c] + b[c];
    if (ms != nullptr) y = y * (1.f + ms[bi * C + c]) + mt[bi * C + c];
    out[row * C + c] = from_f<T>(y);
  }
}

template <typename T, typename Y>
cudaError_t ln_rows(const Y* x, const float* g, const float* b, const float* ms,
                    const float* mt, T* out, float* stats, long long rows, int R, int C,
                    float eps, cudaStream_t s) {
  const int rows_per_block = LN_THREADS / 32;
  const unsigned grid = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  ln_rows_kernel<T, Y><<<grid, LN_THREADS, 0, s>>>(x, g, b, ms, mt, out, stats, rows, R,
                                                   C, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tiled GEMM on the CUDA cores: for each z, C[m, n] = sum_k A[m, k] B[k, n].
// A row m of slice z starts at rowA(z, m) (contiguous over k, io dtype), so
// callers can gather rows (the decimated scan directions) without a copy.
// B is row-major [K, N] with leading dimension ldb, slice z at
// B + (z % zmod) * strideBz (zmod = 1 shares one B across all z).
// The epilogue functor epi(z, m, n, acc) consumes the fp32 sum.
// 64x64 output tile per block of 256 threads, 4x4 outputs per thread, k in
// steps of 16 staged through shared memory as fp32.
// ---------------------------------------------------------------------------
constexpr int GBM = 64, GBN = 64, GBK = 16, GTHREADS = 256;

template <typename T>
struct RowStrided {
  const T* base;
  long long zstride, ld;
  __device__ __forceinline__ const T* operator()(int z, int m) const {
    return base + z * zstride + (long long)m * ld;
  }
};

template <typename T, class RowA, class Epi>
__global__ void __launch_bounds__(GTHREADS)
gemm_kernel(int M, int N, int K, RowA rowA, const T* __restrict__ B,
            long long strideBz, int zmod, int ldb, Epi epi) {
  __shared__ float As[GBK][GBM + 4];
  __shared__ float Bs[GBK][GBN + 4];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const T* Bz = B + (long long)(z % zmod) * strideBz;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const int bk = tid >> 4, bn = (tid & 15) * 4;
  const T* arow = (m0 + ar < M) ? rowA(z, m0 + ar) : nullptr;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ak + i;
      As[ak + i][ar] = (arow != nullptr && k < K) ? to_f<T>(arow[k]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + bk, n = n0 + bn + j;
      Bs[bk][bn + j] = (k < K && n < N) ? to_f<T>(Bz[(long long)k * ldb + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) epi(z, m, n, acc[i][j]);
    }
  }
}

template <typename T, class RowA, class Epi>
cudaError_t gemm(int Z, int M, int N, int K, RowA rowA, const T* B, long long strideBz,
                 int zmod, int ldb, Epi epi, cudaStream_t s) {
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM, Z);
  gemm_kernel<T, RowA, Epi><<<grid, GTHREADS, 0, s>>>(M, N, K, rowA, B, strideBz, zmod, ldb,
                                                      epi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Depthwise 3x3 with a zero halo (SAME padding) over u [B, H, W, K], taps
// [9, K] at 3 * dr + dc, one thread per (pixel, channel), channels
// innermost: fp32 products of the io values, then epi(idx, k, acc) writes
// output element idx.  The two TPU kernels it replaces sum in different
// orders, and each port is held to its own: BY_COLUMN false adds the taps
// row by row (_attn_block_kernel), BY_COLUMN true adds each column's three
// rows first, then the columns (the unified MambaBlock kernels).
// ---------------------------------------------------------------------------
constexpr int DW_THREADS = 256;

template <typename T, bool BY_COLUMN, class Epi>
__global__ void __launch_bounds__(DW_THREADS)
dwconv3x3_kernel(const T* __restrict__ u, const T* __restrict__ taps, int H, int W, int K,
                 long long total, Epi epi) {
  const long long idx = (long long)blockIdx.x * DW_THREADS + threadIdx.x;
  if (idx >= total) return;
  const int k = (int)(idx % K);
  const long long pix = idx / K;
  const int x = (int)(pix % W), y = (int)((pix / W) % H);
  const long long img = pix / ((long long)H * W);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float part = 0.f;  // BY_COLUMN: column i's three rows
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int dr = BY_COLUMN ? j : i, dc = BY_COLUMN ? i : j;
      const int yy = y + dr - 1, xx = x + dc - 1;
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      const float v = to_f<T>(u[((img * H + yy) * W + xx) * K + k]);
      if (BY_COLUMN)
        part += v * to_f<T>(taps[(dr * 3 + dc) * K + k]);
      else
        acc += v * to_f<T>(taps[(dr * 3 + dc) * K + k]);
    }
    if (BY_COLUMN) acc += part;
  }
  epi(idx, k, acc);
}

template <typename T, bool BY_COLUMN, class Epi>
cudaError_t dwconv3x3(const T* u, const T* taps, int H, int W, int K, long long total, Epi epi,
                      cudaStream_t s) {
  dwconv3x3_kernel<T, BY_COLUMN, Epi>
      <<<(unsigned)((total + DW_THREADS - 1) / DW_THREADS), DW_THREADS, 0, s>>>(u, taps, H, W, K,
                                                                                total, epi);
  return cudaGetLastError();
}

}  // namespace fd

#define FD_TRY(expr)                      \
  do {                                    \
    cudaError_t fd_err_ = (expr);         \
    if (fd_err_ != cudaSuccess) return (int)fd_err_; \
  } while (0)
