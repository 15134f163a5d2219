// GroupNorm statistics, and the fused normalise + affine + SiLU (+ residual)
// pass of the resnet blocks.
//
// Replaces the TPU kernels _stats_kernel (founddiff_tpu/ops/groupnorm_pallas.py:38,
// launched :83) and _apply_kernel (:50, launched :111).  The group step
// between them ([B, 2, C] sums -> group mean and rstd) is plain PyTorch, as
// JAX computes it outside its kernels.
//
// Bound on the H100: bytes, both.  gn_stats reads x once with 3 flops per
// element; gn_apply reads x (and the residual) and writes y with about 10
// flops and one exponential per element, far below the card's flop/byte ridge.
// Design:
//   - gn_stats: the TPU kernel carries its sums across a sequential row grid.
//     Here a block owns one chunk of rows of one image (the wrapper picks the
//     chunk count so that about 512 blocks run: one 512^2 image alone is
//     262,144 rows at C = 64), each thread keeps the sums of VEC neighbouring
//     channels in registers over its rows with 16-byte loads, the block adds
//     its row groups through shared memory in a fixed order and writes one
//     partial per chunk, and a second kernel adds the partials in chunk
//     order.  No atomics: every run gives the same bits.  The variance stays
//     E[x^2] - mean^2 in fp32, as the JAX package has it.
//   - gn_apply: one thread per VEC consecutive channels of a row, 16-byte
//     loads and stores, grid-stride; with no residual none is read.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int APPLY_BLOCKS = 132 * 16;

using fd::load_vec;
using fd::store_vec;
using fd::Vec;

// grid (chunks, B): partial[b, chunk] = [sum x, sum x^2] over the chunk's rows
template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int R, int C, int rows) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float red[];  // [row groups][2C]
  const int tpr = C / V, groups = THREADS / tpr;
  const int t = threadIdx.x, cv = t % tpr, rg = t / tpr;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int r0 = chunk * rows, r1 = min(R, r0 + rows);
  if (rg < groups) {
    float s[V], q[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
    const T* xb = x + (long long)b * R * C + cv * V;
    for (int r = r0 + rg; r < r1; r += groups) {
      float v[V];
      load_vec<T>(xb + (long long)r * C, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += v[i];
        q[i] += v[i] * v[i];
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[rg * 2 * C + cv * V + i] = s[i];
      red[rg * 2 * C + C + cv * V + i] = q[i];
    }
  }
  __syncthreads();
  float* out = partial + ((long long)b * gridDim.x + chunk) * 2 * C;
  for (int j = t; j < 2 * C; j += THREADS) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += red[g * 2 * C + j];
    out[j] = acc;
  }
}

// out[b] = the chunks' partials of image b added in chunk order
__global__ void gn_stats_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int chunks, int C2) {
  const int b = blockIdx.y, j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= C2) return;
  const float* p = partial + (long long)b * chunks * C2 + j;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += p[(long long)c * C2];
  out[(long long)b * C2 + j] = acc;
}

// y = silu((x - mean) * rstd * g + b) (+ res), statistics and affine [B, C]
template <typename T, bool RES>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ rstd, const float* __restrict__ g,
                const float* __restrict__ bias, const T* __restrict__ res,
                T* __restrict__ out, long long nvec, long long RC, int C) {
  constexpr int V = Vec<T>::N;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < nvec; i += stride) {
    const long long e = i * V;
    const long long bc = (e / RC) * C + e % C;
    float v[V], r[V];
    load_vec<T>(x + e, v);
    if (RES) load_vec<T>(res + e, r);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float y = (v[k] - mean[bc + k]) * rstd[bc + k] * g[bc + k] + bias[bc + k];
      y = y * (1.f / (1.f + expf(-y)));
      if (RES) y += r[k];
      v[k] = y;
    }
    store_vec<T>(out + e, v);
  }
}

template <typename T>
int stats(const void* x, float* out, float* partial, int B, int R, int C, int chunks,
          cudaStream_t s) {
  constexpr int V = Vec<T>::N;
  const int tpr = C / V;
  if (C % V || tpr > THREADS || chunks < 1) return (int)cudaErrorInvalidValue;
  if (!fd::aligned16(x)) return (int)cudaErrorMisalignedAddress;
  const int groups = THREADS / tpr, rows = (R + chunks - 1) / chunks;
  const size_t smem = (size_t)groups * 2 * C * sizeof(float);
  gn_stats_kernel<T><<<dim3(chunks, B), THREADS, smem, s>>>(static_cast<const T*>(x), partial,
                                                             R, C, rows);
  FD_TRY(cudaGetLastError());
  gn_stats_reduce_kernel<<<dim3((2 * C + 255) / 256, B), 256, 0, s>>>(partial, out, chunks,
                                                                      2 * C);
  FD_TRY(cudaGetLastError());
  return 0;
}

template <typename T>
int apply(const void* x, const float* mean, const float* rstd, const float* g,
          const float* b, const void* res, void* out, int B, int R, int C, int has_res,
          cudaStream_t s) {
  constexpr int V = Vec<T>::N;
  if (C % V) return (int)cudaErrorInvalidValue;
  if (!fd::aligned16(x, res, out)) return (int)cudaErrorMisalignedAddress;
  const long long RC = (long long)R * C, nvec = B * RC / V;
  const long long want = (nvec + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(want < APPLY_BLOCKS ? want : APPLY_BLOCKS);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if (has_res)
    gn_apply_kernel<T, true><<<grid, THREADS, 0, s>>>(xt, mean, rstd, g, b, rt, ot, nvec, RC, C);
  else
    gn_apply_kernel<T, false><<<grid, THREADS, 0, s>>>(xt, mean, rstd, g, b, nullptr, ot, nvec,
                                                       RC, C);
  FD_TRY(cudaGetLastError());
  return 0;
}

}  // namespace

extern "C" int gn_stats_forward(const void* x, float* out, float* partial, int B, int R, int C,
                                int chunks, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return stats<float>(x, out, partial, B, R, C, chunks, s);
  if (dtype == 1) return stats<__nv_bfloat16>(x, out, partial, B, R, C, chunks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gn_apply_forward(const void* x, const float* mean, const float* rstd,
                                const float* g, const float* b, const void* res, void* out,
                                int B, int R, int C, int has_res, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return apply<float>(x, mean, rstd, g, b, res, out, B, R, C, has_res, s);
  if (dtype == 1)
    return apply<__nv_bfloat16>(x, mean, rstd, g, b, res, out, B, R, C, has_res, s);
  return (int)cudaErrorInvalidValue;
}
