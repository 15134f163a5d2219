// MambaBlock attention half: out = x + gate * TransposedAttention(modulate(LN(x))).
//
// Replaces the TPU kernel _attn_block_kernel (founddiff_tpu/ops/attn_block.py:104,
// launched by _attn_block_fwd_only :306 from attn_block :422).
//
// Bound on the H100 (as chip_smoke.py counts it): operations.  Per pixel the
// qkv 1x1 projection is 3C^2 and v @ M another C^2 multiply-adds (C =
// 128..512) against reading x and writing out once.  This first version runs
// the products on the fp32 CUDA cores, not the tensor cores, and passes x2,
// u and qkv through device memory, so it sits far above that bound.
// Design, in six launches on the caller's stream:
//   1. x2 = LN(x) * (1 + ms) + mt, one warp per pixel, rounded to the io dtype;
//   2. u = x2 @ Wqkv as a tiled GEMM, rounded to the io dtype;
//   3. the depthwise 3x3 (SAME zero padding) over all 3C channels, one
//      thread per output value, taps summed in the TPU kernel's order;
//   4. partial Gram sums: only the per-head diagonal [32, 32] blocks of
//      q^T k and the q/k column norms enter the softmax, so each block of
//      this kernel takes one (image, head, pixel split), stages 32-pixel
//      tiles of q and k through shared memory and writes its partial sums;
//      a Gram over all pixels of an image does not fit one block;
//   5. one block per (image, head) adds the partials in a fixed order (no
//      atomics, so the result does not change from run to run), applies the
//      L2 norms, temperature and row softmax, and folds project_out into the
//      head's 32 rows of M [C, C] (rounded to the io dtype);
//   6. out = x + gate * (v @ M) as a batched GEMM with the residual in its
//      epilogue, rounding as the TPU kernel: v @ M, gate * o and the sum.
// The TPU kernel recomputes LN and the projections in two passes to keep
// the image in VMEM; here u and qkv go through device memory (a later
// change can fuse them).  Its 128-lane channel padding and DMA ring are
// Mosaic constraints and are not ported.
#include "common.cuh"

namespace {

constexpr int HEAD = 32;           // channels per head (heads = C / 32)
constexpr int GRAM = HEAD * HEAD;  // one head's q^T k block
constexpr int PART = GRAM + 2 * HEAD;  // + q and k squared norms
constexpr int TILE_PX = 32;

template <typename T>
struct EpiStore {  // out[m, n] = acc rounded to the io dtype
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int, int m, int n, float acc) const {
    out[(long long)m * ld + n] = fd::from_f<T>(acc);
  }
};

template <typename T>
struct EpiGated {  // out = x + round(gate * round(acc)), per image z
  const T* x;
  const T* gate;
  T* out;
  int C, HW;
  __device__ __forceinline__ void operator()(int z, int m, int n, float acc) const {
    const long long i = ((long long)z * HW + m) * C + n;
    const float o = fd::round_io<T>(acc);
    const float g = fd::round_io<T>(fd::to_f<T>(gate[(long long)z * C + n]) * o);
    out[i] = fd::from_f<T>(fd::to_f<T>(x[i]) + g);
  }
};

template <typename T>
struct EpiDw {  // the depthwise conv's sum rounded to the io dtype
  T* out;
  __device__ __forceinline__ void operator()(long long i, int, float acc) const {
    out[i] = fd::from_f<T>(acc);
  }
};

// grid (splits, heads, B), 256 threads: partial q^T k block and norms of
// one head over one run of pixels of one image; qkv [B, HW, 3C]
template <typename T>
__global__ void __launch_bounds__(256)
gram_partial_kernel(const T* __restrict__ qkv, float* __restrict__ part, int HW, int C,
                    int per_split) {
  __shared__ float qs[TILE_PX][HEAD + 1];
  __shared__ float ks[TILE_PX][HEAD + 1];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int heads = gridDim.y, splits = gridDim.x;
  const int t = threadIdx.x;
  const int c = t >> 3, d0 = (t & 7) * 4;
  const T* img = qkv + (long long)b * HW * 3 * C;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float nrm = 0.f;
  const int p0 = s * per_split, p1 = min(HW, p0 + per_split);
  for (int base = p0; base < p1; base += TILE_PX) {
    for (int i = t; i < TILE_PX * 2 * HEAD; i += 256) {
      const int px = i / (2 * HEAD), j = i % (2 * HEAD);
      const int p = base + px;
      float v = 0.f;
      if (p < p1) {
        const long long ch = j < HEAD ? h * HEAD + j : C + h * HEAD + (j - HEAD);
        v = fd::to_f<T>(img[(long long)p * 3 * C + ch]);
      }
      if (j < HEAD) qs[px][j] = v; else ks[px][j - HEAD] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int px = 0; px < TILE_PX; ++px) {
      const float q = qs[px][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(q, ks[px][d0 + j], acc[j]);
    }
    if (t < 2 * HEAD) {
      for (int px = 0; px < TILE_PX; ++px) {
        const float v = t < HEAD ? qs[px][t] : ks[px][t - HEAD];
        nrm = fmaf(v, v, nrm);
      }
    }
    __syncthreads();
  }
  float* out = part + (((long long)b * heads + h) * splits + s) * PART;
#pragma unroll
  for (int j = 0; j < 4; ++j) out[c * HEAD + d0 + j] = acc[j];
  if (t < 2 * HEAD) out[GRAM + t] = nrm;
}

// grid (heads, B), 256 threads: reduce the partials, softmax, fold
// project_out.  pk [C_in, C_out] fp32; M [B, C, C] rows = v channels.
template <typename T>
__global__ void __launch_bounds__(256)
attn_fold_kernel(const float* __restrict__ part, const float* __restrict__ temp,
                 const float* __restrict__ pk, T* __restrict__ M, int C, int splits) {
  __shared__ float G[HEAD][HEAD + 1];
  __shared__ float nq[HEAD], nk[HEAD];
  const int h = blockIdx.x, b = blockIdx.y, heads = gridDim.x;
  const int t = threadIdx.x;
  const float* src = part + ((long long)b * heads + h) * splits * PART;
  for (int i = t; i < PART; i += 256) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += src[(long long)s * PART + i];
    if (i < GRAM) {
      G[i / HEAD][i % HEAD] = v;
    } else if (i < GRAM + HEAD) {
      nq[i - GRAM] = fmaxf(sqrtf(v), 1e-12f);
    } else {
      nk[i - GRAM - HEAD] = fmaxf(sqrtf(v), 1e-12f);
    }
  }
  __syncthreads();
  // one warp per query row c: logits over the head's 32 keys, softmax
  const int warp = t >> 5, lane = t & 31;
  const float tp = temp[h];
  for (int c = warp; c < HEAD; c += 8) {
    const float l = G[c][lane] / (nq[c] * nk[lane]) * tp;
    const float mx = fd::warp_max(l);
    const float e = expf(l - mx);
    const float sum = fd::warp_sum(e);
    G[c][lane] = e / sum;
  }
  __syncthreads();
  // M[h*32 + d, e] = sum_c attn[c, d] * pk[h*32 + c, e]
  T* Mb = M + (long long)b * C * C;
  for (int i = t; i < HEAD * C; i += 256) {
    const int d = i / C, e = i % C;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < HEAD; ++c) acc = fmaf(G[c][d], pk[(long long)(h * HEAD + c) * C + e], acc);
    Mb[(long long)(h * HEAD + d) * C + e] = fd::from_f<T>(acc);
  }
}

template <typename T>
int run(const void* x_, const float* ms, const float* mt, const void* gate_,
        const void* wqkv_, const void* taps_, const float* temp, const float* pk,
        void* out_, void* x2_, void* u_, void* qkv_, float* part, void* M_, int B, int H,
        int W, int C, int splits, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(x_);
  const T* gate = static_cast<const T*>(gate_);
  const T* wqkv = static_cast<const T*>(wqkv_);
  const T* taps = static_cast<const T*>(taps_);
  T* out = static_cast<T*>(out_);
  T* x2 = static_cast<T*>(x2_);
  T* u = static_cast<T*>(u_);
  T* qkv = static_cast<T*>(qkv_);
  T* M = static_cast<T*>(M_);
  const int HW = H * W, heads = C / HEAD;
  const long long P = (long long)B * HW;
  if (C % HEAD || P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  FD_TRY((fd::ln_rows<T, T>(x, nullptr, nullptr, ms, mt, x2, nullptr, P, HW, C, eps, s)));
  FD_TRY((fd::gemm<T>(1, (int)P, 3 * C, C, fd::RowStrided<T>{x2, 0, C}, wqkv, 0, 1, 3 * C,
                      EpiStore<T>{u, 3 * C}, s)));
  const long long total = P * 3 * C;
  FD_TRY((fd::dwconv3x3<T, false>(u, taps, H, W, 3 * C, total, EpiDw<T>{qkv}, s)));
  const int per_split = ((HW + splits - 1) / splits + TILE_PX - 1) / TILE_PX * TILE_PX;
  gram_partial_kernel<T><<<dim3(splits, heads, B), 256, 0, s>>>(qkv, part, HW, C, per_split);
  FD_TRY(cudaGetLastError());
  attn_fold_kernel<T><<<dim3(heads, B), 256, 0, s>>>(part, temp, pk, M, C, splits);
  FD_TRY(cudaGetLastError());
  FD_TRY((fd::gemm<T>(B, HW, C, C, fd::RowStrided<T>{qkv + 2 * C, (long long)HW * 3 * C, 3 * C},
                      M, (long long)C * C, B, C, EpiGated<T>{x, gate, out, C, HW}, s)));
  return 0;
}

}  // namespace

extern "C" int attn_block_forward(const void* x, const float* ms, const float* mt,
                                  const void* gate, const void* wqkv, const void* taps,
                                  const float* temp, const float* pk, void* out, void* x2,
                                  void* u, void* qkv, float* part, void* M, int B, int H,
                                  int W, int C, int splits, float eps, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, ms, mt, gate, wqkv, taps, temp, pk, out, x2, u, qkv, part, M, B, H,
                      W, C, splits, eps, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, ms, mt, gate, wqkv, taps, temp, pk, out, x2, u, qkv, part,
                              M, B, H, W, C, splits, eps, s);
  return (int)cudaErrorInvalidValue;
}
