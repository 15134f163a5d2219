// Shared device code of the port's kernels: dtype conversion, 16-byte
// vector loads and stores, warp reductions, the LayerNorm+modulation row
// kernel, GEMMs with a gathered A operand and a fused epilogue (the fp32
// CUDA cores, bf16 tensor cores, and fp32 on the tensor cores as three TF32
// products), and the warp-level tensor-core product they and the fused
// kernels share.
//
// Element types: float or __nv_bfloat16 activations ("io" dtype); every sum
// and every piece of arithmetic runs in fp32, and values are rounded to the
// io dtype exactly where the TPU kernels round them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// silu of an io-dtype value in fp32, rounded back to the io dtype (the
// FOUNDDIFF_SILU=kernel input of the fused SS2D block)
template <typename T> __device__ __forceinline__ float silu_io(float v) {
  return round_io<T>(v / (1.f + expf(-v)));
}

// Whether a GEMM's A-row functor asks for silu_io on each A element as it
// is loaded (a member SILU = true); functors without the member do not.
template <class R, class = void> struct RowSilu : std::false_type {};
template <class R>
struct RowSilu<R, std::void_t<decltype(R::SILU)>> : std::bool_constant<R::SILU> {};

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

constexpr int LN_THREADS = 256;

// ---------------------------------------------------------------------------
// The row LayerNorm of layer_norm, layer_norm_modulated and the SS2D tail's
// LN statistics: for each row of x [rows, C], fp32 mean and the one-pass
// variance E[x^2] - mean^2 (as _ln_kernel and _ln_mod_kernel), optional
// affine g/b [C], then * (1 + ms[b]) + mt[b] with ms/mt rows of stride ldm
// (b = row / R); ms == nullptr skips the modulation, out == nullptr writes
// (mean, rstd) pairs to stats instead.  Bound: bytes, the row read once and
// written once.  Where every row starts 16-byte aligned and C % Vec<Y>::N ==
// 0 (the host checks), a group of TPR threads (a power of two, at most 32,
// at least two vectors each where the row has them, so that a narrow row
// still keeps two loads in flight) takes a row in 16-byte vectors and holds
// it in registers, up to 32 fp32 values a thread (C <= 1024), so x is read
// once; otherwise TPR = 32 and the scalar loop reads the row twice (the
// second read from L1/L2).
// ---------------------------------------------------------------------------
template <typename T, typename Y>
__global__ void __launch_bounds__(LN_THREADS)
ln_rows_vec_kernel(const Y* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ b, const float* __restrict__ ms,
                   const float* __restrict__ mt, int ldm, T* __restrict__ out,
                   float* __restrict__ stats, long long rows, int R, int C, float eps,
                   int tpr, bool vec) {
  constexpr int VN = Vec<Y>::N, NV = 32 / VN;
  const int sub = threadIdx.x & (tpr - 1);
  const long long row = ((long long)blockIdx.x * LN_THREADS + threadIdx.x) / tpr;
  const bool live = row < rows;
  const Y* xr = x + (live ? row : rows - 1) * C;  // a dead group reads a live row
  const int nvec = C / VN;
  float v[NV][VN];
  float s = 0.f, ss = 0.f;
  if (vec) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * tpr + sub;
      if (j < nvec) {
        load_vec<Y>(xr + j * VN, v[i]);
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          s += v[i][e];
          ss += v[i][e] * v[i][e];
        }
      }
    }
  } else {
    for (int c = sub; c < C; c += tpr) {
      const float t = to_f<Y>(xr[c]);
      s += t;
      ss += t * t;
    }
  }
  for (int o = tpr / 2; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (!live) return;
  const float mean = s / C;
  const float rstd = rsqrtf(ss / C - mean * mean + eps);
  if (out == nullptr) {
    if (sub == 0) {
      stats[2 * row] = mean;
      stats[2 * row + 1] = rstd;
    }
    return;
  }
  const float* msr = ms == nullptr ? nullptr : ms + (row / R) * ldm;
  const float* mtr = ms == nullptr ? nullptr : mt + (row / R) * ldm;
  auto norm = [&](float t, int c) {
    float y = (t - mean) * rstd;
    if (g != nullptr) y = y * g[c] + b[c];
    if (msr != nullptr) y = y * (1.f + msr[c]) + mtr[c];
    return y;
  };
  T* orow = out + row * C;
  if (vec) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * tpr + sub;
      if (j < nvec) {
        float y[VN];
#pragma unroll
        for (int e = 0; e < VN; ++e) y[e] = norm(v[i][e], j * VN + e);
        if constexpr (std::is_same<T, Y>::value) {
          store_vec<T>(orow + j * VN, y);
        } else {
#pragma unroll
          for (int e = 0; e < VN; ++e) orow[j * VN + e] = from_f<T>(y[e]);
        }
      }
    }
  } else {
    for (int c = sub; c < C; c += tpr) orow[c] = from_f<T>(norm(to_f<Y>(xr[c]), c));
  }
}

template <typename T, typename Y>
cudaError_t ln_rows_vec(const Y* x, const float* g, const float* b, const float* ms,
                        const float* mt, int ldm, T* out, float* stats, long long rows, int R,
                        int C, float eps, cudaStream_t s) {
  constexpr int VN = Vec<Y>::N, NV = 32 / VN;
  const int nvec = C / VN;
  int tpr = 1;  // two vectors a thread where the row allows: two loads in flight
  while (tpr < 32 && 2 * tpr < nvec) tpr <<= 1;
  const bool vec = C % VN == 0 && nvec <= NV * tpr && aligned16(x) &&
                   (out == nullptr || aligned16(out));
  if (!vec) tpr = 32;
  const long long threads = rows * tpr;
  const unsigned grid = (unsigned)((threads + LN_THREADS - 1) / LN_THREADS);
  ln_rows_vec_kernel<T, Y><<<grid, LN_THREADS, 0, s>>>(x, g, b, ms, mt, ldm, out, stats, rows,
                                                       R, C, eps, tpr, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tiled GEMM on the CUDA cores: for each z, C[m, n] = sum_k A[m, k] B[k, n].
// A row m of slice z starts at rowA(z, m) (contiguous over k, io dtype), so
// callers can gather rows (the decimated scan directions) without a copy.
// B is row-major [K, N] with leading dimension ldb, slice z at
// B + (z % zmod) * strideBz (zmod = 1 shares one B across all z).
// The epilogue functor epi(z, m, n, acc) consumes the fp32 sum.  A RowA
// with SILU = true has each A element taken through silu_io as it is loaded.
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
      float a = (arow != nullptr && k < K) ? to_f<T>(arow[k]) : 0.f;
      if constexpr (RowSilu<RowA>::value) a = silu_io<T>(a);
      As[ak + i][ar] = a;
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
// The same GEMM on the bf16 tensor cores (T = __nv_bfloat16 only), with
// gemm's interface: A rows from rowA(z, m), B row-major [K, N] at
// B + (z % zmod) * strideBz with leading dimension ldb, epi(z, m, n, acc)
// on each fp32 sum.  mma.sync.aligned.m16n8k16 with fp32 sums; A and B tiles
// streamed into shared memory by 16-byte cp.async in TC_STAGES stages, the
// fragments read with ldmatrix (.trans for the row-major B).  Block tile
// 128 x 64, k in steps of 32, 8 warps of 32 x 32.  Ragged M, N and K edges
// are zero-filled (cp.async with a source size of 0).  The 16-byte copies
// need K % 8 == 0, N % 8 == 0, ldb % 8 == 0 and every A row and B 16-byte
// aligned: gemm_tc_ok checks what the host can see, and the caller keeps
// gemm for the rest.  The products of bf16 operands are exact in fp32, so
// against gemm only the order of the sums differs.  Hopper's wgmma and TMA
// would reach further; this is the simple tensor-core form.  A RowA with
// SILU = true has the landed A tile taken through silu_io in shared memory
// before its fragments are read (silu(0) = 0 keeps the zero fill).
// ---------------------------------------------------------------------------
constexpr int TC_BM = 128, TC_BN = 64, TC_BK = 32, TC_THREADS = 256, TC_STAGES = 3;
constexpr int TC_APAD = TC_BK + 8, TC_BPAD = TC_BN + 8;  // rows 80 and 144 bytes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class RowA, class Epi>
__global__ void __launch_bounds__(TC_THREADS)
gemm_tc_kernel(int M, int N, int K, RowA rowA, const __nv_bfloat16* __restrict__ B,
               long long strideBz, int zmod, int ldb, Epi epi) {
  __shared__ __align__(16) __nv_bfloat16 As[TC_STAGES][TC_BM][TC_APAD];
  __shared__ __align__(16) __nv_bfloat16 Bs[TC_STAGES][TC_BK][TC_BPAD];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const __nv_bfloat16* Bz = B + (long long)(z % zmod) * strideBz;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  // this thread's copies: A rows tid/4 and tid/4 + 64 at k chunk tid%4;
  // B row tid/8 at n chunk tid%8 (each chunk 8 values, 16 bytes)
  const __nv_bfloat16* arow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + 64 * i;
    arow[i] = m < M ? rowA(z, m) : nullptr;
  }
  const int ak = (tid & 3) * 8, br = tid >> 3, bn = n0 + (tid & 7) * 8;
  auto load = [&](int stage, int kt) {
    const int k0 = kt * TC_BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = arow[i] != nullptr && k0 + ak < K;
      cp_async16(&As[stage][(tid >> 2) + 64 * i][ak], ok ? arow[i] + k0 + ak : B, ok ? 16 : 0);
    }
    const int k = k0 + br;
    const bool ok = k < K && bn < N;
    cp_async16(&Bs[stage][br][(tid & 7) * 8], ok ? Bz + (long long)k * ldb + bn : B,
               ok ? 16 : 0);
  };
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int kts = (K + TC_BK - 1) / TC_BK;
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < kts) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < kts; ++kt) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    if (kt + TC_STAGES - 1 < kts) load((kt + TC_STAGES - 1) % TC_STAGES, kt + TC_STAGES - 1);
    cp_async_commit();
    const int st = kt % TC_STAGES;
    if constexpr (RowSilu<RowA>::value) {
      for (int i = tid; i < TC_BM * TC_BK; i += TC_THREADS) {
        __nv_bfloat16& e = As[st][i / TC_BK][i % TC_BK];
        e = __float2bfloat16_rn(silu_io<__nv_bfloat16>(__bfloat162float(e)));
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      unsigned a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], &As[st][wm + 16 * i + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(b[j], &Bs[st][kk + (lane & 15)][wn + 16 * j + (lane >> 4) * 8]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  // accumulator fragment: c0, c1 at row lane/4, columns 2 (lane%4) + {0, 1};
  // c2, c3 eight rows below
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * i + (lane >> 2) + 8 * (e >> 1);
        const int n = n0 + wn + 8 * j + 2 * (lane & 3) + (e & 1);
        if (m < M && n < N) epi(z, m, n, acc[i][j][e]);
      }
}

// Whether gemm_tc takes these operands: what its 16-byte copies need of the
// shapes and of the base pointers (A's rows then align when lda % 8 == 0)
inline bool gemm_tc_ok(int N, int K, int lda, int ldb, long long strideBz, const void* A,
                       const void* B) {
  return K % 8 == 0 && N % 8 == 0 && lda % 8 == 0 && ldb % 8 == 0 && strideBz % 8 == 0 &&
         aligned16(A, B);
}

template <class RowA, class Epi>
cudaError_t gemm_tc(int Z, int M, int N, int K, RowA rowA, const __nv_bfloat16* B,
                    long long strideBz, int zmod, int ldb, Epi epi, cudaStream_t s) {
  dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, Z);
  gemm_tc_kernel<RowA, Epi><<<grid, TC_THREADS, 0, s>>>(M, N, K, rowA, B, strideBz, zmod, ldb,
                                                        epi);
  return cudaGetLastError();
}

// gemm_tc for bf16 operands that gemm_tc_ok takes (tc), else gemm
template <typename T, class RowA, class Epi>
cudaError_t gemm_io(bool tc, int Z, int M, int N, int K, RowA rowA, const T* B,
                    long long strideBz, int zmod, int ldb, Epi epi, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tc) return gemm_tc(Z, M, N, K, rowA, B, strideBz, zmod, ldb, epi, s);
  }
  return gemm<T>(Z, M, N, K, rowA, B, strideBz, zmod, ldb, epi, s);
}

// Launch a kernel with its dynamic shared memory, opting in above the 48 KB
// default.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kern, dim3 grid, int threads, size_t smem, cudaStream_t s,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 products on the tensor cores as three TF32 products ("3xTF32"): each
// operand v splits into hi = tf32(v) and lo = tf32(v - hi), and a * b is
// summed as a_lo b_hi + a_hi b_lo + a_hi b_hi (the lo * lo term, below
// 2^-22 of the product, is dropped), with fp32 sums: about the accuracy
// of an fp32 product at three TF32 rates (495 TFLOP/s dense).  Used where
// an fp32 kernel holds the fp32 tolerance this way (attn_block.cu,
// scan_image.cu, scan.cu's fused-projection scan, ss2d_epilogue.cu and
// mamba_block.cu's front half; flash_attention.cu splits its own operands);
// the SS2D tail and the scan kernels' other sums stay on the CUDA cores.
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned tf32_bits(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(v - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's (16 MI) x (8 NJ) tile of A B over kc values of k, both
// operands in shared memory: A row-major at As (the warp's first row, lda
// elements a row), B row-major [k][n] at Bs (the warp's first column, ldb
// a row).  bf16: ldmatrix and mma m16n8k16 (kc % 16 == 0, NJ even, rows
// 16-byte aligned); fp32: scalar loads and 3xTF32 mma m16n8k8 (kc % 8 ==
// 0).  acc[i][j] holds the m16n8 fragment: c0, c1 at row lane/4, columns
// 2 (lane%4) + {0, 1}; c2, c3 eight rows below.
template <typename T, int MI, int NJ>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NJ][4], const T* As, int lda,
                                         const T* Bs, int ldb, int kc, int lane) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    for (int k = 0; k < kc; k += 16) {
      unsigned a[MI][4], b[NJ / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], As + (16 * i + (lane & 15)) * lda + k + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j)
        ldmatrix_x4_trans(b[j], Bs + (k + (lane & 15)) * ldb + 16 * j + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    for (int k = 0; k < kc; k += 8) {
      unsigned ah[MI][4], al[MI][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float* a = As + (16 * i + g) * lda + k + t;
        split_tf32(a[0], ah[i][0], al[i][0]);
        split_tf32(a[8 * lda], ah[i][1], al[i][1]);
        split_tf32(a[4], ah[i][2], al[i][2]);
        split_tf32(a[8 * lda + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* b = Bs + (k + t) * ldb + 8 * j + g;
        split_tf32(b[0], bh[j][0], bl[j][0]);
        split_tf32(b[4 * ldb], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
          mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
          mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// gemm_tc's fp32 counterpart on the tensor cores (3xTF32), with gemm's
// interface: block tile 128 x 64, k in steps of 16 in X3_STAGES cp.async
// stages (44.5 KB of static shared memory), 8 warps of 32 x 32, three
// blocks an SM (at most 85 registers: the loads' latency, not the products,
// bounds it at K = 128 to 256); a warp whose columns all lie past N (in the
// last column tile) skips the products.  The 16-byte copies need K, N, lda, ldb and strideBz % 4 == 0
// and A and B 16-byte aligned (gemm_x3_ok).
// ---------------------------------------------------------------------------
constexpr int X3_BK = 16, X3_STAGES = 3;
constexpr int X3_APAD = X3_BK + 4, X3_BPAD = TC_BN + 8;  // conflict-free fragment loads

template <class RowA, class Epi>
__global__ void __launch_bounds__(TC_THREADS, 3)
gemm_x3_kernel(int M, int N, int K, RowA rowA, const float* __restrict__ B,
               long long strideBz, int zmod, int ldb, Epi epi) {
  static_assert(!RowSilu<RowA>::value, "gemm_x3 takes A rows as they are");
  __shared__ __align__(16) float As[X3_STAGES][TC_BM][X3_APAD];
  __shared__ __align__(16) float Bs[X3_STAGES][X3_BK][X3_BPAD];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const float* Bz = B + (long long)(z % zmod) * strideBz;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const bool live = n0 + wn < N;  // warp-uniform
  // this thread's copies: A rows tid/4 and tid/4 + 64 at k chunk tid%4;
  // B row tid/16 at n chunk tid%16 (each chunk 4 values, 16 bytes)
  const float* arow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + 64 * i;
    arow[i] = m < M ? rowA(z, m) : nullptr;
  }
  const int ak = (tid & 3) * 4, br = tid >> 4, bn = n0 + (tid & 15) * 4;
  auto load = [&](int stage, int kt) {
    const int k0 = kt * X3_BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = arow[i] != nullptr && k0 + ak < K;
      cp_async16(&As[stage][(tid >> 2) + 64 * i][ak], ok ? arow[i] + k0 + ak : B, ok ? 16 : 0);
    }
    const int k = k0 + br;
    const bool ok = k < K && bn < N;
    cp_async16(&Bs[stage][br][(tid & 15) * 4], ok ? Bz + (long long)k * ldb + bn : B,
               ok ? 16 : 0);
  };
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int kts = (K + X3_BK - 1) / X3_BK;
#pragma unroll
  for (int st = 0; st < X3_STAGES - 1; ++st) {
    if (st < kts) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < kts; ++kt) {
    cp_async_wait<X3_STAGES - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    if (kt + X3_STAGES - 1 < kts) load((kt + X3_STAGES - 1) % X3_STAGES, kt + X3_STAGES - 1);
    cp_async_commit();
    const int st = kt % X3_STAGES;
    if (live)
      warp_mma<float, 2, 4>(acc, &As[st][wm][0], X3_APAD, &Bs[st][0][wn], X3_BPAD, X3_BK,
                            lane);
  }
  cp_async_wait<0>();
  if (!live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * i + (lane >> 2) + 8 * (e >> 1);
        const int n = n0 + wn + 8 * j + 2 * (lane & 3) + (e & 1);
        if (m < M && n < N) epi(z, m, n, acc[i][j][e]);
      }
}

inline bool gemm_x3_ok(int N, int K, int lda, int ldb, long long strideBz, const void* A,
                       const void* B) {
  return K % 4 == 0 && N % 4 == 0 && lda % 4 == 0 && ldb % 4 == 0 && strideBz % 4 == 0 &&
         aligned16(A, B);
}

// The products of the redesigned kernels: on the tensor cores
// where the operands allow (bf16: gemm_tc; fp32: gemm_x3), else gemm.
// lda and A (the first row) are only checked.
template <typename T, class RowA, class Epi>
cudaError_t gemm_mma(int Z, int M, int N, int K, RowA rowA, int lda, const T* A, const T* B,
                     long long strideBz, int zmod, int ldb, Epi epi, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (gemm_x3_ok(N, K, lda, ldb, strideBz, A, B)) {
      dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, Z);
      gemm_x3_kernel<RowA, Epi><<<grid, TC_THREADS, 0, s>>>(M, N, K, rowA, B, strideBz, zmod,
                                                            ldb, epi);
      return cudaGetLastError();
    }
  }
  return gemm_io<T>(gemm_tc_ok(N, K, lda, ldb, strideBz, A, B), Z, M, N, K, rowA, B, strideBz,
                    zmod, ldb, epi, s);
}

}  // namespace fd

#define FD_TRY(expr)                      \
  do {                                    \
    cudaError_t fd_err_ = (expr);         \
    if (fd_err_ != cudaSuccess) return (int)fd_err_; \
  } while (0)
