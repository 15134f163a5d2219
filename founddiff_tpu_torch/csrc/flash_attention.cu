// Flash attention: the online-softmax forward that keeps the per-row
// logsumexp, and the two kernels of its backward.
//
// Replaces the TPU kernels of founddiff_tpu/ops/attention_pallas.py:
//   fwd_kernel  <- _fwd_kernel     (:47, pallas_call :119 in _flash_fwd_impl)
//   dq_kernel   <- _bwd_dq_kernel  (:161, pallas_call :275 in _flash_bwd_impl)
//   dkv_kernel  <- _bwd_dkv_kernel (:201, pallas_call :293 in _flash_bwd_impl)
//
// Math, per sequence g of G = B * H, query row i and key row j:
//   forward   s_ij = (scale q_i) . k_j,  o_i = sum_j softmax_j(s_ij) v_j,
//             lse_i = m_i + log l_i   (m_i the row max, l_i = sum_j exp(s_ij - m_i));
//   backward  p_ij = exp(scale (q_i . k_j) - lse_i),  dp_ij = p_ij (do_i . v_j - D_i),
//             dq_i = scale sum_j dp_ij k_j,  dk_j = scale sum_i dp_ij q_i,
//             dv_j = sum_i p_ij do_i,  with D_i = rowsum(do_i * o_i) given.
//
// Bound on the H100: operations.  At d = 32 each (i, j) pair costs 4d
// forward and 14d backward flops against 4 * d * (Lq + Lk) bytes per
// sequence: hundreds of flops per byte.  In fp32 (no TF32) the products are
// CUDA-core work; in bf16 the tensor cores would do them faster than the
// SFU takes the exponentials.  This first version runs everything on the
// fp32 CUDA cores in both dtypes (bf16 inputs are widened at the load), so
// the bf16 kernels do the fp32 kernels' work and no p is rounded to bf16.
//
// Design: each row of the side a kernel writes (a query row for fwd and
// dq, a key row for dkv) is owned by D / 16 neighbouring threads of a warp,
// each holding 16 of the row's d values and their fp32 accumulators in
// registers (all of a row at one thread took 255 registers and spilled in
// the backward); a dot product is summed over the 16 values by each thread
// and then over the row's threads by shuffles.  A block of 64 rows walks the
// other side in tiles of 64 rows staged in shared memory as fp32, all
// threads reading the same staged row at once (a broadcast).  Each thread
// forms a few dot products side by side (independent FMA chains), takes the
// softmax step for them, then folds them into its accumulators.  A block
// loops over all tiles of the other side itself, so dk/dv (summed over q on
// the TPU's sequential grid axis) and dq need no atomics: every run gives
// the same bits.  lse is [G, Lq] fp32 (the TPU keeps 8 sublane copies per
// q block); ragged lengths are cut at the tile edge in-kernel (no padded
// copies), and keys past Lk get the weight exp(-inf) = 0 exactly.
// wgmma, TMA and warp specialisation are left for a later version.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int ROWS = 64;    // rows owned by a block
constexpr int TILE = 64;    // rows of the other side staged per step
constexpr int D = 32;       // head dim: the vanilla UNet's Attention runs 4 heads of 32
constexpr int DT = 16;      // d values per thread: a row spans D / DT threads
constexpr int FWD_KC = 16;  // keys per online-softmax step (forward)
constexpr int BWD_KC = 8;   // rows of the other side per step (backward)

constexpr int THREADS = ROWS * (D / DT);

using fd::load_vec;

// This thread's DT values of a row (zeros for a row past the end).
template <typename T>
__device__ __forceinline__ void load_part(const T* __restrict__ p, bool live, float (&r)[DT]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < DT; c += VEC) {
    if (live) {
      load_vec<T>(p + c, &r[c]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) r[c + e] = 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_part(T* __restrict__ p, const float (&r)[DT], float mul) {
#pragma unroll
  for (int c = 0; c < DT; ++c) p[c] = fd::from_f<T>(r[c] * mul);
}

// Rows [r0, r0 + TILE) of a row-major [L, D] matrix into dst [TILE][D] fp32,
// rows at or past L as zeros; coalesced 16-byte loads over the whole block.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int L, int r0,
                                      float* __restrict__ dst) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < TILE * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    float* out = dst + r * D + c;
    if (r0 + r < L) {
      load_vec<T>(src + (long long)(r0 + r) * D + c, out);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = 0.f;
    }
  }
}

// The sum of v over the D / DT neighbouring threads that share a row.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = D / DT / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This thread's partial dot product of its DT values r with the staged row at p.
__device__ __forceinline__ float dot_part(const float* p, const float (&r)[DT]) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DT; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + d);
    acc = fmaf(r[d], x.x, acc);
    acc = fmaf(r[d + 1], x.y, acc);
    acc = fmaf(r[d + 2], x.z, acc);
    acc = fmaf(r[d + 3], x.w, acc);
  }
  return acc;
}

// y += a * (the staged row at p), over this thread's DT values.
__device__ __forceinline__ void axpy_part(float a, const float* p, float (&y)[DT]) {
#pragma unroll
  for (int d = 0; d < DT; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + d);
    y[d] = fmaf(a, x.x, y[d]);
    y[d + 1] = fmaf(a, x.y, y[d + 1]);
    y[d + 2] = fmaf(a, x.z, y[d + 2]);
    y[d + 3] = fmaf(a, x.w, y[d + 3]);
  }
}

// ---------------------------------------------------------------------------
// forward: D / DT threads per query row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int Lq, int Lk, float scale) {
  __shared__ __align__(16) float ks[TILE * D];
  __shared__ __align__(16) float vs[TILE * D];
  const int g = blockIdx.y;
  const int row = blockIdx.x * ROWS + threadIdx.x / (D / DT);
  const int d0 = threadIdx.x % (D / DT) * DT;
  const bool live = row < Lq;
  const long long qrow = (long long)g * Lq + row;
  const T* kg = k + (long long)g * Lk * D;
  const T* vg = v + (long long)g * Lk * D;
  float qr[DT], acc[DT];
  load_part<T>(q + qrow * D + d0, live, qr);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    qr[d] *= scale;  // q scaled in fp32 before the product (attention_pallas.py:61)
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    __syncthreads();
    stage<T>(kg, Lk, k0, ks);
    stage<T>(vg, Lk, k0, vs);
    __syncthreads();
    const int n = min(TILE, Lk - k0);
    for (int c0 = 0; c0 < n; c0 += FWD_KC) {
      float s[FWD_KC];
#pragma unroll
      for (int c = 0; c < FWD_KC; ++c) s[c] = dot_part(&ks[(c0 + c) * D + d0], qr);
      float mc = m;
#pragma unroll
      for (int c = 0; c < FWD_KC; ++c) {
        s[c] = row_sum(s[c]);
        if (c0 + c >= n) s[c] = -INFINITY;  // keys past Lk: weight exactly 0
        mc = fmaxf(mc, s[c]);
      }
      const float alpha = expf(m - mc);  // 0 at the first step (m = -inf)
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < FWD_KC; ++c) {
        const float p = expf(s[c] - mc);
        l += p;
        axpy_part(p, &vs[(c0 + c) * D + d0], acc);
      }
      m = mc;
    }
  }
  if (!live) return;
  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d] = acc[d] / lc;
  store_part<T>(o + qrow * D + d0, acc, 1.f);
  if (d0 == 0) lse[qrow] = m + logf(lc);
}

// ---------------------------------------------------------------------------
// dq: D / DT threads per query row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dcap, T* __restrict__ dq, int Lq, int Lk, float scale) {
  __shared__ __align__(16) float ks[TILE * D];
  __shared__ __align__(16) float vs[TILE * D];
  const int g = blockIdx.y;
  const int row = blockIdx.x * ROWS + threadIdx.x / (D / DT);
  const int d0 = threadIdx.x % (D / DT) * DT;
  const bool live = row < Lq;
  const long long qrow = (long long)g * Lq + row;
  const T* kg = k + (long long)g * Lk * D;
  const T* vg = v + (long long)g * Lk * D;
  float qr[DT], dor[DT], acc[DT];
  load_part<T>(q + qrow * D + d0, live, qr);
  load_part<T>(dout + qrow * D + d0, live, dor);
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d] = 0.f;
  const float li = live ? lse[qrow] : 0.f;
  const float Di = live ? dcap[qrow] : 0.f;
  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    __syncthreads();
    stage<T>(kg, Lk, k0, ks);
    stage<T>(vg, Lk, k0, vs);
    __syncthreads();
    const int n = min(TILE, Lk - k0);
    for (int c0 = 0; c0 < n; c0 += BWD_KC) {
      float s[BWD_KC], dov[BWD_KC];
#pragma unroll
      for (int c = 0; c < BWD_KC; ++c) {
        s[c] = dot_part(&ks[(c0 + c) * D + d0], qr);
        dov[c] = dot_part(&vs[(c0 + c) * D + d0], dor);
      }
#pragma unroll
      for (int c = 0; c < BWD_KC; ++c) {
        // the product scaled, then exp(s - lse) (attention_pallas.py:179-187)
        const float sc = row_sum(s[c]), dv = row_sum(dov[c]);
        const float p = c0 + c < n ? expf(scale * sc - li) : 0.f;
        axpy_part(p * (dv - Di), &ks[(c0 + c) * D + d0], acc);
      }
    }
  }
  if (live) store_part<T>(dq + qrow * D + d0, acc, scale);
}

// ---------------------------------------------------------------------------
// dk, dv: D / DT threads per key row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ dcap, T* __restrict__ dk, T* __restrict__ dv, int Lq,
           int Lk, float scale) {
  __shared__ __align__(16) float qs[TILE * D];
  __shared__ __align__(16) float dos[TILE * D];
  __shared__ float ls[TILE], Ds[TILE];
  const int g = blockIdx.y;
  const int col = blockIdx.x * ROWS + threadIdx.x / (D / DT);
  const int d0 = threadIdx.x % (D / DT) * DT;
  const bool live = col < Lk;
  const long long krow = (long long)g * Lk + col;
  const T* qg = q + (long long)g * Lq * D;
  const T* dg = dout + (long long)g * Lq * D;
  float kr[DT], vr[DT], dka[DT], dva[DT];
  load_part<T>(k + krow * D + d0, live, kr);
  load_part<T>(v + krow * D + d0, live, vr);
#pragma unroll
  for (int d = 0; d < DT; ++d) dka[d] = dva[d] = 0.f;
  for (int q0 = 0; q0 < Lq; q0 += TILE) {
    __syncthreads();
    stage<T>(qg, Lq, q0, qs);
    stage<T>(dg, Lq, q0, dos);
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      const bool in = q0 + i < Lq;
      ls[i] = in ? lse[(long long)g * Lq + q0 + i] : 0.f;
      Ds[i] = in ? dcap[(long long)g * Lq + q0 + i] : 0.f;
    }
    __syncthreads();
    const int n = min(TILE, Lq - q0);
    for (int c0 = 0; c0 < n; c0 += BWD_KC) {
      float s[BWD_KC], dov[BWD_KC];
#pragma unroll
      for (int c = 0; c < BWD_KC; ++c) {
        s[c] = dot_part(&qs[(c0 + c) * D + d0], kr);
        dov[c] = dot_part(&dos[(c0 + c) * D + d0], vr);
      }
#pragma unroll
      for (int c = 0; c < BWD_KC; ++c) {
        const float sc = row_sum(s[c]), dpc = row_sum(dov[c]);
        const float p = c0 + c < n ? expf(scale * sc - ls[c0 + c]) : 0.f;
        axpy_part(p, &dos[(c0 + c) * D + d0], dva);
        axpy_part(p * (dpc - Ds[c0 + c]), &qs[(c0 + c) * D + d0], dka);
      }
    }
  }
  if (!live) return;
  store_part<T>(dk + krow * D + d0, dka, scale);
  store_part<T>(dv + krow * D + d0, dva, 1.f);
}

dim3 grid_of(int rows, int G) { return dim3((unsigned)((rows + ROWS - 1) / ROWS), (unsigned)G); }

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int G, int Lq, int Lk,
        float scale, cudaStream_t s) {
  if (!fd::aligned16(q, k, v)) return (int)cudaErrorMisalignedAddress;
  fwd_kernel<T><<<grid_of(Lq, G), THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Lq, Lk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* dcap, void* dq, int G, int Lq, int Lk, float scale, cudaStream_t s) {
  if (!fd::aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  dq_kernel<T><<<grid_of(Lq, G), THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dcap, static_cast<T*>(dq), Lq, Lk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* dcap, void* dk, void* dv, int G, int Lq, int Lk, float scale,
            cudaStream_t s) {
  if (!fd::aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  dkv_kernel<T><<<grid_of(Lk, G), THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dcap, static_cast<T*>(dk), static_cast<T*>(dv), Lq,
      Lk, scale);
  return (int)cudaGetLastError();
}

// Returns FN<T>(args...) for the io dtype code; the head dim d must be D.
#define FD_DISPATCH(FN, ...)                                                 \
  do {                                                                        \
    if (G <= 0 || Lq <= 0 || Lk <= 0 || d != D) return (int)cudaErrorInvalidValue; \
    if (dtype == 0) return FN<float>(__VA_ARGS__);                            \
    if (dtype == 1) return FN<__nv_bfloat16>(__VA_ARGS__);                    \
    return (int)cudaErrorInvalidValue;                                        \
  } while (0)

}  // namespace

// q [G, Lq, d], k and v [G, Lk, d] at the io dtype (0 fp32, 1 bf16), d = 32.
// Writes o [G, Lq, d] (io) and lse [G, Lq] fp32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         int G, int Lq, int Lk, int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FD_DISPATCH(fwd, q, k, v, o, lse, G, Lq, Lk, scale, s);
}

// The forward's q, k, v, the cotangent dout [G, Lq, d] (io), its lse and
// dcap = rowsum(dout * o) [G, Lq] fp32.  Writes dq [G, Lq, d] (io).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* dcap, void* dq, int G, int Lq,
                            int Lk, int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FD_DISPATCH(bwd_dq, q, k, v, dout, lse, dcap, dq, G, Lq, Lk, scale, s);
}

// Operands as flash_bwd_dq.  Writes dk and dv [G, Lk, d] (io).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* dcap, void* dk, void* dv, int G,
                             int Lq, int Lk, int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FD_DISPATCH(bwd_dkv, q, k, v, dout, lse, dcap, dk, dv, G, Lq, Lk, scale, s);
}
