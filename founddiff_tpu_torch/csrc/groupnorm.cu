// GroupNorm + SiLU (+ residual) of the resnet blocks: the group statistics
// finished on the card, then one fused normalise + affine + SiLU (+ residual)
// pass.
//
// Replaces the TPU kernels _stats_kernel (founddiff_tpu/ops/groupnorm_pallas.py:38,
// launched :83) and _apply_kernel (:50, launched :111), and the group step
// JAX computes between them outside its kernels (:98-107) together with the
// per-image affine fold of group_norm_silu (:234-240).
//
// Bound on the H100: bytes, both.  gn_stats reads x once with 3 flops per
// element; gn_apply reads x (and the residual) and writes y with 4 flops and
// one exponential per element, far below the card's flop/byte ridge.
// Design:
//   - gn_stats: nblk blocks an image (the host picks nblk so that a block
//     streams at least 32 KB of x and the call runs at most about 264
//     blocks) take its row tiles in turn, so the blocks in flight read one
//     contiguous front.  Each thread keeps the sums of V neighbouring
//     channels in registers over its rows, four 16-byte loads in flight;
//     the block adds its row groups and channels to 2G group sums through
//     shared memory in a fixed order and writes them as its partial.  The
//     last block of each image to finish (an integer ticket after a
//     __threadfence) adds the image's partials in a fixed order, computes
//     mean and rstd = rsqrt(E[x^2] - mean^2 + eps) in fp32 as the JAX package
//     does, and writes the apply pass's per-channel coefficients
//     a = rstd * g, c = b - mean * a with g = gamma * (ms + 1) and
//     b = beta * (ms + 1) + mt (the modulation read in place, rows of stride
//     ldm; none when ms is null) to a [B, 2, C] fp32 table.  It sets its
//     ticket back to 0, so the next call on the stream finds it zero.  No
//     float atomics: every run gives the same bits.
//   - gn_apply: blocks over (row tiles x B); a thread owns V channels, loads
//     their two coefficients once, then streams rows with 16-byte loads of x
//     (and the residual, never read when there is none):
//     y = silu(x * a + c) (+ r).
//   - gn_silu_forward launches both in one host call.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // rows of 16-byte loads in flight per thread
constexpr int FINISH_LOADS = 16;  // partials in flight per thread of the last block
constexpr int APPLY_TILE_BYTES = 32 * 1024;

using fd::load_vec;
using fd::store_vec;
using fd::Vec;

// grid (blocks per image, B); block blk of image b reduces the row tiles
// blk, blk + nblk, ... of the image to 2G group sums (interleaved, so the
// blocks in flight stream one contiguous front of x); the image's last block
// writes its table row
template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const float* __restrict__ ms,
                const float* __restrict__ mt, float* __restrict__ table,
                float* __restrict__ partial, unsigned* __restrict__ tickets, int R, int C,
                int G, int ldm, float eps) {
  constexpr int V = Vec<T>::N;
  __shared__ float red[2 * THREADS * V];  // [row group][2][C], then scratch
  __shared__ bool last;
  const int tpr = C / V, rgs = THREADS / tpr, cg = C / G, G2 = 2 * G;
  const int t = threadIdx.x, cv = t % tpr, rg = t / tpr;
  const int blk = blockIdx.x, nblk = gridDim.x, b = blockIdx.y;
  if (rg < rgs) {
    float s[V], q[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
    const T* xb = x + (long long)b * R * C + cv * V;
    const int rows = rgs * UNROLL, tiles = (R + rows - 1) / rows;
    for (int tile = blk; tile < tiles; tile += nblk) {
      const int r = tile * rows + rg;
      float v[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * rgs < R) {
          load_vec<T>(xb + (long long)(r + u * rgs) * C, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += v[u][i];
          q[i] += v[u][i] * v[u][i];
        }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[(rg * 2) * C + cv * V + i] = s[i];
      red[(rg * 2 + 1) * C + cv * V + i] = q[i];
    }
  }
  __syncthreads();
  // the block's 2G sums: warp w takes outputs w, w + 8, ...; output o is
  // half o / G (sum, sum of squares) of group o % G; lanes add fixed
  // (row group, channel) pairs, then the warp's xor tree
  const int lane = t & 31;
  float* part = partial + ((long long)b * nblk + blk) * G2;
  for (int o = t >> 5; o < G2; o += THREADS / 32) {
    const int h = o / G, g = o - h * G;
    float acc = 0.f;
    for (int i = lane; i < rgs * cg; i += 32) {
      const int k = i / cg;
      acc += red[(k * 2 + h) * C + g * cg + (i - k * cg)];
    }
    acc = fd::warp_sum(acc);
    if (lane == 0) part[o] = acc;
  }
  // thread 0 orders the block's partial (seen through the barrier) before
  // its ticket, and the last block's reads after every other ticket, as a
  // cooperative grid barrier does
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(&tickets[b], 1u) == (unsigned)(nblk - 1);
    if (last) {
      tickets[b] = 0u;  // every block of the image has taken its ticket
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  // the first channel's operands, loaded while the partials are added
  float ge0 = 0.f, be0 = 0.f, ms0 = 0.f, mt0 = 0.f;
  if (t < C) {
    ge0 = gamma[t];
    be0 = beta[t];
    if (ms != nullptr) {
      ms0 = ms[(long long)b * ldm + t];
      mt0 = mt[(long long)b * ldm + t];
    }
  }
  // the image's partials: thread (slice, o) adds blocks slice, slice + S, ...
  // of output o, then the S slices are added in slice order
  const float* pb = partial + (long long)b * nblk * G2;
  const int S = G2 < THREADS ? THREADS / G2 : 1;
  for (int i = t; i < S * G2; i += THREADS) {
    const int sl = i / G2, o = i - sl * G2;
    float acc = 0.f;
    for (int k0 = sl; k0 < nblk; k0 += FINISH_LOADS * S) {
      float v[FINISH_LOADS];  // all issued before the first add: one L2 latency a batch
#pragma unroll
      for (int j = 0; j < FINISH_LOADS; ++j) {
        const int k = k0 + j * S;
        v[j] = k < nblk ? __ldcg(pb + (long long)k * G2 + o) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < FINISH_LOADS; ++j) acc += v[j];
    }
    red[i] = acc;
  }
  __syncthreads();
  float* stat = red + S * G2;  // [2][G]: mean, rstd
  for (int g = t; g < G; g += THREADS) {
    float sum = 0.f, sq = 0.f;
    for (int sl = 0; sl < S; ++sl) {
      sum += red[sl * G2 + g];
      sq += red[sl * G2 + G + g];
    }
    const float n = (float)R * (float)cg;
    const float mean = sum / n;
    stat[g] = mean;
    stat[G + g] = rsqrtf(sq / n - mean * mean + eps);
  }
  __syncthreads();
  float* tb = table + (long long)b * 2 * C;
  for (int c = t; c < C; c += THREADS) {
    const int g = c / cg;
    float ge = ge0, be = be0, sc = ms0, sh = mt0;
    if (c != t) {
      ge = gamma[c];
      be = beta[c];
      if (ms != nullptr) {
        sc = ms[(long long)b * ldm + c];
        sh = mt[(long long)b * ldm + c];
      }
    }
    if (ms != nullptr) {
      const float m1 = sc + 1.f;
      ge = ge * m1;
      be = __fmul_rn(be, m1) + sh;
    }
    // products rounded before the sums, as the plain version's
    const float a = stat[G + g] * ge;
    tb[c] = a;
    tb[C + c] = be - __fmul_rn(stat[g], a);
  }
}

__device__ __forceinline__ float silu(float y) { return y * __frcp_rn(1.f + __expf(-y)); }

// grid (row tiles, B): y = silu(x * a + c) (+ res), a and c rows of table[b]
template <typename T, bool RES>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ table,
                const T* __restrict__ res, T* __restrict__ out, int R, int C, int rows) {
  constexpr int V = Vec<T>::N;
  const int tpr = C / V, rgs = THREADS / tpr;
  const int t = threadIdx.x, cv = t % tpr, rg = t / tpr;
  if (rg >= rgs) return;
  const int b = blockIdx.y;
  float a[V], c[V];
  const float* tb = table + (long long)b * 2 * C + cv * V;
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 av = *reinterpret_cast<const float4*>(tb + i);
    const float4 cvv = *reinterpret_cast<const float4*>(tb + C + i);
    a[i] = av.x, a[i + 1] = av.y, a[i + 2] = av.z, a[i + 3] = av.w;
    c[i] = cvv.x, c[i + 1] = cvv.y, c[i + 2] = cvv.z, c[i + 3] = cvv.w;
  }
  const long long base = (long long)b * R * C + cv * V;
  const int tile = blockIdx.x, r1 = min(R, (tile + 1) * rows);
  int r = tile * rows + rg;
  for (; r + (UNROLL - 1) * rgs < r1; r += UNROLL * rgs) {
    float v[UNROLL][V], w[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      load_vec<T>(x + base + (long long)(r + u * rgs) * C, v[u]);
      if (RES) load_vec<T>(res + base + (long long)(r + u * rgs) * C, w[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float y = silu(fmaf(v[u][i], a[i], c[i]));
        v[u][i] = RES ? y + w[u][i] : y;
      }
      store_vec<T>(out + base + (long long)(r + u * rgs) * C, v[u]);
    }
  }
  for (; r < r1; r += rgs) {
    float v[V], w[V];
    load_vec<T>(x + base + (long long)r * C, v);
    if (RES) load_vec<T>(res + base + (long long)r * C, w);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float y = silu(fmaf(v[i], a[i], c[i]));
      v[i] = RES ? y + w[i] : y;
    }
    store_vec<T>(out + base + (long long)r * C, v);
  }
}

template <typename T>
bool shape_ok(int B, int R, int C) {
  constexpr int V = Vec<T>::N;
  return B >= 1 && B <= 65535 && R >= 1 && C % V == 0 && C / V <= THREADS;
}

template <typename T>
int stats(const void* x, const float* gamma, const float* beta, const float* ms,
          const float* mt, float* table, float* partial, unsigned* tickets, int B, int R,
          int C, int G, int nblk, int ldm, float eps, cudaStream_t s) {
  if (!shape_ok<T>(B, R, C) || G < 1 || C % G || nblk < 1 ||
      (ms != nullptr && (mt == nullptr || ldm < C)) || gamma == nullptr || beta == nullptr)
    return (int)cudaErrorInvalidValue;
  // the last block's scratch: S * 2G slice sums and 2G statistics
  const int G2 = 2 * G, S = G2 < THREADS ? THREADS / G2 : 1;
  if (S * G2 + G2 > 2 * THREADS * Vec<T>::N) return (int)cudaErrorInvalidValue;
  if (!fd::aligned16(x, table)) return (int)cudaErrorMisalignedAddress;
  gn_stats_kernel<T><<<dim3(nblk, B), THREADS, 0, s>>>(static_cast<const T*>(x), gamma, beta,
                                                       ms, mt, table, partial, tickets, R, C,
                                                       G, ldm, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int apply(const void* x, const float* table, const void* res, void* out, int B, int R, int C,
          int has_res, cudaStream_t s) {
  if (!shape_ok<T>(B, R, C)) return (int)cudaErrorInvalidValue;
  if (!fd::aligned16(x, table, res, out)) return (int)cudaErrorMisalignedAddress;
  constexpr int V = Vec<T>::N;
  // rows per block: about APPLY_TILE_BYTES of x, whole unrolled row groups
  const int rgs = THREADS / (C / V), step = rgs * UNROLL;
  const long long want = APPLY_TILE_BYTES / ((long long)C * sizeof(T));
  const int rows = (int)((want + step - 1) / step) * step;
  const dim3 grid((R + rows - 1) / rows, B);
  const T* xt = static_cast<const T*>(x);
  if (has_res)
    gn_apply_kernel<T, true><<<grid, THREADS, 0, s>>>(xt, table, static_cast<const T*>(res),
                                                      static_cast<T*>(out), R, C, rows);
  else
    gn_apply_kernel<T, false><<<grid, THREADS, 0, s>>>(xt, table, nullptr,
                                                       static_cast<T*>(out), R, C, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int silu_forward(const void* x, const float* gamma, const float* beta, const float* ms,
                 const float* mt, const void* res, void* out, float* table, float* partial,
                 unsigned* tickets, int B, int R, int C, int G, int nblk, int ldm, int has_res,
                 float eps, cudaStream_t s) {
  // both launches checked before the first: a refused call launches nothing
  if (!shape_ok<T>(B, R, C)) return (int)cudaErrorInvalidValue;
  if (!fd::aligned16(x, table, res, out)) return (int)cudaErrorMisalignedAddress;
  const int rc = stats<T>(x, gamma, beta, ms, mt, table, partial, tickets, B, R, C, G, nblk,
                          ldm, eps, s);
  return rc != 0 ? rc : apply<T>(x, table, res, out, B, R, C, has_res, s);
}

}  // namespace

// x [B, R, C] (fp32 or bf16); gamma, beta [C] fp32; ms, mt rows of stride
// ldm (null: no modulation); table [B, 2, C] fp32 out; partial B * nblk * 2G
// fp32 and tickets [B] (zero on entry, zero on return) of scratch
extern "C" int gn_stats_forward(const void* x, const float* gamma, const float* beta,
                                const float* ms, const float* mt, float* table, float* partial,
                                unsigned* tickets, int B, int R, int C, int G, int nblk, int ldm,
                                float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stats<float>(x, gamma, beta, ms, mt, table, partial, tickets, B, R, C, G, nblk, ldm,
                        eps, s);
  if (dtype == 1)
    return stats<__nv_bfloat16>(x, gamma, beta, ms, mt, table, partial, tickets, B, R, C, G,
                                nblk, ldm, eps, s);
  return (int)cudaErrorInvalidValue;
}

// y [B, R, C] = silu(x * table[b, 0] + table[b, 1]) (+ res)
extern "C" int gn_apply_forward(const void* x, const float* table, const void* res, void* out,
                                int B, int R, int C, int has_res, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return apply<float>(x, table, res, out, B, R, C, has_res, s);
  if (dtype == 1) return apply<__nv_bfloat16>(x, table, res, out, B, R, C, has_res, s);
  return (int)cudaErrorInvalidValue;
}

// the epilogue: gn_stats_forward into table, then gn_apply_forward
extern "C" int gn_silu_forward(const void* x, const float* gamma, const float* beta,
                               const float* ms, const float* mt, const void* res, void* out,
                               float* table, float* partial, unsigned* tickets, int B, int R,
                               int C, int G, int nblk, int ldm, int has_res, float eps,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return silu_forward<float>(x, gamma, beta, ms, mt, res, out, table, partial, tickets, B, R,
                               C, G, nblk, ldm, has_res, eps, s);
  if (dtype == 1)
    return silu_forward<__nv_bfloat16>(x, gamma, beta, ms, mt, res, out, table, partial,
                                       tickets, B, R, C, G, nblk, ldm, has_res, eps, s);
  return (int)cudaErrorInvalidValue;
}
