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
// sequence: hundreds of flops per byte, and one exponential per pair.
//
// The forward (fwd_kernel) runs both products on the tensor cores with
// mma.sync, in the FlashAttention-2 shape: a warp owns 16 query rows, S =
// Q K^T of a 64-key tile stays in its accumulator registers, the row max
// and row sum are taken across each quad by shuffles, and the accumulator
// fragment of P is the A operand of P V, so S and P never touch shared
// memory.  K and V tiles are staged at the io dtype by cp.async in two
// buffers, the next tile's copy in flight during this tile's products, and
// shared by the block's WQ warps of query rows.  Each operand keeps the
// plain version's precision: q * scale is formed in fp32 (as
// attention_pallas.py:61) and p in fp32, then
//   bf16: q * scale and p each split into bf16 hi + lo (k and v are exact
//         in bf16), two bf16 MMAs a product (m16n8k16);
//   fp32: every operand split into a TF32 hi (its leading bits, one mask)
//         and lo = v - hi, three TF32 MMAs a product (m16n8k8: lo*hi +
//         hi*lo + hi*hi), as fd::warp_mma sums them.
// exp2 with log2 e folded into one FMA per pair replaces expf.  To fill the
// 132 SMs at bs1 (G = 4: 1,024 warps of 16 rows) a block also splits the
// keys into KS interleaved parts, one per group of WQ warps; the parts'
// (m, l, o) are combined in shared memory in a fixed order at the end, so
// there are no atomics and every run gives the same bits.  Ragged Lq and
// Lk are cut inside the kernel: rows past Lq are not stored, keys past Lk
// get weight exp2(-inf) = 0 exactly.  lse is [G, Lq] fp32, natural log
// (the TPU keeps 8 sublane copies per q block).
//
// The backward kernels (dq_kernel, dkv_kernel) are the first version,
// unchanged: each row of the side a kernel writes (a query row for dq, a
// key row for dkv) is owned by D / 16 neighbouring threads of a warp, each
// holding 16 of the row's d values and their fp32 accumulators in
// registers; a dot product is summed over the 16 values by each thread and
// then over the row's threads by shuffles.  A block of 64 rows walks the
// other side in tiles of 64 rows staged in shared memory as fp32, all
// threads reading the same staged row at once (a broadcast); bf16 inputs
// are widened at the load and every product runs on the fp32 CUDA cores.
// A block loops over all tiles of the other side itself, so dk/dv (summed
// over q on the TPU's sequential grid axis) and dq need no atomics.
#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int ROWS = 64;    // rows owned by a block
constexpr int TILE = 64;    // rows of the other side staged per step
constexpr int D = 32;       // head dim: the vanilla UNet's Attention runs 4 heads of 32
constexpr int DT = 16;      // d values per thread: a row spans D / DT threads
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
// forward on the tensor cores: a warp per 16 query rows (see the header)
// ---------------------------------------------------------------------------
constexpr int WQ = 4;          // warps of query rows in a block: 64 rows
constexpr int KT = 64;         // keys of a staged tile
constexpr float LOG2E = 1.4426950408889634f;

// Row length of a staged K or V tile in shared memory (elements): bf16 rows
// of 80 bytes keep ldmatrix free of bank conflicts; fp32 rows of 36 words
// keep the scalar fragment loads of K (key 8j + g, d t) and of V (key 2t,
// d g) free of them.
template <typename T> struct Lds;
template <> struct Lds<float> { static constexpr int N = D + 4; };
template <> struct Lds<__nv_bfloat16> { static constexpr int N = D + 8; };

// The dynamic shared memory of fwd_kernel: two stages of KS (K, V) tiles,
// reused at the end for the parts' (m, l, o) exchange.
template <typename T, int KS>
constexpr size_t fwd_smem() {
  constexpr size_t tiles = 2ull * KS * 2 * KT * Lds<T>::N * sizeof(T);
  constexpr size_t swap = (size_t)(KS - 1) * WQ * 20 * 32 * sizeof(float);
  return tiles > swap ? tiles : swap;
}

// fp32 operand of a 3xTF32 product in two instructions: hi = v cut to a
// TF32 (its 10 leading mantissa bits), lo = v - hi (exact), of which the
// tensor cores take a TF32's worth: each part within 2^-10 of its value,
// about 2^-20 of the product in all.
__device__ __forceinline__ void split_x3(float v, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// two fp32 values as packed bf16 hi and lo parts (x in the low half)
__device__ __forceinline__ void split_bf16x2(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Q (scaled in fp32) as the A operand of S = Q K^T, hi and lo parts: bf16
// m16n8k16 fragments for d 16 ks .. 16 ks + 15 (2 steps); fp32 m16n8k8
// fragments for d 8 ks .. 8 ks + 7 (4 steps).  Rows past Lq are zeros.
template <typename T> struct QFrag;
template <> struct QFrag<__nv_bfloat16> {
  unsigned h[2][4], l[2][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* q, long long r0, int Lq, int row,
                                       float scale, int g, int t) {
    auto at = [&](int r, int d) {
      return row + r < Lq ? __bfloat162float(q[(r0 + r) * D + d]) * scale : 0.f;
    };
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i & 1), d = 16 * ks + 2 * t + 8 * (i >> 1);
        split_bf16x2(at(r, d), at(r, d + 1), h[ks][i], l[ks][i]);
      }
  }
};
template <> struct QFrag<float> {
  unsigned h[4][4], l[4][4];
  __device__ __forceinline__ void load(const float* q, long long r0, int Lq, int row,
                                       float scale, int g, int t) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i & 1), d = 8 * ks + t + 4 * (i >> 1);
        const float v = row + r < Lq ? q[(r0 + r) * D + d] * scale : 0.f;
        split_x3(v, h[ks][i], l[ks][i]);
      }
  }
};

// s[j] (keys 8j .. 8j + 7 of the tile) += Q K^T over d
__device__ __forceinline__ void qk_tile(float (&s)[KT / 8][4], const QFrag<__nv_bfloat16>& q,
                                        const __nv_bfloat16* Ks, int lane) {
  constexpr int L = Lds<__nv_bfloat16>::N;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int jj = 0; jj < KT / 16; ++jj) {
      unsigned b[4];  // n-tiles 2 jj and 2 jj + 1: b0, b1 each
      fd::ldmatrix_x4(b, Ks + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * L + 16 * ks +
                             ((lane >> 3) & 1) * 8);
      fd::mma_bf16(s[2 * jj], q.l[ks], b[0], b[1]);
      fd::mma_bf16(s[2 * jj], q.h[ks], b[0], b[1]);
      fd::mma_bf16(s[2 * jj + 1], q.l[ks], b[2], b[3]);
      fd::mma_bf16(s[2 * jj + 1], q.h[ks], b[2], b[3]);
    }
}
__device__ __forceinline__ void qk_tile(float (&s)[KT / 8][4], const QFrag<float>& q,
                                        const float* Ks, int lane) {
  constexpr int L = Lds<float>::N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const float* k = Ks + (8 * j + g) * L + 8 * ks + t;
      unsigned bh[2], bl[2];
      split_x3(k[0], bh[0], bl[0]);
      split_x3(k[4], bh[1], bl[1]);
      fd::mma_tf32(s[j], q.l[ks], bh[0], bh[1]);
      fd::mma_tf32(s[j], q.h[ks], bl[0], bl[1]);
      fd::mma_tf32(s[j], q.h[ks], bh[0], bh[1]);
    }
}

// o[jd] (d 8 jd .. 8 jd + 7) += P V over the tile's keys, P in the
// accumulator layout of qk_tile.  bf16: the A fragment of keys 16 kk ..
// 16 kk + 15 is n-tiles 2 kk and 2 kk + 1 of P as they lie.  fp32: the
// k-step of n-tile j takes key 8 j + 2 t as its column t and 8 j + 2 t + 1
// as column t + 4 (the order of the sum over keys is free), so P's
// fragment is used as it lies and V's rows are read in that order.
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const float (&p)[KT / 8][4],
                                        const __nv_bfloat16* Vs, int lane) {
  constexpr int L = Lds<__nv_bfloat16>::N;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    unsigned ah[4], al[4];
    split_bf16x2(p[2 * kk][0], p[2 * kk][1], ah[0], al[0]);
    split_bf16x2(p[2 * kk][2], p[2 * kk][3], ah[1], al[1]);
    split_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1], ah[2], al[2]);
    split_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) {
      unsigned b[4];
      fd::ldmatrix_x4_trans(b, Vs + (16 * kk + (lane & 15)) * L + 16 * jd + (lane >> 4) * 8);
      fd::mma_bf16(o[2 * jd], al, b[0], b[1]);
      fd::mma_bf16(o[2 * jd], ah, b[0], b[1]);
      fd::mma_bf16(o[2 * jd + 1], al, b[2], b[3]);
      fd::mma_bf16(o[2 * jd + 1], ah, b[2], b[3]);
    }
  }
}
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const float (&p)[KT / 8][4],
                                        const float* Vs, int lane) {
  constexpr int L = Lds<float>::N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    unsigned ah[4], al[4];
    split_x3(p[j][0], ah[0], al[0]);  // (g, key 2t)
    split_x3(p[j][2], ah[1], al[1]);  // (g + 8, key 2t)
    split_x3(p[j][1], ah[2], al[2]);  // (g, key 2t + 1)
    split_x3(p[j][3], ah[3], al[3]);  // (g + 8, key 2t + 1)
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const float* v = Vs + (8 * j + 2 * t) * L + 8 * jd + g;
      unsigned bh[2], bl[2];
      split_x3(v[0], bh[0], bl[0]);
      split_x3(v[L], bh[1], bl[1]);
      fd::mma_tf32(o[jd], al, bh[0], bh[1]);
      fd::mma_tf32(o[jd], ah, bl[0], bl[1]);
      fd::mma_tf32(o[jd], ah, bh[0], bh[1]);
    }
  }
}

// grid (ceil(Lq / 64), G), 32 * WQ * KS threads: warp w takes query rows
// 16 (w % WQ) of the block's 64 and key tiles w / WQ, w / WQ + KS, ...
template <typename T, int KS>
__global__ void __launch_bounds__(32 * WQ * KS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int Lq, int Lk, float scale) {
  constexpr int L = Lds<T>::N;
  constexpr int TILE_ELEMS = KT * L;
  constexpr int NT = 32 * WQ * KS;
  constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);  // [2 stages][KS parts][K, V][KT][L]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = warp % WQ, part = warp / WQ;
  const int g = lane >> 2, t = lane & 3;
  const int gs = blockIdx.y;
  const int row = blockIdx.x * 16 * WQ + 16 * wq;  // the warp's first query row
  const long long r0 = (long long)gs * Lq + row;
  const T* kg = k + (long long)gs * Lk * D;
  const T* vg = v + (long long)gs * Lk * D;

  // every part's K and V tiles of iteration it into stage st, zeros past Lk
  auto stage = [&](int st, int it) {
    for (int c = tid; c < KS * 2 * KT * CPR; c += NT) {
      const int p = c / (2 * KT * CPR), rem = c % (2 * KT * CPR);
      const int which = rem / (KT * CPR), r = (rem % (KT * CPR)) / CPR, ch = rem % CPR;
      const int key = (it * KS + p) * KT + r;
      const T* src = (which ? vg : kg) + (long long)key * D + ch * (16 / (int)sizeof(T));
      T* dst = tiles + ((st * KS + p) * 2 + which) * TILE_ELEMS + r * L +
               ch * (16 / (int)sizeof(T));
      const bool ok = key < Lk;
      fd::cp_async16(dst, ok ? src : kg, ok ? 16 : 0);
    }
  };

  QFrag<T> qf;
  qf.load(q, r0, Lq, row, scale, g, t);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8

  const int iters = ((Lk + KT - 1) / KT + KS - 1) / KS;
  stage(0, 0);
  fd::cp_async_commit();
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) stage((it + 1) & 1, it + 1);
    fd::cp_async_commit();
    fd::cp_async_wait<1>();
    __syncthreads();  // iteration it's tiles have landed
    const int k0 = (it * KS + part) * KT;
    if (k0 < Lk) {  // warp-uniform: a part past the last key tile idles
      const T* Ks = tiles + (((it & 1) * KS + part) * 2) * TILE_ELEMS;
      float s[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      qk_tile(s, qf, Ks, lane);
      if (k0 + KT > Lk) {  // keys past Lk: weight exactly 0
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t + (e & 1) >= Lk) s[j][e] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float ml[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        ml[h] = mx[h] == -INFINITY ? 0.f : mx[h] * LOG2E;
        alpha[h] = exp2f(m[h] * LOG2E - ml[h]);  // 0 while m is -inf
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(fmaf(s[j][e], LOG2E, -ml[e >> 1]));
          l[e >> 1] += s[j][e];
        }
      pv_tile(acc, s, Ks + TILE_ELEMS, lane);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  fd::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  if constexpr (KS > 1) {  // the parts' (m, l, o), combined in part order
    float* swap = reinterpret_cast<float*>(smem_raw);  // [KS - 1][WQ][20][32]
    auto slot = [&](int p, int i) { return swap + (((p - 1) * WQ + wq) * 20 + i) * 32 + lane; };
    if (part > 0) {
      *slot(part, 0) = m[0];
      *slot(part, 1) = m[1];
      *slot(part, 2) = l[0];
      *slot(part, 3) = l[1];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) *slot(part, 4 + 4 * j + e) = acc[j][e];
    }
    __syncthreads();
    if (part > 0) return;
    float mt[2] = {m[0], m[1]};
    for (int p = 1; p < KS; ++p) {
      mt[0] = fmaxf(mt[0], *slot(p, 0));
      mt[1] = fmaxf(mt[1], *slot(p, 1));
    }
    float w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float base = mt[h] == -INFINITY ? 0.f : mt[h] * LOG2E;
      w[h] = exp2f(m[h] * LOG2E - base);
      l[h] *= w[h];
      m[h] = base;  // from here m holds the total max in log2 units
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= w[e >> 1];
    for (int p = 1; p < KS; ++p) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        w[h] = exp2f(*slot(p, h) * LOG2E - m[h]);
        l[h] += *slot(p, 2 + h) * w[h];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += *slot(p, 4 + 4 * j + e) * w[e >> 1];
    }
    m[0] = mt[0];
    m[1] = mt[1];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + g + 8 * h;
    if (r >= Lq) continue;
    const float lc = fmaxf(l[h], 1e-30f);
    T* orow = o + (r0 + g + 8 * h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x = acc[j][2 * h] / lc, y = acc[j][2 * h + 1] / lc;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(x, y);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(x, y);
      }
    }
    if (t == 0) lse[r0 + g + 8 * h] = m[h] + logf(lc);
  }
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

template <typename T, int KS>
int fwd_parts(const void* q, const void* k, const void* v, void* o, float* lse, int G, int Lq,
              int Lk, float scale, cudaStream_t s) {
  const dim3 grid((unsigned)((Lq + 16 * WQ - 1) / (16 * WQ)), (unsigned)G);
  return (int)fd::launch(fwd_kernel<T, KS>, grid, 32 * WQ * KS, fwd_smem<T, KS>(), s,
                         static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<T*>(o), lse, Lq, Lk, scale);
}

// Key parts a block splits the keys into, from the warps of query rows
// (16 rows each) against the SMs.  At G 4 and 8, L 4,096 on the H100 fp32
// ran fastest in 4 parts (its split operands and three MMAs a product want
// more warps in flight), bf16 in one (PERF.md section 6).
int fwd_key_parts(bool fp32, int G, int Lq) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long warps = (long long)G * ((Lq + 16 * WQ - 1) / (16 * WQ)) * WQ;
  if (fp32) return warps <= 16LL * sms ? 4 : warps <= 32LL * sms ? 2 : 1;
  return warps >= 4LL * sms ? 1 : warps >= 2LL * sms ? 2 : 4;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int G, int Lq, int Lk,
        float scale, cudaStream_t s) {
  if (!fd::aligned16(q, k, v, o)) return (int)cudaErrorMisalignedAddress;
  switch (fwd_key_parts(std::is_same<T, float>::value, G, Lq)) {
    case 4: return fwd_parts<T, 4>(q, k, v, o, lse, G, Lq, Lk, scale, s);
    case 2: return fwd_parts<T, 2>(q, k, v, o, lse, G, Lq, Lk, scale, s);
    default: return fwd_parts<T, 1>(q, k, v, o, lse, G, Lq, Lk, scale, s);
  }
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
