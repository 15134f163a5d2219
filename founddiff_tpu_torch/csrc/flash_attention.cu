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
// forward and 14d backward flops (6d in dq, 8d in dk/dv) against 4 * d *
// (Lq + Lk) bytes per sequence: hundreds of flops per byte, and one
// exponential per pair in each kernel.
//
// All three kernels run every product on the tensor cores with mma.sync,
// in the FlashAttention-2 shape: a warp owns 16 rows of the side it writes
// (query rows in fwd_kernel and dq_kernel, key rows in dkv_kernel), holds
// them as A fragments loaded once, and walks the other side in tiles of 64
// rows staged at the io dtype by cp.async in two buffers (the next tile's
// copy in flight during this tile's products), shared by the block's WQ
// warps.  Each product of a tile stays in accumulator registers, and an
// accumulator fragment is the A operand of the next product as it lies, so
// no score ever touches shared memory:
//   fwd_kernel  S = Q K^T, the row max and sum across each quad by
//               shuffles, O += P V;
//   dq_kernel   S = Q K^T, dP = dO V^T, P = exp2(S scale log2e - lse log2e)
//               (one FMA a pair), dS = P (dP - D), dQ += dS K;
//   dkv_kernel  S^T = K Q^T, dP^T = V dO^T, the same P^T and dS^T with lse_i
//               and D_i read by the accumulator's column (the query) from
//               shared memory, staged with the tile, dV += P^T dO and
//               dK += dS^T Q.
// The backward holds a 64-row tile in two steps of 32 (SUB) so that S and
// dP of a step and both kernels' fp32 operands fit in registers.  Each
// operand keeps the plain version's precision:
//   bf16: q, k, v and do are exact in bf16, so the backward's S and dP are
//         one bf16 MMA a step (m16n8k16); the forward's q * scale (formed
//         in fp32 as attention_pallas.py:61) and every P or dS (formed in
//         fp32) split into bf16 hi + lo, two MMAs a step;
//   fp32: every operand split into a TF32 hi (its leading bits, one mask)
//         and lo = v - hi, three TF32 MMAs a step (m16n8k8: lo*hi + hi*lo +
//         hi*hi), as fd::warp_mma sums them.  The backward's S and dP round
//         hi to nearest and sum the cross terms apart (RowFrag), and its
//         gradient products sum each 32-row step from zero (pv_step): dP -
//         D and the sums over thousands of rows hold the fp32 tolerance.
// exp2 with log2 e folded into one FMA per pair replaces expf.  To fill the
// 132 SMs where the rows alone do not (G = 4 at bs1: 1,024 warps of 16
// rows) a block also splits the other side into KS interleaved parts, one
// per group of WQ warps (fwd_kernel and dq_kernel the keys, dkv_kernel the
// queries); the parts' sums ((m, l, o) forward, dQ or dK and dV backward)
// are combined in shared memory in part order at the end, so there are no
// atomics and every run gives the same bits.  Ragged Lq and Lk are cut
// inside the kernels: rows past the end are not stored, keys past Lk (and,
// in dkv_kernel, queries past Lq) get weight exactly 0.  lse is [G, Lq]
// fp32, natural log (the TPU keeps 8 sublane copies per q block).
#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int D = 32;          // head dim: the vanilla UNet's Attention runs 4 heads of 32
constexpr int WQ = 4;          // warps of 16 rows in a block: 64 rows
constexpr int KT = 64;         // rows of the other side in a staged tile
constexpr int SUB = 32;        // of which the backward holds in registers at once
constexpr float LOG2E = 1.4426950408889634f;

// Row length of a staged tile in shared memory (elements): bf16 rows of 80
// bytes keep ldmatrix free of bank conflicts; fp32 rows of 36 words keep
// the scalar fragment loads of a B operand read by row (row 8j + g, d t)
// and of one read by column (row 2t, d g) free of them.
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

// The dynamic shared memory of a backward kernel: two stages of KS tile
// pairs, with ROWS fp32 values of each staged row beside them (dkv_kernel's
// lse and D), reused at the end for the parts' N accumulators (D / 2
// floats a thread each).
template <typename T, int KS, int ROWS, int N>
constexpr size_t bwd_smem() {
  constexpr size_t tiles = 2ull * KS * (2 * KT * Lds<T>::N * sizeof(T) + ROWS * KT * 4);
  constexpr size_t swap = (size_t)(KS - 1) * WQ * N * (D / 2) * 32 * sizeof(float);
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

// The same split with hi rounded to the nearest TF32 (ties away from zero,
// on the bits), so that |lo| is half as large and the tensor cores' cut of
// lo costs half as much: the backward's exact operands take it.
__device__ __forceinline__ void split_rn(float v, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
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

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// a += b, fragment by fragment
template <int N>
__device__ __forceinline__ void add(float (&a)[N][4], const float (&b)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] += b[j][e];
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(gmem),
               "r"(bytes));
}

// The A operand of S = A B^T over d, a warp's 16 rows, as fragments: bf16
// m16n8k16 fragments for d 16 ks .. 16 ks + 15 (2 steps); fp32 m16n8k8
// fragments for d 8 ks .. 8 ks + 7 (4 steps).  qk_tile takes a step's
// fragments through mma (bf16) or split (fp32); in fp32 the fragment type
// also picks how qk_tile splits B (split_b) and whether it sums the two
// cross terms (lo x hi) apart from hi x hi (APART).
//
// QFrag: the forward's Q, scaled in fp32 and so held as hi and lo parts.
// Rows past Lq are zeros.
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
  __device__ __forceinline__ void mma(float (&c)[4], int ks, unsigned b0, unsigned b1) const {
    fd::mma_bf16(c, l[ks], b0, b1);
    fd::mma_bf16(c, h[ks], b0, b1);
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
  __device__ __forceinline__ void split(int ks, unsigned (&ah)[4], unsigned (&al)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[i] = h[ks][i];
      al[i] = l[ks][i];
    }
  }
  static constexpr bool APART = false;
  __device__ static __forceinline__ void split_b(float v, unsigned& hi, unsigned& lo) {
    split_x3(v, hi, lo);
  }
};

// RowFrag: an operand exact at the io dtype (the backward's q, do, k, v,
// unscaled), its warp's 16 rows from p: bf16 pairs as they lie (one MMA a
// step, no lo part), fp32 values split at each step (so that the split
// parts of both of a kernel's operands need not stay in registers).  In
// fp32 both operands split with hi rounded to nearest, and qk_tile sums
// the cross terms apart from hi x hi.  dP - D cancels to rounding noise
// where a row has few keys (dS is 0 at Lk = 1), and the tensor cores cut
// each sum toward zero at the running total's scale; with both measures dP
// keeps about fp32's accuracy, which dK and dQ need there.  Rows at or
// past n are zeros.
template <typename T> struct RowFrag;
template <> struct RowFrag<__nv_bfloat16> {
  unsigned a[2][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int n, int g, int t) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i & 1), d = 16 * ks + 2 * t + 8 * (i >> 1);
        a[ks][i] = r < n ? *reinterpret_cast<const unsigned*>(p + r * D + d) : 0u;
      }
  }
  __device__ __forceinline__ void mma(float (&c)[4], int ks, unsigned b0, unsigned b1) const {
    fd::mma_bf16(c, a[ks], b0, b1);
  }
};
template <> struct RowFrag<float> {
  float a[4][4];
  __device__ __forceinline__ void load(const float* p, int n, int g, int t) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i & 1), d = 8 * ks + t + 4 * (i >> 1);
        a[ks][i] = r < n ? p[r * D + d] : 0.f;
      }
  }
  __device__ __forceinline__ void split(int ks, unsigned (&ah)[4], unsigned (&al)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_rn(a[ks][i], ah[i], al[i]);
  }
  static constexpr bool APART = true;
  __device__ static __forceinline__ void split_b(float v, unsigned& hi, unsigned& lo) {
    split_rn(v, hi, lo);
  }
};

// s[j] (columns 8j .. 8j + 7: rows of the staged tile at Bs) += A B^T over d
template <int NJ, class F>
__device__ __forceinline__ void qk_tile(float (&s)[NJ][4], const F& a, const __nv_bfloat16* Bs,
                                        int lane) {
  constexpr int L = Lds<__nv_bfloat16>::N;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      unsigned b[4];  // n-tiles 2 jj and 2 jj + 1: b0, b1 each
      fd::ldmatrix_x4(b, Bs + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * L + 16 * ks +
                             ((lane >> 3) & 1) * 8);
      a.mma(s[2 * jj], ks, b[0], b[1]);
      a.mma(s[2 * jj + 1], ks, b[2], b[3]);
    }
}
template <int NJ, class F>
__device__ __forceinline__ void qk_tile(float (&s)[NJ][4], const F& a, const float* Bs,
                                        int lane) {
  constexpr int L = Lds<float>::N;
  const int g = lane >> 2, t = lane & 3;
  float c[NJ][4];  // the cross terms, where F sums them apart
  if constexpr (F::APART) zero(c);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    unsigned ah[4], al[4];
    a.split(ks, ah, al);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* k = Bs + (8 * j + g) * L + 8 * ks + t;
      unsigned bh[2], bl[2];
      F::split_b(k[0], bh[0], bl[0]);
      F::split_b(k[4], bh[1], bl[1]);
      if constexpr (F::APART) {
        fd::mma_tf32(c[j], al, bh[0], bh[1]);
        fd::mma_tf32(c[j], ah, bl[0], bl[1]);
      } else {
        fd::mma_tf32(s[j], al, bh[0], bh[1]);
        fd::mma_tf32(s[j], ah, bl[0], bl[1]);
      }
      fd::mma_tf32(s[j], ah, bh[0], bh[1]);
    }
  }
  if constexpr (F::APART) add(s, c);
}

// o[jd] (d 8 jd .. 8 jd + 7) += P V over the NJ n-tiles' rows of the
// staged tile at Vs, P in the accumulator layout of qk_tile.  bf16: the A
// fragment of rows 16 kk .. 16 kk + 15 is n-tiles 2 kk and 2 kk + 1 of P as
// they lie.  fp32: the k-step of n-tile j takes row 8 j + 2 t as its column
// t and 8 j + 2 t + 1 as column t + 4 (the order of the sum is free), so
// P's fragment is used as it lies and V's rows are read in that order.
template <int NJ>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const float (&p)[NJ][4],
                                        const __nv_bfloat16* Vs, int lane) {
  constexpr int L = Lds<__nv_bfloat16>::N;
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
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
template <int NJ>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const float (&p)[NJ][4],
                                        const float* Vs, int lane) {
  constexpr int L = Lds<float>::N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    unsigned ah[4], al[4];
    split_x3(p[j][0], ah[0], al[0]);  // (g, row 2t)
    split_x3(p[j][2], ah[1], al[1]);  // (g + 8, row 2t)
    split_x3(p[j][1], ah[2], al[2]);  // (g, row 2t + 1)
    split_x3(p[j][3], ah[3], al[3]);  // (g + 8, row 2t + 1)
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

// o += P V as pv_tile; in fp32 summed from zero first: the tensor cores
// cut each sum toward zero at the running total's scale, so the backward's
// chains over thousands of rows would drift past the fp32 tolerance, and
// their steps' totals add in fp32 instead (bf16 rounds far above that).
template <int NJ, typename T>
__device__ __forceinline__ void pv_step(float (&o)[D / 8][4], const float (&p)[NJ][4],
                                        const T* Vs, int lane) {
  if constexpr (std::is_same<T, float>::value) {
    float t[D / 8][4];
    zero(t);
    pv_tile(t, p, Vs, lane);
    add(o, t);
  } else {
    pv_tile(o, p, Vs, lane);
  }
}

// Tile it of every part (rows (it KS + p) KT .. + KT of a and of b, each
// [n, D] at the io dtype) into stage st of tiles [2][KS][a, b][KT][L] by
// cp.async, rows at or past n as zeros.
template <typename T, int KS, int NT>
__device__ __forceinline__ void stage_tiles(T* tiles, int st, int it, const T* a, const T* b,
                                            int n, int tid) {
  constexpr int L = Lds<T>::N;
  constexpr int TILE_ELEMS = KT * L;
  constexpr int VN = 16 / (int)sizeof(T);
  constexpr int CPR = D / VN;  // 16-byte chunks of a row
  for (int c = tid; c < KS * 2 * KT * CPR; c += NT) {
    const int p = c / (2 * KT * CPR), rem = c % (2 * KT * CPR);
    const int which = rem / (KT * CPR), r = (rem % (KT * CPR)) / CPR, ch = rem % CPR;
    const int row = (it * KS + p) * KT + r;
    const T* src = (which ? b : a) + (long long)row * D + ch * VN;
    T* dst = tiles + ((st * KS + p) * 2 + which) * TILE_ELEMS + r * L + ch * VN;
    const bool ok = row < n;
    fd::cp_async16(dst, ok ? src : a, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// forward on the tensor cores: a warp per 16 query rows (see the header)
// ---------------------------------------------------------------------------

// grid (ceil(Lq / 64), G), 32 * WQ * KS threads: warp w takes query rows
// 16 (w % WQ) of the block's 64 and key tiles w / WQ, w / WQ + KS, ...
template <typename T, int KS>
__global__ void __launch_bounds__(32 * WQ * KS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int Lq, int Lk, float scale) {
  constexpr int L = Lds<T>::N;
  constexpr int TILE_ELEMS = KT * L;
  constexpr int NT = 32 * WQ * KS;
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

  QFrag<T> qf;
  qf.load(q, r0, Lq, row, scale, g, t);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8

  const int iters = ((Lk + KT - 1) / KT + KS - 1) / KS;
  stage_tiles<T, KS, NT>(tiles, 0, 0, kg, vg, Lk, tid);
  fd::cp_async_commit();
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) stage_tiles<T, KS, NT>(tiles, (it + 1) & 1, it + 1, kg, vg, Lk, tid);
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
// backward on the tensor cores: a warp per 16 query rows (dq) or 16 key
// rows (dk, dv), the other side in staged tiles (see the header)
// ---------------------------------------------------------------------------

// The parts' accumulators (N sets of D / 8 fragments a thread) summed in
// part order into part 0's, through shared memory; the other parts return
// false.  Called by every thread of the block once its tiles are done.
template <int KS, int N>
__device__ __forceinline__ bool sum_parts(float (&acc)[N][D / 8][4], unsigned char* smem,
                                          int part, int wq, int lane) {
  if constexpr (KS > 1) {
    constexpr int NV = N * D / 2;  // floats a thread
    float* swap = reinterpret_cast<float*>(smem);  // [KS - 1][WQ][NV][32]
    auto slot = [&](int p, int i) { return swap + (((p - 1) * WQ + wq) * NV + i) * 32 + lane; };
    if (part > 0) {
#pragma unroll
      for (int a = 0; a < N; ++a)
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) *slot(part, (a * D / 8 + j) * 4 + e) = acc[a][j][e];
    }
    __syncthreads();
    if (part > 0) return false;
    for (int p = 1; p < KS; ++p)
#pragma unroll
      for (int a = 0; a < N; ++a)
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][j][e] += *slot(p, (a * D / 8 + j) * 4 + e);
  }
  return true;
}

// rows g and g + 8 of a warp's accumulator times mul into out (the warp's
// first row), rows at or past n not stored
template <typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 8][4], float mul,
                                           int n, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (g + 8 * h >= n) continue;
    T* orow = out + (g + 8 * h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x = acc[j][2 * h] * mul, y = acc[j][2 * h + 1] * mul;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(x, y);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(x, y);
      }
    }
  }
}


// grid (ceil(Lq / 64), G), 32 * WQ * KS threads: warp w takes query rows
// 16 (w % WQ) of the block's 64 and key tiles w / WQ, w / WQ + KS, ...
template <typename T, int KS>
__global__ void __launch_bounds__(32 * WQ * KS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dcap, T* __restrict__ dq, int Lq, int Lk, float scale) {
  constexpr int L = Lds<T>::N;
  constexpr int TILE_ELEMS = KT * L;
  constexpr int NT = 32 * WQ * KS;
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

  RowFrag<T> qf, df;
  qf.load(q + r0 * D, Lq - row, g, t);
  df.load(dout + r0 * D, Lq - row, g, t);
  float ml[2], dc[2];  // lse log2 e and D of rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row + g + 8 * h < Lq;
    ml[h] = in ? lse[r0 + g + 8 * h] * LOG2E : 0.f;
    dc[h] = in ? dcap[r0 + g + 8 * h] : 0.f;
  }
  const float sl = scale * LOG2E;
  float acc[1][D / 8][4];
  zero(acc[0]);

  const int iters = ((Lk + KT - 1) / KT + KS - 1) / KS;
  stage_tiles<T, KS, NT>(tiles, 0, 0, kg, vg, Lk, tid);
  fd::cp_async_commit();
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) stage_tiles<T, KS, NT>(tiles, (it + 1) & 1, it + 1, kg, vg, Lk, tid);
    fd::cp_async_commit();
    fd::cp_async_wait<1>();
    __syncthreads();  // iteration it's tiles have landed
    const int k0 = (it * KS + part) * KT;
    if (k0 < Lk && row < Lq) {  // warp-uniform
      const T* Ks = tiles + (((it & 1) * KS + part) * 2) * TILE_ELEMS;
      const T* Vs = Ks + TILE_ELEMS;
#pragma unroll
      for (int c0 = 0; c0 < KT; c0 += SUB) {
        if (k0 + c0 >= Lk) continue;  // warp-uniform: keys past Lk only
        float s[SUB / 8][4], dp[SUB / 8][4];
        zero(s);
        zero(dp);
        qk_tile(s, qf, Ks + c0 * L, lane);   // S = Q K^T
        qk_tile(dp, df, Vs + c0 * L, lane);  // dP = dO V^T
        const bool ragged = k0 + c0 + SUB > Lk;
#pragma unroll
        for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(s[j][e], sl, -ml[e >> 1]));
            if (ragged && k0 + c0 + 8 * j + 2 * t + (e & 1) >= Lk) p = 0.f;
            s[j][e] = p * (dp[j][e] - dc[e >> 1]);  // dS
          }
        pv_step(acc[0], s, Ks + c0 * L, lane);  // dQ += dS K
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  fd::cp_async_wait<0>();
  if (!sum_parts<KS>(acc, smem_raw, part, wq, lane)) return;
  store_rows<T>(dq + r0 * D, acc[0], scale, Lq - row, g, t);
}

// grid (ceil(Lk / 64), G), 32 * WQ * KS threads: warp w takes key rows
// 16 (w % WQ) of the block's 64 and query tiles w / WQ, w / WQ + KS, ...
template <typename T, int KS>
__global__ void __launch_bounds__(32 * WQ * KS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ dcap, T* __restrict__ dk, T* __restrict__ dv, int Lq,
           int Lk, float scale) {
  constexpr int L = Lds<T>::N;
  constexpr int TILE_ELEMS = KT * L;
  constexpr int NT = 32 * WQ * KS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);  // [2 stages][KS parts][Q, dO][KT][L]
  float* rows =  // [2 stages][KS parts][lse, D][KT]
      reinterpret_cast<float*>(smem_raw + 2ull * KS * 2 * TILE_ELEMS * sizeof(T));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = warp % WQ, part = warp / WQ;
  const int g = lane >> 2, t = lane & 3;
  const int gs = blockIdx.y;
  const int col = blockIdx.x * 16 * WQ + 16 * wq;  // the warp's first key row
  const long long c0g = (long long)gs * Lk + col;
  const T* qg = q + (long long)gs * Lq * D;
  const T* og = dout + (long long)gs * Lq * D;
  const float* lg = lse + (long long)gs * Lq;
  const float* dg = dcap + (long long)gs * Lq;

  // the Q and dO tiles of iteration it, and their queries' lse and D, into
  // stage st; zeros past Lq
  auto stage = [&](int st, int it) {
    stage_tiles<T, KS, NT>(tiles, st, it, qg, og, Lq, tid);
    for (int c = tid; c < KS * 2 * KT; c += NT) {
      const int p = c / (2 * KT), which = (c / KT) & 1, r = c % KT;
      const int qi = (it * KS + p) * KT + r;
      const bool ok = qi < Lq;
      cp_async4(rows + ((st * KS + p) * 2 + which) * KT + r, ok ? (which ? dg : lg) + qi : lg,
                ok ? 4 : 0);
    }
  };

  RowFrag<T> kf, vf;
  kf.load(k + c0g * D, Lk - col, g, t);
  vf.load(v + c0g * D, Lk - col, g, t);
  const float sl = scale * LOG2E;
  float acc[2][D / 8][4];  // dK, dV
  zero(acc[0]);
  zero(acc[1]);

  const int iters = ((Lq + KT - 1) / KT + KS - 1) / KS;
  stage(0, 0);
  fd::cp_async_commit();
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) stage((it + 1) & 1, it + 1);
    fd::cp_async_commit();
    fd::cp_async_wait<1>();
    __syncthreads();  // iteration it's tiles have landed
    const int q0 = (it * KS + part) * KT;
    if (q0 < Lq && col < Lk) {  // warp-uniform
      const T* Qs = tiles + (((it & 1) * KS + part) * 2) * TILE_ELEMS;
      const T* Os = Qs + TILE_ELEMS;
      const float* ls = rows + ((it & 1) * KS + part) * 2 * KT;
      const float* ds = ls + KT;
#pragma unroll
      for (int c0 = 0; c0 < KT; c0 += SUB) {
        if (q0 + c0 >= Lq) continue;  // warp-uniform: queries past Lq only
        float s[SUB / 8][4], dp[SUB / 8][4];
        zero(s);
        zero(dp);
        qk_tile(s, kf, Qs + c0 * L, lane);   // S^T = K Q^T
        qk_tile(dp, vf, Os + c0 * L, lane);  // dP^T = V dO^T
        const bool ragged = q0 + c0 + SUB > Lq;
#pragma unroll
        for (int j = 0; j < SUB / 8; ++j) {
          const int c = c0 + 8 * j + 2 * t;  // this thread's two queries: c, c + 1
          const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
          const float2 d2 = *reinterpret_cast<const float2*>(ds + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lq = (e & 1) ? l2.y : l2.x, dd = (e & 1) ? d2.y : d2.x;
            float p = exp2f(fmaf(s[j][e], sl, -lq * LOG2E));
            if (ragged && q0 + c + (e & 1) >= Lq) p = 0.f;
            s[j][e] = p;                       // P^T
            dp[j][e] = p * (dp[j][e] - dd);    // dS^T
          }
        }
        pv_step(acc[1], s, Os + c0 * L, lane);   // dV += P^T dO
        pv_step(acc[0], dp, Qs + c0 * L, lane);  // dK += dS^T Q
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  fd::cp_async_wait<0>();
  if (!sum_parts<KS>(acc, smem_raw, part, wq, lane)) return;
  store_rows<T>(dk + c0g * D, acc[0], scale, Lk - col, g, t);
  store_rows<T>(dv + c0g * D, acc[1], 1.f, Lk - col, g, t);
}

// The SMs of the current device, read once.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

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
  const int sms = sm_count();
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

template <typename T, int KS>
int dq_parts(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* dcap, void* dq, int G, int Lq, int Lk, float scale, cudaStream_t s) {
  const dim3 grid((unsigned)((Lq + 16 * WQ - 1) / (16 * WQ)), (unsigned)G);
  return (int)fd::launch(dq_kernel<T, KS>, grid, 32 * WQ * KS, bwd_smem<T, KS, 0, 1>(), s,
                         static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<const T*>(dout), lse, dcap,
                         static_cast<T*>(dq), Lq, Lk, scale);
}

template <typename T, int KS>
int dkv_parts(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* dcap, void* dk, void* dv, int G, int Lq, int Lk, float scale,
              cudaStream_t s) {
  const dim3 grid((unsigned)((Lk + 16 * WQ - 1) / (16 * WQ)), (unsigned)G);
  return (int)fd::launch(dkv_kernel<T, KS>, grid, 32 * WQ * KS, bwd_smem<T, KS, 2, 2>(), s,
                         static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<const T*>(dout), lse, dcap,
                         static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, scale);
}

// Parts a backward block splits the other side into (dq_kernel the keys,
// dkv_kernel the queries), from the warps of rows it writes (16 rows each,
// rows = Lq for dq, Lk for dk/dv) against the SMs.  Measured on the H100
// at B2 H4 (G 8) and B1 (G 4), L 4,096, and at B2 Lq 1,000 / Lk 777, both
// kernels with 1, 2 and 4 parts (PERF.md section 6): fp32 runs fastest in
// one part from 4 warps an SM up (its split operands take 198 and 246
// registers, so 4 parts spill) and in two below; bf16 in two parts from
// there up (one part within 1% for dq at G 8) and in four below.
int bwd_parts(bool fp32, int G, int rows) {
  const int sms = sm_count();
  const long long warps = (long long)G * ((rows + 16 * WQ - 1) / (16 * WQ)) * WQ;
  if (fp32) return warps >= 4LL * sms ? 1 : 2;
  return warps >= 4LL * sms ? 2 : 4;
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* dcap, void* dq, int G, int Lq, int Lk, float scale, cudaStream_t s) {
  if (!fd::aligned16(q, k, v, dout, dq)) return (int)cudaErrorMisalignedAddress;
  switch (bwd_parts(std::is_same<T, float>::value, G, Lq)) {
    case 4: return dq_parts<T, 4>(q, k, v, dout, lse, dcap, dq, G, Lq, Lk, scale, s);
    case 2: return dq_parts<T, 2>(q, k, v, dout, lse, dcap, dq, G, Lq, Lk, scale, s);
    default: return dq_parts<T, 1>(q, k, v, dout, lse, dcap, dq, G, Lq, Lk, scale, s);
  }
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* dcap, void* dk, void* dv, int G, int Lq, int Lk, float scale,
            cudaStream_t s) {
  if (!fd::aligned16(q, k, v, dout, dk, dv)) return (int)cudaErrorMisalignedAddress;
  switch (bwd_parts(std::is_same<T, float>::value, G, Lk)) {
    case 4: return dkv_parts<T, 4>(q, k, v, dout, lse, dcap, dk, dv, G, Lq, Lk, scale, s);
    case 2: return dkv_parts<T, 2>(q, k, v, dout, lse, dcap, dk, dv, G, Lq, Lk, scale, s);
    default: return dkv_parts<T, 1>(q, k, v, dout, lse, dcap, dk, dv, G, Lq, Lk, scale, s);
  }
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

// The parts a launch of flash_bwd_dq (rows Lq) or flash_bwd_dkv (rows Lk)
// splits the other side into, on the current device.
extern "C" int flash_bwd_parts(int G, int rows, int dtype) {
  return bwd_parts(dtype == 0, G, rows);
}
