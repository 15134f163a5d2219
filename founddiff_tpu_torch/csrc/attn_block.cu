// MambaBlock attention half: out = x + gate * TransposedAttention(modulate(LN(x))).
//
// Replaces the TPU kernel _attn_block_kernel (founddiff_tpu/ops/attn_block.py:104,
// launched by _attn_block_fwd_only :306 from attn_block :422).
//
// Function: x2 = io(LN(x) (1 + ms) + mt); u = io(x2 @ Wqkv); q, k, v =
// io(dwconv3x3(u)) (SAME zero padding, taps summed row by row); per head
// h of 32 channels and image b, attn = softmax(norm(q_h)^T norm(k_h) *
// temp_h) over the head's keys; M = io(fold of attn and project_out) [C,
// C]; out = io(x + io(gate * io(v @ M))).  Every rounding point is the TPU
// kernel's.
//
// Bound on the H100 (as chip_smoke.py counts it): operations.  Per pixel the
// qkv projection is 3C^2 and v @ M another C^2 multiply-adds (C = 128..512)
// against x read and out written once; bf16 runs them on the tensor cores,
// fp32 as three TF32 products (common.cuh), which hold the fp32 tolerance.
// The first port ran both products on the fp32 CUDA cores and passed x2, u
// and qkv through device memory (about 270 MB at 256^2 C128 bs1 against 34
// MB of x in and out), with a one-thread-per-value depthwise 3x3 that took
// as long as the qkv product (PERF.md section 5).
//
// Design, five launches on the caller's stream (fp32 takes the same form):
//   1. the LN statistics (mean, rstd) of every pixel (fd::ln_rows_vec);
//   2. qkv_kernel, one block per (8 x 16 pixel tile, 64-column slice of
//      Wqkv, image): builds x2 for the tile and its one-pixel halo (10 x 18
//      = 180 rows, padded to 192) chunk by chunk in shared memory from x,
//      the statistics and the modulation, runs the projection on the
//      tensor cores (x loads for the next chunk in flight during the
//      products), rounds u in shared memory and runs the 3x3 there.  A
//      slice is a head's 32 q columns and its 32 k columns, or 64 v
//      columns.  A q/k slice sums the head's partial q^T k block over its
//      tile's pixels on the tensor cores too (each warp 16 pixels, the
//      warps' sums added in order) with the q and k squared norms, and
//      writes only those (1,088 floats); a v slice writes v.  x2, u, q and
//      k never reach device memory.  The halo costs 192 / 128 = 1.5x the products of the
//      tile's own pixels (the TPU kernel recomputes its rows too), and each
//      of the 3C / 64 slices reads the tile of x again from L2;
//   3. gram_reduce_kernel sums the tiles' partials 16 at a time, in order;
//   4. fold_kernel, one block per (64 columns of M, head, image): adds the
//      groups in order, applies the norms, temperature and softmax, and
//      folds project_out into those 32 x 64 values of M (the fold spread
//      over C / 64 times more blocks than one per head);
//   5. out = x + gate * (v @ M) as a batched product on the tensor cores
//      (fd::gemm_mma) with the gate and the residual in its epilogue.
// Partial sums are added in a fixed order and no float atomics are used, so
// every run gives the same bits.  The TPU kernel's 128-lane channel padding
// and DMA ring are Mosaic constraints and are not ported.
#include "common.cuh"

namespace {

constexpr int HEAD = 32;               // channels per head (heads = C / 32)
constexpr int GRAM = HEAD * HEAD;      // one head's q^T k block
constexpr int PART = GRAM + 2 * HEAD;  // + q and k squared norms
constexpr int TH = 8, TW = 16;         // output pixels of a tile
constexpr int RW = TW + 2;             // halo row width
constexpr int ROWS = (TH + 2) * RW;    // halo pixels of a tile: 180
constexpr int MR = 192;                // ROWS padded to 12 m16 tiles
constexpr int SLICE = 64;              // output channels of a block
constexpr int KC = 32;                 // k of one staged chunk
constexpr int THREADS = 256;           // 8 warps: 4 x 48 rows, 2 x 32 columns
constexpr int RED = 16;                // tile partials summed by one reduce block
constexpr int QL = SLICE + 8;          // row length of the q/k conv output in shared memory

// Padded row lengths (elements) of the shared tiles, 16-byte aligned and
// free of bank conflicts for the fragment loads; bytes: the dynamic shared
// memory of qkv_kernel (at most 47 KB in bf16, 80 KB in fp32 at C 512).
template <typename T>
struct Smem {
  static constexpr int A = KC + 16 / (int)sizeof(T);
  static constexpr int B = SLICE + 8;
  static constexpr int U = SLICE + 16 / (int)sizeof(T);
  // the As/Bs double buffer, reused for u and then the conv output
  static constexpr size_t tiles = 2 * (size_t)MR * A * sizeof(T) + 2 * (size_t)KC * B * sizeof(T);
  static constexpr size_t u = (size_t)MR * U * sizeof(T);
  static constexpr size_t region = tiles > u ? tiles : u;
  static size_t bytes(int C) { return region + (2 * MR + 2 * C + 9 * SLICE) * sizeof(float); }
};

template <typename T>
struct EpiGated {  // out = x + round(round(gate) * round(acc)), per image z
  const T* x;
  const float* gate;
  int ldg;
  T* out;
  int C, HW;
  __device__ __forceinline__ void operator()(int z, int m, int n, float acc) const {
    const long long i = ((long long)z * HW + m) * C + n;
    const float o = fd::round_io<T>(acc);
    const float g = fd::round_io<T>(fd::round_io<T>(gate[(long long)z * ldg + n]) * o);
    out[i] = fd::from_f<T>(fd::to_f<T>(x[i]) + g);
  }
};

// Wqkv column of slice column j: slice s < heads holds head s's q columns
// then its k columns, slice heads + i the v columns [64 i, 64 i + 64)
__device__ __forceinline__ int slice_col(int s, int heads, int C, int j) {
  if (s < heads) return j < HEAD ? s * HEAD + j : C + s * HEAD + j - HEAD;
  return 2 * C + (s - heads) * SLICE + j;
}

// One warp's partial q^T k [32 x 32] over 16 pixels of the conv output S
// [px][QL] (q in columns 0-31, k in 32-63): A = q^T, B = k.  bf16: ldmatrix
// (.trans for A, stored pixel-major) and mma m16n8k16; fp32: 3xTF32 mma
// m16n8k8 in two steps of 8 pixels.  g holds m16n8 fragments as warp_mma's.
template <typename T>
__device__ __forceinline__ void gram_tile(float (&g)[2][4][4], const T* S, int lane) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    unsigned a[2][4], bk[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      fd::ldmatrix_x4_trans(a[i], S + ((lane & 7) + 8 * (lane >> 4)) * QL + 16 * i +
                                      8 * ((lane >> 3) & 1));
#pragma unroll
    for (int j = 0; j < 2; ++j)
      fd::ldmatrix_x4_trans(bk[j], S + (lane & 15) * QL + HEAD + 16 * j + (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        fd::mma_bf16(g[i][j], a[i], bk[j >> 1][(j & 1) * 2], bk[j >> 1][(j & 1) * 2 + 1]);
  } else {
    const int gg = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < 16; k += 8) {
      const float* P = S + k * QL;
      unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        fd::split_tf32(P[t * QL + 16 * i + gg], ah[i][0], al[i][0]);
        fd::split_tf32(P[t * QL + 16 * i + gg + 8], ah[i][1], al[i][1]);
        fd::split_tf32(P[(t + 4) * QL + 16 * i + gg], ah[i][2], al[i][2]);
        fd::split_tf32(P[(t + 4) * QL + 16 * i + gg + 8], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fd::split_tf32(P[t * QL + HEAD + 8 * j + gg], bh[j][0], bl[j][0]);
        fd::split_tf32(P[(t + 4) * QL + HEAD + 8 * j + gg], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          fd::mma_tf32(g[i][j], al[i], bh[j][0], bh[j][1]);
          fd::mma_tf32(g[i][j], ah[i], bl[j][0], bl[j][1]);
          fd::mma_tf32(g[i][j], ah[i], bh[j][0], bh[j][1]);
        }
    }
  }
}

// grid (tiles, 3C / 64 slices, B), THREADS threads; see the design note.
// stats [P, 2] (mean, rstd); ms/mt rows of stride ldm; wqkv [C, 3C]; taps
// [9, 3C]; v [P, C]; part [B, heads, tiles, PART].
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
qkv_kernel(const T* __restrict__ x, const float* __restrict__ stats,
           const float* __restrict__ ms, const float* __restrict__ mt, int ldm,
           const T* __restrict__ wqkv, const T* __restrict__ taps, T* __restrict__ v,
           float* __restrict__ part, int H, int W, int C) {
  using S = Smem<T>;
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int AV = MR * KC / V;    // vectors of one x2 chunk (rows past ROWS idle)
  constexpr int APT = (AV + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);         // [2][MR][S::A]
  T* Bs = As + 2 * MR * S::A;                     // [2][KC][S::B]
  T* us = reinterpret_cast<T*>(smem_raw);         // [MR][S::U], after the products
  float* st = reinterpret_cast<float*>(smem_raw + S::region);  // [MR][2]
  float* mss = st + 2 * MR;                       // [C]
  float* mts = mss + C;                           // [C]
  float* tps = mts + C;                           // [9][SLICE]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int heads = C / HEAD, s = blockIdx.y, b = blockIdx.z;
  const int ntx = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / ntx) * TH, tx0 = (blockIdx.x % ntx) * TW;
  const int width = s < heads ? SLICE : min(SLICE, C - (s - heads) * SLICE);
  const long long img = (long long)b * H * W;
  // halo row r -> image pixel, or -1 outside the image
  auto pixel = [&](int r) -> long long {
    const int yy = ty0 - 1 + r / RW, xx = tx0 - 1 + r % RW;
    if (r >= ROWS || yy < 0 || yy >= H || xx < 0 || xx >= W) return -1;
    return img + (long long)yy * W + xx;
  };
  for (int r = tid; r < MR; r += THREADS) {
    const long long p = pixel(r);
    st[2 * r] = p < 0 ? 0.f : stats[2 * p];
    st[2 * r + 1] = p < 0 ? 0.f : stats[2 * p + 1];
  }
  for (int c = tid; c < C; c += THREADS) {
    mss[c] = 1.f + ms[(long long)b * ldm + c];
    mts[c] = mt[(long long)b * ldm + c];
  }
  for (int i = tid; i < 9 * SLICE; i += THREADS) {
    const int t = i / SLICE, j = i % SLICE;
    tps[i] = j < width ? fd::to_f<T>(taps[(long long)t * 3 * C + slice_col(s, heads, C, j)])
                       : 0.f;
  }
  __syncthreads();

  // x of chunk k0 for this thread's vectors into registers; then x2 into As
  typename fd::Vec<T>::U xr[APT];
  auto load_x = [&](int k0) {
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int e = tid + i * THREADS, r = e / (KC / V), c = (e % (KC / V)) * V;
      const long long p = e < AV ? pixel(r) : -1;
      if (p >= 0)
        xr[i] = *reinterpret_cast<const typename fd::Vec<T>::U*>(x + p * C + k0 + c);
    }
  };
  auto store_x2 = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int e = tid + i * THREADS, r = e / (KC / V), c = (e % (KC / V)) * V;
      if (e >= AV) continue;
      float y[V];
      if (pixel(r) >= 0) {
        const T* xe = reinterpret_cast<const T*>(&xr[i]);
        const float mean = st[2 * r], rstd = st[2 * r + 1];
        float sc[V], sh[V];
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          fd::load_vec<float>(mss + k0 + c + j, sc + j);
          fd::load_vec<float>(mts + k0 + c + j, sh + j);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float t = (fd::to_f<T>(xe[j]) - mean) * rstd;
          y[j] = t * sc[j] + sh[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) y[j] = 0.f;
      }
      fd::store_vec<T>(As + ((size_t)buf * MR + r) * S::A + c, y);
    }
  };
  auto load_w = [&](int buf, int k0) {  // Wqkv rows [k0, k0 + KC) of the slice
    for (int e = tid; e < KC * SLICE / V; e += THREADS) {
      const int r = e / (SLICE / V), j = (e % (SLICE / V)) * V;
      const bool ok = j < width;
      fd::cp_async16(Bs + ((size_t)buf * KC + r) * S::B + j,
                     ok ? wqkv + (long long)(k0 + r) * 3 * C + slice_col(s, heads, C, j) : wqkv,
                     ok ? 16 : 0);
    }
  };

  float acc[3][4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int wm = (warp & 3) * 48, wn = (warp >> 2) * 32;
  const int nk = C / KC;
  load_x(0);
  store_x2(0, 0);
  load_w(0, 0);
  fd::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    fd::cp_async_wait<0>();
    __syncthreads();  // chunk kt is in place; every warp is done with chunk kt - 1
    const bool more = kt + 1 < nk;
    if (more) {
      load_x((kt + 1) * KC);
      load_w(buf ^ 1, (kt + 1) * KC);
    }
    fd::cp_async_commit();
    fd::warp_mma<T, 3, 4>(acc, As + ((size_t)buf * MR + wm) * S::A, S::A,
                          Bs + (size_t)buf * KC * S::B + wn, S::B, KC, lane);
    if (more) store_x2(buf ^ 1, (kt + 1) * KC);
  }
  fd::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the tiles: us reuses them
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm + 16 * i + (lane >> 2) + 8 * (e >> 1);
        const int c = wn + 8 * j + 2 * (lane & 3) + (e & 1);
        us[r * S::U + c] = fd::from_f<T>(acc[i][j][e]);
      }
  __syncthreads();

  // depthwise 3x3: this thread's 8 channels at 4 of the tile's 128 pixels
  const int cg = (tid & 7) * 8;
  float out[4][8];
  bool live[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = (tid >> 3) + 32 * q, oy = o / TW, ox = o % TW;
    live[q] = ty0 + oy < H && tx0 + ox < W;
#pragma unroll
    for (int c = 0; c < 8; ++c) out[q][c] = 0.f;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        const int r = (oy + dr) * RW + ox + dc;
        if (pixel(r) < 0) continue;
        float u[8];
        fd::load_vec<T>(us + r * S::U + cg, u);
        if constexpr (V == 4) fd::load_vec<T>(us + r * S::U + cg + 4, u + 4);
        float tp[8];
        fd::load_vec<float>(tps + (dr * 3 + dc) * SLICE + cg, tp);
        fd::load_vec<float>(tps + (dr * 3 + dc) * SLICE + cg + 4, tp + 4);
#pragma unroll
        for (int c = 0; c < 8; ++c) out[q][c] += u[c] * tp[c];
      }
#pragma unroll
    for (int c = 0; c < 8; ++c) out[q][c] = live[q] ? fd::round_io<T>(out[q][c]) : 0.f;
  }

  if (s >= heads) {  // a v slice: v [P, C]
    const int c0 = (s - heads) * SLICE + cg;
    if (cg >= width) return;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!live[q]) continue;
      const int o = (tid >> 3) + 32 * q;
      T* dst = v + (img + (long long)(ty0 + o / TW) * W + tx0 + o % TW) * C + c0;
      fd::store_vec<T>(dst, out[q]);
      if constexpr (V == 4) fd::store_vec<T>(dst + 4, out[q] + 4);
    }
    return;
  }
  // a q/k slice: the conv output (io values) over us, then the tile's
  // partial q^T k block on the tensor cores, warp w over pixels [16 w, 16 w
  // + 16), and the squared norms; the warps' sums added in order
  T* qk = reinterpret_cast<T*>(smem_raw);  // [TH * TW][QL]
  __syncthreads();                         // every thread has read us
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    T* row = qk + ((tid >> 3) + 32 * q) * QL + cg;
    fd::store_vec<T>(row, out[q]);
    if constexpr (V == 4) fd::store_vec<T>(row + 4, out[q] + 4);
  }
  __syncthreads();
  float g[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) g[i][j][e] = 0.f;
  const T* mypx = qk + 16 * warp * QL;
  gram_tile<T>(g, mypx, lane);
  float sq = 0.f, sk = 0.f;
#pragma unroll
  for (int px = 0; px < 16; ++px) {
    const float qv = fd::to_f<T>(mypx[px * QL + lane]);
    const float kv = fd::to_f<T>(mypx[px * QL + HEAD + lane]);
    sq = fmaf(qv, qv, sq);
    sk = fmaf(kv, kv, sk);
  }
  __syncthreads();  // every warp has read qk
  float* red = reinterpret_cast<float*>(smem_raw);  // [8][PART]
  float* mine = red + warp * PART;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(16 * i + (lane >> 2) + 8 * (e >> 1)) * HEAD + 8 * j + 2 * (lane & 3) + (e & 1)] =
            g[i][j][e];
  mine[GRAM + lane] = sq;
  mine[GRAM + HEAD + lane] = sk;
  __syncthreads();
  float* dst = part + (((long long)b * heads + s) * gridDim.x + blockIdx.x) * PART;
  for (int i = tid; i < PART; i += THREADS) {
    float acc2 = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) acc2 += red[w * PART + i];
    dst[i] = acc2;
  }
}

// grid (groups, heads, B): part [B, heads, tiles, PART] summed RED tiles at a
// time, in order, into part2 [B, heads, groups, PART]
__global__ void __launch_bounds__(THREADS)
gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ part2, int tiles) {
  const int g = blockIdx.x, groups = gridDim.x;
  const long long bh = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const float* src = part + (bh * tiles + g * RED) * PART;
  const int n = min(RED, tiles - g * RED);
  for (int i = threadIdx.x; i < PART; i += THREADS) {
    float acc = 0.f;
    for (int t = 0; t < n; ++t) acc += src[(long long)t * PART + i];
    part2[(bh * groups + g) * PART + i] = acc;
  }
}

// grid (C / 64, heads, B): the groups summed in order, norms, temperature,
// softmax, and the head's 32 rows x these 64 columns of M [B, C, C] (rows =
// v channels); pk [C_in, C_out] fp32
template <typename T>
__global__ void __launch_bounds__(THREADS)
fold_kernel(const float* __restrict__ part2, int groups, const float* __restrict__ temp,
            const float* __restrict__ pk, T* __restrict__ M, int C) {
  __shared__ float G[HEAD][HEAD + 1];
  __shared__ float nq[HEAD], nk[HEAD];
  __shared__ float pks[HEAD][SLICE];
  const int e0 = blockIdx.x * SLICE, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int t = threadIdx.x;
  const int cols = min(SLICE, C - e0);
  const float* src = part2 + ((long long)b * heads + h) * groups * PART;
  for (int i = t; i < PART; i += THREADS) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += src[(long long)g * PART + i];
    if (i < GRAM) G[i / HEAD][i % HEAD] = acc;
    else if (i < GRAM + HEAD) nq[i - GRAM] = fmaxf(sqrtf(acc), 1e-12f);
    else nk[i - GRAM - HEAD] = fmaxf(sqrtf(acc), 1e-12f);
  }
  for (int i = t; i < HEAD * SLICE; i += THREADS) {
    const int c = i / SLICE, e = i % SLICE;
    pks[c][e] = e < cols ? pk[(long long)(h * HEAD + c) * C + e0 + e] : 0.f;
  }
  __syncthreads();
  // one warp per query row c: logits over the head's 32 keys, softmax
  const int warp = t >> 5, lane = t & 31;
  const float tp = temp[h];
  for (int c = warp; c < HEAD; c += THREADS / 32) {
    const float l = G[c][lane] / (nq[c] * nk[lane]) * tp;
    const float mx = fd::warp_max(l);
    const float ex = expf(l - mx);
    const float sum = fd::warp_sum(ex);
    G[c][lane] = ex / sum;
  }
  __syncthreads();
  // M[h*32 + d, e0 + e] = sum_c attn[c, d] * pk[h*32 + c, e0 + e]
  T* Mb = M + (long long)b * C * C;
  for (int i = t; i < HEAD * SLICE; i += THREADS) {
    const int d = i / SLICE, e = i % SLICE;
    if (e >= cols) continue;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < HEAD; ++c) acc = fmaf(G[c][d], pks[c][e], acc);
    Mb[(long long)(h * HEAD + d) * C + e0 + e] = fd::from_f<T>(acc);
  }
}

template <typename T>
int run(const void* x_, const float* ms, const float* mt, int ldm, const float* gate, int ldg,
        const void* wqkv_, const void* taps_, const float* temp, const float* pk, void* out_,
        void* ws_, int B, int H, int W, int C, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(x_);
  const int HW = H * W, heads = C / HEAD;
  const long long P = (long long)B * HW;
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int groups = (tiles + RED - 1) / RED;
  if (C % HEAD || P > 0x7fffffffLL || !fd::aligned16(x_, wqkv_, ws_))
    return (int)cudaErrorInvalidValue;
  // the workspace's pieces, each 256-byte aligned (as the wrapper sizes it)
  unsigned char* p = static_cast<unsigned char*>(ws_);
  auto take = [&](size_t bytes) {
    unsigned char* q = p;
    p += (bytes + 255) & ~(size_t)255;
    return q;
  };
  float* stats = reinterpret_cast<float*>(take(P * 2 * sizeof(float)));
  T* v = reinterpret_cast<T*>(take(P * C * sizeof(T)));
  float* part = reinterpret_cast<float*>(take((size_t)B * heads * tiles * PART * sizeof(float)));
  float* part2 = reinterpret_cast<float*>(take((size_t)B * heads * groups * PART * sizeof(float)));
  T* M = reinterpret_cast<T*>(p);

  FD_TRY((fd::ln_rows_vec<T, T>(x, nullptr, nullptr, nullptr, nullptr, 0, (T*)nullptr, stats,
                                P, HW, C, eps, s)));
  const int slices = heads + (C + SLICE - 1) / SLICE;
  FD_TRY(fd::launch(qkv_kernel<T>, dim3(tiles, slices, B), THREADS, Smem<T>::bytes(C), s, x,
                    stats, ms, mt, ldm, static_cast<const T*>(wqkv_),
                    static_cast<const T*>(taps_), v, part, H, W, C));
  gram_reduce_kernel<<<dim3(groups, heads, B), THREADS, 0, s>>>(part, part2, tiles);
  FD_TRY(cudaGetLastError());
  fold_kernel<T><<<dim3((C + SLICE - 1) / SLICE, heads, B), THREADS, 0, s>>>(part2, groups,
                                                                            temp, pk, M, C);
  FD_TRY(cudaGetLastError());
  FD_TRY((fd::gemm_mma<T>(B, HW, C, C, fd::RowStrided<T>{v, (long long)HW * C, C}, C, v, M,
                          (long long)C * C, B, C,
                          EpiGated<T>{x, gate, ldg, static_cast<T*>(out_), C, HW}, s)));
  return 0;
}

}  // namespace

// x, out [B, H, W, C] and wqkv [C, 3C], taps [9, 3C] at the io dtype; ms,
// mt rows of stride ldm and gate rows of stride ldg, temp [heads], pk [C,
// C] fp32; ws: the workspace, 256-byte aligned pieces of P * 2 fp32 (the LN
// statistics), P * C io (v), B * heads * tiles * 1088 and B * heads *
// ceil(tiles / 16) * 1088 fp32 (the Gram partials) and B * C * C io (M),
// with P = B H W and tiles = ceil(H / 8) ceil(W / 16).
extern "C" int attn_block_forward(const void* x, const float* ms, const float* mt,
                                  const float* gate, const void* wqkv, const void* taps,
                                  const float* temp, const float* pk, void* out, void* ws,
                                  int ldm, int ldg, int B, int H, int W, int C, float eps,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, ms, mt, ldm, gate, ldg, wqkv, taps, temp, pk, out, ws, B, H, W, C, eps,
                      s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, ms, mt, ldm, gate, ldg, wqkv, taps, temp, pk, out, ws, B, H, W,
                              C, eps, s);
  return (int)cudaErrorInvalidValue;
}
