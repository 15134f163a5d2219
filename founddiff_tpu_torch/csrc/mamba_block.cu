// Unified MambaBlock first half, from the raw block input x:
//
//   out = x + gate * out_proj(LN(scan(xs)) * silu(z) + local),
//   xc  = round_io((x - mean) * rstd)                   (LN without affine)
//   U   = round_io(xc Wxg_b + bx_b),  z = round_io(xc Wzg_b + bz_b)
//   xs  = round_io(silu(dwconv3x3(U) + dw_bias))
//
// where Wxg_b = round_io(Wx * geff_b), bx_b = beff_b Wx (and the same for
// Wz) fold image b's LN affine and adaLN modulation (geff = ln_scale *
// (1 + mod_scale), beff = ln_bias * (1 + mod_scale) + mod_shift) into the
// in_proj weights, as the TPU kernels do; the wrapper folds them in plain
// PyTorch, as JAX computes them outside its kernel bodies.
//
// Replaces the TPU kernels _mblock_row_kernel
// (founddiff_tpu/ops/experimental_unified.py:173) and _mblock_col_kernel
// (:265), both launched by _mblock_call (:533) from ss2d_mamba_block :674:
// the row kernel writes the even-row plane (the row scans), the column
// kernel the odd-row plane (the column scans).  Here one host entry does the
// whole block for both planes.
//
// Bound on the H100 (as chip_smoke.py counts it): the products (in_proj's
// 2*C0*D multiply-adds per pixel, delta/B/C through their rank-R factors,
// out_proj's D*C0) on the tensor cores, the scan's and the depthwise conv's
// fp32 operations, or the bytes of x in and out.  The tail (ss2d_tail.cuh,
// shared with ss2d_block.cu and unchanged) passes the projections, y and
// its LN statistics through device memory and sits far above that bound
// (PERF.md).  The front half keeps U on chip:
//   1. the LN statistics (mean, rstd) of every pixel of x (fd::ln_rows_vec);
//   2. front_kernel, one block per (8 x 16 pixel tile, 64-column slice of
//      Wxg_b, image), as attn_block.cu's qkv_kernel: xc for the tile and
//      its one-pixel halo (10 x 18 = 180 rows, padded to 192) is centred
//      chunk by chunk into shared memory from x and the statistics, rounded
//      to the io dtype (the slice-0 blocks write the tile's own xc rows for
//      the tail's z product), and in_proj runs on the tensor cores (bf16
//      mma, fp32 as three TF32 products through fd::warp_mma) with the next
//      chunk's loads in flight; U = round_io(acc + bx_b) stays in shared
//      memory (zero outside the image: the conv's SAME padding), and the
//      depthwise 3x3 reads it there with io taps and fp32 sums, each
//      column's three rows first, then the columns (the TPU kernels'
//      order), adds the dw bias, takes silu in fp32 and writes xs rounded.
//      The halo costs 192 / 128 = 1.5x the tile's own products, and each
//      of the D / 64 slices reads the tile of x again from L2;
//   3. the SS2D tail of ss2d_tail.cuh on xs, per image (PER_IMAGE): z =
//      xc Wzg_b + bz_b.
// The TPU kernels' halo rows carried between grid steps in VMEM scratch, the
// column kernel's strip loop and the output alias are Mosaic's schedule and
// are not ported.
#include "ss2d_tail.cuh"

namespace {

constexpr int TH = 8, TW = 16;         // output pixels of a tile
constexpr int RW = TW + 2;             // halo row width
constexpr int ROWS = (TH + 2) * RW;    // halo pixels of a tile: 180
constexpr int MR = 192;                // ROWS padded to 12 m16 tiles
constexpr int SLICE = 64;              // U columns of a block
constexpr int KC = 32;                 // k (C0) of one staged chunk
constexpr int THREADS = 256;           // 8 warps: 4 x 48 rows, 2 x 32 columns

// Padded row lengths (elements) of the shared tiles, 16-byte aligned and
// free of bank conflicts for the fragment loads; bytes: the dynamic shared
// memory of front_kernel (44 KB in bf16, 78 KB in fp32).
template <typename T>
struct Smem {
  static constexpr int A = KC + 16 / (int)sizeof(T);
  static constexpr int B = SLICE + 8;
  static constexpr int U = SLICE + 16 / (int)sizeof(T);
  // the As/Bs double buffer, reused for U after the products
  static constexpr size_t tiles = 2 * (size_t)MR * A * sizeof(T) + 2 * (size_t)KC * B * sizeof(T);
  static constexpr size_t u = (size_t)MR * U * sizeof(T);
  static constexpr size_t region = tiles > u ? tiles : u;
  static constexpr size_t bytes = region + (2 * MR + 11 * SLICE) * sizeof(float);
};

// grid (tiles x ceil(D / 64) slices, B), THREADS threads; see the design note.
// stats [P, 2] (mean, rstd); wxg [B, C0, D]; bx [B, D] fp32; taps [9, D];
// dwb [D] fp32; writes xc [P, C0] (slice 0) and xs [P, D].
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
front_kernel(const T* __restrict__ x, const float* __restrict__ stats,
             const T* __restrict__ wxg, const float* __restrict__ bx,
             const T* __restrict__ taps, const float* __restrict__ dwb, T* __restrict__ xc,
             T* __restrict__ xs, int H, int W, int C0, int D) {
  using S = Smem<T>;
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int AV = MR * KC / V;    // vectors of one xc chunk (rows past ROWS idle)
  constexpr int APT = (AV + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);         // [2][MR][S::A]
  T* Bs = As + 2 * MR * S::A;                     // [2][KC][S::B]
  T* us = reinterpret_cast<T*>(smem_raw);         // [MR][S::U], after the products
  float* st = reinterpret_cast<float*>(smem_raw + S::region);  // [MR][2]
  float* tps = st + 2 * MR;                       // [9][SLICE]
  float* bxs = tps + 9 * SLICE;                   // [SLICE]
  float* dbs = bxs + SLICE;                       // [SLICE]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a tile's slices are neighbouring blocks, so they read its x from L2
  const int slices = (D + SLICE - 1) / SLICE, tile = blockIdx.x / slices;
  const int s = blockIdx.x % slices, b = blockIdx.y;
  const int ntx = (W + TW - 1) / TW;
  const int ty0 = (tile / ntx) * TH, tx0 = (tile % ntx) * TW;
  const int c0 = s * SLICE, width = min(SLICE, D - c0);
  const long long img = (long long)b * H * W;
  const T* wb = wxg + (long long)b * C0 * D + c0;
  // halo row r -> image pixel, or -1 outside the image
  auto pixel = [&](int r) -> long long {
    const int yy = ty0 - 1 + r / RW, xx = tx0 - 1 + r % RW;
    if (r >= ROWS || yy < 0 || yy >= H || xx < 0 || xx >= W) return -1;
    return img + (long long)yy * W + xx;
  };
  // halo row r is one of the tile's own pixels (inside the image)
  auto own = [&](int r) {
    const int ry = r / RW, rx = r % RW;
    return ry >= 1 && ry <= TH && rx >= 1 && rx <= TW && pixel(r) >= 0;
  };
  // x of chunk k0 for this thread's vectors into registers; then xc into As
  typename fd::Vec<T>::U xr[APT];
  auto load_x = [&](int k0) {
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int e = tid + i * THREADS, r = e / (KC / V), c = (e % (KC / V)) * V;
      const long long p = e < AV && k0 + c < C0 ? pixel(r) : -1;
      if (p >= 0)
        xr[i] = *reinterpret_cast<const typename fd::Vec<T>::U*>(x + p * C0 + k0 + c);
    }
  };
  auto store_xc = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int e = tid + i * THREADS, r = e / (KC / V), c = (e % (KC / V)) * V;
      if (e >= AV) continue;
      float y[V];
      const long long p = k0 + c < C0 ? pixel(r) : -1;
      if (p >= 0) {
        const T* xe = reinterpret_cast<const T*>(&xr[i]);
        const float mean = st[2 * r], rstd = st[2 * r + 1];
#pragma unroll
        for (int j = 0; j < V; ++j) y[j] = (fd::to_f<T>(xe[j]) - mean) * rstd;
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) y[j] = 0.f;
      }
      T* dst = As + ((size_t)buf * MR + r) * S::A + c;
      fd::store_vec<T>(dst, y);
      if (s == 0 && p >= 0 && own(r))  // the tile's xc rows, once, for the z product
        *reinterpret_cast<typename fd::Vec<T>::U*>(xc + p * C0 + k0 + c) =
            *reinterpret_cast<const typename fd::Vec<T>::U*>(dst);
    }
  };
  auto load_w = [&](int buf, int k0) {  // Wxg_b rows [k0, k0 + KC) of the slice
    for (int e = tid; e < KC * SLICE / V; e += THREADS) {
      const int r = e / (SLICE / V), j = (e % (SLICE / V)) * V;
      const bool ok = j < width && k0 + r < C0;
      fd::cp_async16(Bs + ((size_t)buf * KC + r) * S::B + j,
                     ok ? wb + (long long)(k0 + r) * D + j : wxg, ok ? 16 : 0);
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
  const int nk = (C0 + KC - 1) / KC;
  load_x(0);  // in flight while the statistics and the slice's constants come in
  load_w(0, 0);
  fd::cp_async_commit();
  for (int r = tid; r < MR; r += THREADS) {
    const long long p = pixel(r);
    st[2 * r] = p < 0 ? 0.f : stats[2 * p];
    st[2 * r + 1] = p < 0 ? 0.f : stats[2 * p + 1];
  }
  for (int i = tid; i < 11 * SLICE; i += THREADS) {
    const int t = i / SLICE, j = i % SLICE;
    float val = 0.f;
    if (j < width) {
      if (t < 9) val = fd::to_f<T>(taps[(long long)t * D + c0 + j]);
      else if (t == 9) val = bx[(long long)b * D + c0 + j];
      else val = dwb[c0 + j];
    }
    tps[i] = val;  // tps, bxs and dbs are one array
  }
  __syncthreads();
  store_xc(0, 0);
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
    if (more) store_xc(buf ^ 1, (kt + 1) * KC);
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
        us[r * S::U + c] = fd::from_f<T>(pixel(r) < 0 ? 0.f : acc[i][j][e] + bxs[c]);
      }
  __syncthreads();

  // depthwise 3x3: this thread's 8 channels at 4 of the tile's 128 pixels,
  // pixels (tid / 8) + 32 q; each tap's 8 values loaded once for the 4
  const int cg = (tid & 7) * 8;
  if (cg >= width) return;
  float out[4][8];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < 8; ++c) out[q][c] = 0.f;
#pragma unroll
  for (int dc = 0; dc < 3; ++dc) {
    float part[4][8];  // column dc's three rows
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < 8; ++c) part[q][c] = 0.f;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      float tp[8];
      fd::load_vec<float>(tps + (dr * 3 + dc) * SLICE + cg, tp);
      fd::load_vec<float>(tps + (dr * 3 + dc) * SLICE + cg + 4, tp + 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = (tid >> 3) + 32 * q;
        const int r = (o / TW + dr) * RW + o % TW + dc;
        if (pixel(r) < 0) continue;
        float u[8];
        fd::load_vec<T>(us + r * S::U + cg, u);
        if constexpr (V == 4) fd::load_vec<T>(us + r * S::U + cg + 4, u + 4);
#pragma unroll
        for (int c = 0; c < 8; ++c) part[q][c] += u[c] * tp[c];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < 8; ++c) out[q][c] += part[q][c];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = (tid >> 3) + 32 * q, oy = o / TW, ox = o % TW;
    if (ty0 + oy >= H || tx0 + ox >= W) continue;
    float y[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float a = out[q][c] + dbs[cg + c];
      y[c] = a * (1.f / (1.f + expf(-a)));
    }
    T* dst = xs + (img + (long long)(ty0 + oy) * W + tx0 + ox) * D + c0 + cg;
    fd::store_vec<T>(dst, y);
    if constexpr (V == 4) fd::store_vec<T>(dst + 4, y + 4);
  }
}

template <typename T>
int run(const void* x_, const void* wxg_, const float* bx, const void* wzg_, const float* bz,
        const void* taps_, const float* dwb, const void* wproj_, const float* A,
        const float* Ds, const float* dbias, const float* lng, const float* lnb,
        const float* local, const void* pw_, const float* gate, void* out_, void* xc_,
        void* xs_, float* proj, float* csum, float* cstate, float* ybuf, float* yacc,
        float* stats, void* og_, int B, int H, int W, int C0, int D, int NS, int TC,
        float eps_ln, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(x_);
  T* xc = static_cast<T*>(xc_);
  T* xs = static_cast<T*>(xs_);
  constexpr int V = 16 / sizeof(T);
  if (C0 % V != 0 || D % V != 0 || !fd::aligned16(x_, wxg_, taps_, xc_, xs_))
    return (int)cudaErrorInvalidValue;
  const long long P = (long long)B * H * W;
  // the LN statistics of x; the tail writes its own into stats after
  FD_TRY((fd::ln_rows_vec<T, T>(x, nullptr, nullptr, nullptr, nullptr, 0, nullptr, stats, P, 1,
                                C0, eps_ln, s)));
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const dim3 grid((unsigned)(tiles * ((D + SLICE - 1) / SLICE)), (unsigned)B);
  FD_TRY(fd::launch(front_kernel<T>, grid, THREADS, Smem<T>::bytes, s, x,
                    static_cast<const float*>(stats), static_cast<const T*>(wxg_), bx,
                    static_cast<const T*>(taps_), dwb, xc, xs, H, W, C0, D));
  return fd::ss2d_tail<T, true>(xc, xs, x, static_cast<const T*>(wzg_), bz,
                                static_cast<const T*>(wproj_), A, Ds, dbias, lng, lnb, local,
                                static_cast<const T*>(pw_), gate, static_cast<T*>(out_), proj,
                                csum, cstate, ybuf, yacc, stats, static_cast<T*>(og_), B, H,
                                W, C0, D, NS, TC, eps, s);
}

}  // namespace

// x [B, H, W, C0] (io); wxg, wzg [B, C0, D] (io), bx, bz [B, D] fp32; taps
// [9, D] (io), dwb [D] fp32; the tail's operands as ss2d_block_forward's,
// per image for z.  C0 and D multiples of 8; x, wxg, taps, xc and xs
// 16-byte aligned.  Scratch: xc [P, C0] and xs [P, D] (io), proj, csum,
// cstate, ybuf, yacc, stats, og as ss2d_block_forward's.  Writes out (io).
extern "C" int mamba_block_forward(
    const void* x, const void* wxg, const float* bx, const void* wzg, const float* bz,
    const void* taps, const float* dwb, const void* wproj, const float* A, const float* Ds,
    const float* dbias, const float* lng, const float* lnb, const float* local, const void* pw,
    const float* gate, void* out, void* xc, void* xs, float* proj, float* csum, float* cstate,
    float* ybuf, float* yacc, float* stats, void* og, int B, int H, int W, int C0, int D,
    int NS, int TC, float eps_ln, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, wxg, bx, wzg, bz, taps, dwb, wproj, A, Ds, dbias, lng, lnb, local, pw,
                      gate, out, xc, xs, proj, csum, cstate, ybuf, yacc, stats, og, B, H, W,
                      C0, D, NS, TC, eps_ln, eps, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, wxg, bx, wzg, bz, taps, dwb, wproj, A, Ds, dbias, lng, lnb,
                              local, pw, gate, out, xc, xs, proj, csum, cstate, ybuf, yacc,
                              stats, og, B, H, W, C0, D, NS, TC, eps_ln, eps, s);
  return (int)cudaErrorInvalidValue;
}
