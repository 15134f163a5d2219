// Selective scan over [G, L, *] direction sequences (G = batch * K
// directions): forward with the chunk-entry states, its backward, and the
// forward with the delta/B/C projections inside.
//
// Replaces the TPU kernels _scan_kernel (founddiff_tpu/ops/scan_pallas.py:269,
// pallas_call :379 in _pallas_fwd) and _scan_bwd_kernel (:415, pallas_call
// :567 in _pallas_bwd), the custom_vjp of selective_scan_pallas (:1141-1174)
// and the inner scan of _scan_image_bwd (:1063-1095).
//
// Math, per sequence g (direction k = g % K), channel d and state n:
//   delta' = softplus(delta + bias),  abar_t = exp(delta'_t A),
//   h_t = abar_t h_{t-1} + delta'_t B_t u_t,  y_t = C_t . h_t + Dskip u_t,
// and the adjoint  gh_t = C_t dy_t + abar_{t+1} gh_{t+1}.
//
// Bound on the H100: the fp32 scan operations (about 6*N*D per step forward,
// three times that backward) against the bytes of the [G, L, D] operands;
// at N = 4 the bytes.  Design, as the serving scan of ss2d_block.cu: L is
// cut into chunks of TC steps so that G * (L / TC) * D threads run at once
// (only G * D = 8 * 128 channels at the 512^2 scale).
//   forward: pass 1 per (g, chunk, d) from a zero state keeps the chunk's
//     end state and sum of delta'; a carry pass per (g, n, d) turns them into
//     entry states, written as h_bounds [G, NC, N, D] for the backward (the
//     decay exp(A * sum) never has a positive exponent); pass 2 reruns each
//     chunk from its entry state and writes y.
//   backward: pass 1 per (g, chunk, d) runs the adjoint backwards from a zero
//     carry and keeps abar_first * gh_first and the chunk's sum of delta'; a
//     carry pass walks the chunks in reverse and turns them into the carry
//     entering each chunk from the right; the main pass, one warp per
//     (g, chunk, 32 channels), replays h from h_bounds into shared memory
//     (TC * N * 32 floats), then walks the chunk backwards with the adjoint
//     and writes gu, gdelta and per-chunk partials of gA, gD and gbias, and
//     per-warp partials of gB and gC (sums over 32 channels by shuffles);
//     reduce kernels add the partials in a fixed order.  No float atomics:
//     every run gives the same bits.
// The TPU kernel's Hillis-Steele tile scans and 128-lane layout are Mosaic
// constraints and are not ported; padding is not needed, since a chunk
// simply ends at L (the TPU's padded steps have delta' = 0 and change
// nothing).
// State sizes: N in {4, 8, 16, 32, 64}, a template argument each, the
// states in registers.  N = 64 (the deepest level of a five-level UNet,
// base_d_state 4 * 2^4) costs what it must: the backward's main pass holds
// five [64] arrays a thread, so it runs at 255 registers and spills about
// 300 bytes a thread to local memory (-Xptxas -v on sm_90a; the forward
// passes use 168 registers and do not spill), and its 8-step chunk of
// replayed states is 64 KB of shared memory, above the 48 KB default, so it
// opts in with cudaFuncSetAttribute.  Other sizes raise in the wrapper.
//
// The fused-projection forward replaces the TPU kernel _scan_kernel_fused
// (scan_pallas.py:630, pallas_call :738 in _pallas_fwd_fused, through
// selective_scan_pallas_fused :817), the scan of the SS2D blocks on an odd
// grid (models/ss2d.py:467-475).  Its input is the decimated sequence xs
// [G, L, D] with the folded weights [K, D, D+2N] (delta | B | C); its
// outputs are y and the same h_bounds as the forward above, so its
// backward is scan_backward (_ssf_bwd, :791-812).  Bound on the H100: the
// [D, D+2N] projection at D = 512 and 1024, 2 * D * (D + 2N) operations per
// step against the scan's 6 * N * D, on the fp32 CUDA cores of
// common.cuh's tiled GEMM (no tensor cores yet), then the bytes of the fp32
// projections it passes through device memory.  Design: that GEMM with
// delta' = softplus(acc + bias) in its epilogue (EpiProj of
// scan_common.cuh, rows read straight from xs), then the forward's three
// passes reading delta'/B/C from the projections unrounded, as the TPU
// kernel keeps them in VMEM.  The TPU kernel's masked padding of the last
// chunk is not needed: a chunk ends at L (L = 529 at a 45^2 grid).
#include "scan_common.cuh"

namespace {

constexpr int FWD_THREADS = 128;
constexpr int WARP = 32;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <typename T, int NS, bool FINAL>
__global__ void __launch_bounds__(FWD_THREADS)
fwd_chunk_kernel(const T* __restrict__ u, const T* __restrict__ dl, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const float* __restrict__ A,
                 const float* __restrict__ Ds, const float* __restrict__ bias,
                 T* __restrict__ y, float* __restrict__ hb, float* __restrict__ dsum, int K,
                 int L, int D, int TC, int NC) {
  const int d = blockIdx.x * FWD_THREADS + threadIdx.x;
  const int c = blockIdx.y, g = blockIdx.z;
  if (d >= D) return;
  const int k = g % K;
  float a[NS], h[NS];
  float* hbp = hb + ((long long)g * NC + c) * NS * D + d;  // [g, c, n, d]
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a[n] = A[((long long)k * D + d) * NS + n];
    h[n] = FINAL ? hbp[(long long)n * D] : 0.f;
  }
  const float bs = bias[k * D + d];
  const float dsk = Ds[k * D + d];
  float s = 0.f;
  const int l1 = min(L, (c + 1) * TC);
  for (int l = c * TC; l < l1; ++l) {
    const long long row = (long long)g * L + l;
    const float dlt = fd::softplus(fd::to_f<T>(dl[row * D + d]) + bs);
    const float uu = fd::to_f<T>(u[row * D + d]);
    const float du = dlt * uu;
    const T* bp = Bm + row * NS;
    const T* cp = Cm + row * NS;
    float yv = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      h[n] = expf(dlt * a[n]) * h[n] + du * fd::to_f<T>(bp[n]);
      if (FINAL) yv = fmaf(fd::to_f<T>(cp[n]), h[n], yv);
    }
    if (FINAL) {
      y[row * D + d] = fd::from_f<T>(yv + dsk * uu);
    } else {
      s += dlt;
    }
  }
  if (!FINAL) {
#pragma unroll
    for (int n = 0; n < NS; ++n) hbp[(long long)n * D] = h[n];
    dsum[((long long)g * NC + c) * D + d] = s;
  }
}

// Chunk summaries -> chunk carries, one thread per (g, n, d); st [G, NC, N, D].
// Forward: st holds end states and becomes entry states (left to right).
// Backward: st holds abar_first * gh_first from a zero carry and becomes the
// carry entering each chunk at its last step (right to left).
template <bool REVERSE>
__global__ void carry_kernel(const float* __restrict__ A, const float* __restrict__ dsum,
                             float* __restrict__ st, int K, int D, int NS, int NC,
                             long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = idx % D;
  const int n = (idx / D) % NS;
  const long long g = idx / ((long long)NS * D);
  const float a = A[((g % K) * D + d) * NS + n];
  float carry = 0.f;
  for (int i = 0; i < NC; ++i) {
    const int c = REVERSE ? NC - 1 - i : i;
    const long long si = ((g * NC + c) * NS + n) * D + d;
    const float v = st[si];
    st[si] = carry;
    carry = expf(a * dsum[(g * NC + c) * D + d]) * carry + v;
  }
}

template <typename T, int NS>
int forward(const T* u, const T* dl, const T* Bm, const T* Cm, const float* A, const float* Ds,
            const float* bias, T* y, float* hb, float* dsum, int G, int K, int L, int D,
            int TC, cudaStream_t s) {
  const int NC = (L + TC - 1) / TC;
  dim3 grid((D + FWD_THREADS - 1) / FWD_THREADS, NC, G);
  fwd_chunk_kernel<T, NS, false><<<grid, FWD_THREADS, 0, s>>>(u, dl, Bm, Cm, A, Ds, bias, y,
                                                              hb, dsum, K, L, D, TC, NC);
  FD_TRY(cudaGetLastError());
  const long long total = (long long)G * NS * D;
  carry_kernel<false><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(A, dsum, hb, K, D, NS,
                                                                      NC, total);
  FD_TRY(cudaGetLastError());
  fwd_chunk_kernel<T, NS, true><<<grid, FWD_THREADS, 0, s>>>(u, dl, Bm, Cm, A, Ds, bias, y,
                                                             hb, dsum, K, L, D, TC, NC);
  FD_TRY(cudaGetLastError());
  return 0;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
template <typename T, int NS>
__global__ void __launch_bounds__(FWD_THREADS)
bwd_local_kernel(const T* __restrict__ dl, const T* __restrict__ Cm, const T* __restrict__ dy,
                 const float* __restrict__ A, const float* __restrict__ bias,
                 float* __restrict__ zl, float* __restrict__ dsum, int K, int L, int D, int TC,
                 int NC) {
  const int d = blockIdx.x * FWD_THREADS + threadIdx.x;
  const int c = blockIdx.y, g = blockIdx.z;
  if (d >= D) return;
  const int k = g % K;
  float a[NS], z[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a[n] = A[((long long)k * D + d) * NS + n];
    z[n] = 0.f;
  }
  const float bs = bias[k * D + d];
  float s = 0.f;
  const int l0 = c * TC, l1 = min(L, (c + 1) * TC);
  for (int l = l1 - 1; l >= l0; --l) {
    const long long row = (long long)g * L + l;
    const float dlt = fd::softplus(fd::to_f<T>(dl[row * D + d]) + bs);
    const float dyv = fd::to_f<T>(dy[row * D + d]);
    const T* cp = Cm + row * NS;
#pragma unroll
    for (int n = 0; n < NS; ++n) z[n] = expf(dlt * a[n]) * fmaf(fd::to_f<T>(cp[n]), dyv, z[n]);
    s += dlt;
  }
  float* zp = zl + ((long long)g * NC + c) * NS * D + d;
#pragma unroll
  for (int n = 0; n < NS; ++n) zp[(long long)n * D] = z[n];
  dsum[((long long)g * NC + c) * D + d] = s;
}

// One warp per (g, chunk, 32 channels); dynamic shared memory: the chunk's
// replayed states [TC][NS][32] fp32.
template <typename T, int NS>
__global__ void __launch_bounds__(WARP)
bwd_main_kernel(const T* __restrict__ u, const T* __restrict__ dl, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ dy, const float* __restrict__ A,
                const float* __restrict__ Ds, const float* __restrict__ bias,
                const float* __restrict__ hb, const float* __restrict__ cin,
                T* __restrict__ gu, T* __restrict__ gdl, float* __restrict__ gBp,
                float* __restrict__ gCp, float* __restrict__ gAp, float* __restrict__ gDp,
                float* __restrict__ gbp, int K, int L, int D, int TC, int NC) {
  extern __shared__ float traj[];
  const int lane = threadIdx.x;
  const int nd = gridDim.x, db = blockIdx.x;
  const int d = db * WARP + lane;
  const int c = blockIdx.y, g = blockIdx.z;
  const bool on = d < D;
  const int dd = on ? d : D - 1;  // lanes past D read a valid channel and add nothing
  const float live = on ? 1.f : 0.f;
  const int k = g % K;
  float a[NS], h0[NS], h[NS], z[NS], ga[NS];
  const long long sbase = ((long long)g * NC + c) * NS * D + dd;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a[n] = A[((long long)k * D + dd) * NS + n];
    h0[n] = hb[sbase + (long long)n * D];
    h[n] = h0[n];
    z[n] = live * cin[sbase + (long long)n * D];
    ga[n] = 0.f;
  }
  const float bs = bias[k * D + dd];
  const float dsk = Ds[k * D + dd];
  const int l0 = c * TC, nt = min(L, l0 + TC) - l0;
  // replay the chunk's states from its entry state
  for (int t = 0; t < nt; ++t) {
    const long long row = (long long)g * L + l0 + t;
    const float dlt = fd::softplus(fd::to_f<T>(dl[row * D + dd]) + bs);
    const float du = dlt * fd::to_f<T>(u[row * D + dd]);
    const T* bp = Bm + row * NS;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      h[n] = expf(dlt * a[n]) * h[n] + du * fd::to_f<T>(bp[n]);
      traj[(t * NS + n) * WARP + lane] = h[n];
    }
  }
  __syncwarp();
  // the adjoint, right to left
  float gds = 0.f, gbs = 0.f;
  for (int t = nt - 1; t >= 0; --t) {
    const long long row = (long long)g * L + l0 + t;
    const float raw = fd::to_f<T>(dl[row * D + dd]) + bs;
    const float dlt = fd::softplus(raw);
    const float uu = fd::to_f<T>(u[row * D + dd]);
    const float dyv = live * fd::to_f<T>(dy[row * D + dd]);
    const T* bp = Bm + row * NS;
    const T* cp = Cm + row * NS;
    float sb = 0.f, sh = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float ab = expf(dlt * a[n]);
      const float gh = fmaf(fd::to_f<T>(cp[n]), dyv, z[n]);
      const float hp = t > 0 ? traj[((t - 1) * NS + n) * WARP + lane] : h0[n];
      const float ht = traj[(t * NS + n) * WARP + lane];
      const float bn = fd::to_f<T>(bp[n]);
      sb = fmaf(gh, bn, sb);
      const float gha = gh * hp * ab;
      sh = fmaf(gha, a[n], sh);
      ga[n] = fmaf(gha, dlt, ga[n]);
      z[n] = ab * gh;
      const float pb = fd::warp_sum(gh * dlt * uu);
      const float pc = fd::warp_sum(ht * dyv);
      if (lane == 0) {
        const long long pi = (row * NS + n) * nd + db;  // [G, L, N, nd]
        gBp[pi] = pb;
        gCp[pi] = pc;
      }
    }
    const float gdlp = fmaf(uu, sb, sh);
    const float gd = gdlp / (1.f + expf(-raw));
    if (on) {
      gu[row * D + d] = fd::from_f<T>(fmaf(dsk, dyv, dlt * sb));
      gdl[row * D + d] = fd::from_f<T>(gd);
    }
    gds = fmaf(dyv, uu, gds);
    gbs += gd;
  }
  if (on) {
    const long long pbase = ((long long)g * NC + c) * NS * D + d;
#pragma unroll
    for (int n = 0; n < NS; ++n) gAp[pbase + (long long)n * D] = ga[n];
    gDp[((long long)g * NC + c) * D + d] = gds;
    gbp[((long long)g * NC + c) * D + d] = gbs;
  }
}

// gB, gC [G, L, N] at the io dtype from [G, L, N, nd] warp partials
template <typename T>
__global__ void reduce_bc_kernel(const float* __restrict__ gBp, const float* __restrict__ gCp,
                                 T* __restrict__ gB, T* __restrict__ gC, int nd,
                                 long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sb = 0.f, sc = 0.f;
  for (int j = 0; j < nd; ++j) {
    sb += gBp[i * nd + j];
    sc += gCp[i * nd + j];
  }
  gB[i] = fd::from_f<T>(sb);
  gC[i] = fd::from_f<T>(sc);
}

// gA [K, D, N] from [G, NC, N, D] partials; gD, gbias [K, D] from [G, NC, D]
// partials; one thread per (k, n, d), summed over (b, chunk) in order.
__global__ void reduce_params_kernel(const float* __restrict__ gAp,
                                     const float* __restrict__ gDp,
                                     const float* __restrict__ gbp, float* __restrict__ gA,
                                     float* __restrict__ gD, float* __restrict__ gbias, int Bsz,
                                     int K, int D, int NS, int NC) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)K * NS * D) return;
  const int d = idx % D;
  const int n = (idx / D) % NS;
  const int k = idx / ((long long)NS * D);
  float sa = 0.f, sd = 0.f, sbias = 0.f;
  for (int b = 0; b < Bsz; ++b) {
    const long long g = (long long)b * K + k;
    for (int c = 0; c < NC; ++c) {
      sa += gAp[((g * NC + c) * NS + n) * D + d];
      if (n == 0) {
        sd += gDp[(g * NC + c) * D + d];
        sbias += gbp[(g * NC + c) * D + d];
      }
    }
  }
  gA[((long long)k * D + d) * NS + n] = sa;
  if (n == 0) {
    gD[(long long)k * D + d] = sd;
    gbias[(long long)k * D + d] = sbias;
  }
}

template <typename T, int NS>
int backward(const T* u, const T* dl, const T* Bm, const T* Cm, const float* A,
             const float* Ds, const float* bias, const float* hb, const T* dy, T* gu, T* gdl,
             T* gB, T* gC, float* gA, float* gD, float* gbias, float* zl, float* dsum,
             float* gBp, float* gCp, float* gAp, float* gDp, float* gbp, int Bsz, int K, int L,
             int D, int TC, cudaStream_t s) {
  const int G = Bsz * K;
  const int NC = (L + TC - 1) / TC;
  const int nd = (D + WARP - 1) / WARP;
  dim3 grid1((D + FWD_THREADS - 1) / FWD_THREADS, NC, G);
  bwd_local_kernel<T, NS><<<grid1, FWD_THREADS, 0, s>>>(dl, Cm, dy, A, bias, zl, dsum, K, L, D,
                                                        TC, NC);
  FD_TRY(cudaGetLastError());
  const long long total = (long long)G * NS * D;
  carry_kernel<true><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(A, dsum, zl, K, D, NS, NC,
                                                                     total);
  FD_TRY(cudaGetLastError());
  const size_t smem = (size_t)TC * NS * WARP * sizeof(float);
  if (smem > 48 * 1024)  // N = 64 at the 8-step chunk: 64 KB, an opt-in size
    FD_TRY(cudaFuncSetAttribute(bwd_main_kernel<T, NS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  dim3 grid2(nd, NC, G);
  bwd_main_kernel<T, NS><<<grid2, WARP, smem, s>>>(u, dl, Bm, Cm, dy, A, Ds, bias, hb, zl, gu,
                                                   gdl, gBp, gCp, gAp, gDp, gbp, K, L, D, TC,
                                                   NC);
  FD_TRY(cudaGetLastError());
  const long long nbc = (long long)G * L * NS;
  reduce_bc_kernel<T><<<(unsigned)((nbc + 255) / 256), 256, 0, s>>>(gBp, gCp, gB, gC, nd, nbc);
  FD_TRY(cudaGetLastError());
  const long long np = (long long)K * NS * D;
  reduce_params_kernel<<<(unsigned)((np + 255) / 256), 256, 0, s>>>(gAp, gDp, gbp, gA, gD,
                                                                    gbias, Bsz, K, D, NS, NC);
  FD_TRY(cudaGetLastError());
  return 0;
}

template <typename T>
int forward_n(const void* u, const void* dl, const void* Bm, const void* Cm, const float* A,
              const float* Ds, const float* bias, void* y, float* hb, float* dsum, int G, int K,
              int L, int D, int NS, int TC, cudaStream_t s) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  T* yt = static_cast<T*>(y);
  switch (NS) {
    case 4: return forward<T, 4>(c(u), c(dl), c(Bm), c(Cm), A, Ds, bias, yt, hb, dsum, G, K, L, D, TC, s);
    case 8: return forward<T, 8>(c(u), c(dl), c(Bm), c(Cm), A, Ds, bias, yt, hb, dsum, G, K, L, D, TC, s);
    case 16: return forward<T, 16>(c(u), c(dl), c(Bm), c(Cm), A, Ds, bias, yt, hb, dsum, G, K, L, D, TC, s);
    case 32: return forward<T, 32>(c(u), c(dl), c(Bm), c(Cm), A, Ds, bias, yt, hb, dsum, G, K, L, D, TC, s);
    case 64: return forward<T, 64>(c(u), c(dl), c(Bm), c(Cm), A, Ds, bias, yt, hb, dsum, G, K, L, D, TC, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int backward_n(const void* u, const void* dl, const void* Bm, const void* Cm, const float* A,
               const float* Ds, const float* bias, const float* hb, const void* dy, void* gu,
               void* gdl, void* gB, void* gC, float* gA, float* gD, float* gbias, float* zl,
               float* dsum, float* gBp, float* gCp, float* gAp, float* gDp, float* gbp,
               int Bsz, int K, int L, int D, int NS, int TC, cudaStream_t s) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  auto m = [](void* p) { return static_cast<T*>(p); };
#define FD_BWD(NSV)                                                                        \
  backward<T, NSV>(c(u), c(dl), c(Bm), c(Cm), A, Ds, bias, hb, c(dy), m(gu), m(gdl), m(gB), \
                   m(gC), gA, gD, gbias, zl, dsum, gBp, gCp, gAp, gDp, gbp, Bsz, K, L, D, TC, s)
  switch (NS) {
    case 4: return FD_BWD(4);
    case 8: return FD_BWD(8);
    case 16: return FD_BWD(16);
    case 32: return FD_BWD(32);
    case 64: return FD_BWD(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FD_BWD
}

// ---------------------------------------------------------------------------
// fused-projection forward
// ---------------------------------------------------------------------------
// As fwd_chunk_kernel, with delta' (softplus applied), B and C read from the
// projection rows proj [G, L, D+2N] fp32; K = 4 directions.
template <typename T, int NS, bool FINAL>
__global__ void __launch_bounds__(FWD_THREADS)
fused_chunk_kernel(const T* __restrict__ u, const float* __restrict__ proj,
                   const float* __restrict__ A, const float* __restrict__ Ds,
                   T* __restrict__ y, float* __restrict__ hb, float* __restrict__ dsum, int L,
                   int D, int TC, int NC) {
  const int d = blockIdx.x * FWD_THREADS + threadIdx.x;
  const int c = blockIdx.y, g = blockIdx.z;
  if (d >= D) return;
  const int k = g & 3, NP = D + 2 * NS;
  float a[NS], h[NS];
  float* hbp = hb + ((long long)g * NC + c) * NS * D + d;  // [g, c, n, d]
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a[n] = A[((long long)k * D + d) * NS + n];
    h[n] = FINAL ? hbp[(long long)n * D] : 0.f;
  }
  const float dsk = FINAL ? Ds[k * D + d] : 0.f;
  float s = 0.f;
  const int l1 = min(L, (c + 1) * TC);
  for (int l = c * TC; l < l1; ++l) {
    const long long row = (long long)g * L + l;
    const float* pr = proj + row * NP;
    const float dlt = pr[d];
    const float uu = fd::to_f<T>(u[row * D + d]);
    const float du = dlt * uu;
    float yv = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      h[n] = expf(dlt * a[n]) * h[n] + du * pr[D + n];
      if (FINAL) yv = fmaf(pr[D + NS + n], h[n], yv);
    }
    if (FINAL) {
      y[row * D + d] = fd::from_f<T>(yv + dsk * uu);
    } else {
      s += dlt;
    }
  }
  if (!FINAL) {
#pragma unroll
    for (int n = 0; n < NS; ++n) hbp[(long long)n * D] = h[n];
    dsum[((long long)g * NC + c) * D + d] = s;
  }
}

template <typename T, int NS>
int fused_forward(const T* u, const T* wproj, const float* A, const float* Ds,
                  const float* bias, T* y, float* hb, float* proj, float* dsum, int G, int L,
                  int D, int TC, cudaStream_t s) {
  const int NP = D + 2 * NS, NC = (L + TC - 1) / TC;
  FD_TRY((fd::gemm<T>(G, L, NP, D, fd::RowStrided<T>{u, (long long)L * D, D}, wproj,
                      (long long)D * NP, 4, NP, fd::EpiProj{proj, bias, L, D, NP}, s)));
  dim3 grid((D + FWD_THREADS - 1) / FWD_THREADS, NC, G);
  fused_chunk_kernel<T, NS, false><<<grid, FWD_THREADS, 0, s>>>(u, proj, A, Ds, y, hb, dsum,
                                                                L, D, TC, NC);
  FD_TRY(cudaGetLastError());
  const long long total = (long long)G * NS * D;
  carry_kernel<false><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(A, dsum, hb, 4, D, NS,
                                                                      NC, total);
  FD_TRY(cudaGetLastError());
  fused_chunk_kernel<T, NS, true><<<grid, FWD_THREADS, 0, s>>>(u, proj, A, Ds, y, hb, dsum, L,
                                                               D, TC, NC);
  FD_TRY(cudaGetLastError());
  return 0;
}

template <typename T>
int fused_forward_n(const void* u, const void* wproj, const float* A, const float* Ds,
                    const float* bias, void* y, float* hb, float* proj, float* dsum, int G,
                    int L, int D, int NS, int TC, cudaStream_t s) {
  const T* ut = static_cast<const T*>(u);
  const T* wt = static_cast<const T*>(wproj);
  T* yt = static_cast<T*>(y);
  switch (NS) {
    case 4: return fused_forward<T, 4>(ut, wt, A, Ds, bias, yt, hb, proj, dsum, G, L, D, TC, s);
    case 8: return fused_forward<T, 8>(ut, wt, A, Ds, bias, yt, hb, proj, dsum, G, L, D, TC, s);
    case 16: return fused_forward<T, 16>(ut, wt, A, Ds, bias, yt, hb, proj, dsum, G, L, D, TC, s);
    case 32: return fused_forward<T, 32>(ut, wt, A, Ds, bias, yt, hb, proj, dsum, G, L, D, TC, s);
    case 64: return fused_forward<T, 64>(ut, wt, A, Ds, bias, yt, hb, proj, dsum, G, L, D, TC, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// u, dl [G, L, D], Bm, Cm [G, L, N] at the io dtype (G = Bsz * K, direction
// g % K); A [K, D, N], Ds and bias [K, D] fp32.  Writes y [G, L, D] (io) and
// hb [G, NC, N, D] fp32, the state entering each chunk of TC steps.
// Scratch: dsum [G, NC, D] fp32.
extern "C" int scan_forward(const void* u, const void* dl, const void* Bm, const void* Cm,
                            const float* A, const float* Ds, const float* bias, void* y,
                            float* hb, float* dsum, int G, int K, int L, int D, int NS, int TC,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward_n<float>(u, dl, Bm, Cm, A, Ds, bias, y, hb, dsum, G, K, L, D, NS, TC, s);
  if (dtype == 1)
    return forward_n<__nv_bfloat16>(u, dl, Bm, Cm, A, Ds, bias, y, hb, dsum, G, K, L, D, NS,
                                    TC, s);
  return (int)cudaErrorInvalidValue;
}

// The forward's inputs, its hb and dy [G, L, D] (io).  Writes gu, gdl
// [G, L, D] and gB, gC [G, L, N] at the io dtype; gA [K, D, N], gD and gbias
// [K, D] fp32.  Scratch (fp32): zl [G, NC, N, D], dsum [G, NC, D],
// gBp and gCp [G, L, N, ceil(D / 32)], gAp [G, NC, N, D], gDp and gbp [G, NC, D].
extern "C" int scan_backward(const void* u, const void* dl, const void* Bm, const void* Cm,
                             const float* A, const float* Ds, const float* bias,
                             const float* hb, const void* dy, void* gu, void* gdl, void* gB,
                             void* gC, float* gA, float* gD, float* gbias, float* zl,
                             float* dsum, float* gBp, float* gCp, float* gAp, float* gDp,
                             float* gbp, int Bsz, int K, int L, int D, int NS, int TC, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward_n<float>(u, dl, Bm, Cm, A, Ds, bias, hb, dy, gu, gdl, gB, gC, gA, gD,
                             gbias, zl, dsum, gBp, gCp, gAp, gDp, gbp, Bsz, K, L, D, NS, TC, s);
  if (dtype == 1)
    return backward_n<__nv_bfloat16>(u, dl, Bm, Cm, A, Ds, bias, hb, dy, gu, gdl, gB, gC, gA,
                                     gD, gbias, zl, dsum, gBp, gCp, gAp, gDp, gbp, Bsz, K, L,
                                     D, NS, TC, s);
  return (int)cudaErrorInvalidValue;
}

// xs [G, L, D] (G = Bsz * 4, direction g % 4) and wproj [4, D, D+2N]
// (delta | B | C) at the io dtype; A [4, D, N], Ds and bias [4, D] fp32.
// Writes y [G, L, D] (io) and hb [G, NC, N, D] fp32 as scan_forward does.
// Scratch (fp32): proj [G, L, D+2N], dsum [G, NC, D].
extern "C" int scan_fused_forward(const void* xs, const void* wproj, const float* A,
                                  const float* Ds, const float* bias, void* y, float* hb,
                                  float* proj, float* dsum, int G, int L, int D, int NS, int TC,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fused_forward_n<float>(xs, wproj, A, Ds, bias, y, hb, proj, dsum, G, L, D, NS, TC,
                                  s);
  if (dtype == 1)
    return fused_forward_n<__nv_bfloat16>(xs, wproj, A, Ds, bias, y, hb, proj, dsum, G, L, D,
                                          NS, TC, s);
  return (int)cudaErrorInvalidValue;
}
