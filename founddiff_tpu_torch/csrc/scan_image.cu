// Image-direct selective scan: the four step-2 decimated direction scans
// of an NHWC image, with the delta/B/C projections inside, written as
// [B, 4, L, D] direction sequences at the io dtype.
//
// Replaces the TPU kernel _scan_kernel_image (founddiff_tpu/ops/scan_pallas.py:895,
// pallas_call :1005 in _image_call, through _scan_image :1032), the forward of
// the scan that the SS2D block's backward rematerialises at the shallow UNet
// scales (ops/ss2d_block.py:489-496).
//
// Bound on the H100: the bytes of xs and ys (read and written once) against
// the projections and the scan's fp32 operations (about 6 N D per step).
// The delta projection is folded into one [D, D] matrix as on the TPU
// (scan_pallas.py:1129-1134), 6x to 8.5x the multiply-adds of its rank-R
// factors.  The first port ran that product on the fp32 CUDA cores in both
// dtypes (half of the kernel's time in an fp32 train step), a chunk pass
// of one thread per channel reading B and C from device memory at every
// step, and a carry serial over the chunks (512 dependent steps at 512^2).
//
// Design, on the caller's stream:
//   1. the projection product on the tensor cores (fd::gemm_mma: bf16
//      mma, fp32 as three TF32 products, which hold the fp32 tolerance),
//      A rows gathered from the image in direction order, softplus(delta +
//      bias) in its epilogue (fast exponential and logarithm, to about
//      4e-6 of the value); the fp32 projections [B*4, L, D+2N] pass
//      through device memory once (written once, read by both chunk passes:
//      computing them inside each pass would double the product, the
//      larger cost in fp32);
//   2. pass 1 (bounds only): per (direction, chunk, 128 channels) block, the
//      chunk from a zero state, writing only what the carry needs: the end
//      state and the sum of delta';
//   3. the parallel carry of scan.cu (fd::carry_scan_kernel: segments of
//      chunks per warp, composed associatively, the loads of 8 chunks in
//      flight), on the state layout [z, chunk, n, d] it shares with it;
//   4. pass 2: the chunk again from its entry state, y = C.h + D*u rounded
//      to the io dtype.
// In both passes the chunk's B (and C) rows are copied into shared memory
// once per block and delta' and the gathered u rows move in sub-tiles of 16
// steps by 16-byte cp.async, the next sub-tile in flight while the steps
// read the current one.  A chunk is 1024 / N steps (32 to 256), so its B
// and C rows take at most 16 KB.  A thread holds the N (up to 64) states
// of its channel in registers; N above 64 runs in groups of 64 whose y
// meet in an fp32 buffer in order (D*u with the first), one carry over all.
// The TPU kernel's Hillis-Steele tiles and 128-lane padding are Mosaic
// constraints and are not ported.
#include "scan_common.cuh"

namespace {

constexpr int DT = 128;  // channels of a block, one thread each
constexpr int TS = 16;   // steps of one staged sub-tile
constexpr int GROUP = 64;

// One chunk of one direction for DT channels, states [n0, n0 + NS) of NST.
// Pass 1 (!FINAL): from a zero state; writes the end state into hb [z, c,
// n, d] and sum delta' into dsum [z, c, d] (group 0).  Pass 2: from the
// entry state in hb; y by mode: 0 ys = io(C.h + Ds u); 1 yacc = C.h + Ds u;
// 2 yacc += C.h; 3 ys = io(yacc + C.h).  Shared memory: B (and C) [TC][NS]
// fp32, then two sub-tiles of delta' (fp32) and u (io).
template <typename T, int NS, bool FINAL, bool GROUPED>
__global__ void __launch_bounds__(DT)
chunk_kernel(const T* __restrict__ xs, const float* __restrict__ proj,
             const float* __restrict__ A, const float* __restrict__ Dskip,
             float* __restrict__ hb, float* __restrict__ dsum, T* __restrict__ ys,
             float* __restrict__ yacc, int mode, int H, int W, int D, int L, int NST, int n0,
             int TC, int NC) {
  if (!GROUPED) NST = NS, n0 = 0, mode = 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sB = reinterpret_cast<float*>(smem_raw);
  float* sC = sB + TC * NS;
  float* sd = sC + (FINAL ? TC * NS : 0);  // [2][TS][DT]
  T* su = reinterpret_cast<T*>(sd + 2 * TS * DT);  // [2][TS][DT]
  const int tid = threadIdx.x;
  const int z = blockIdx.x, c = blockIdx.y, d0 = blockIdx.z * DT;
  const int b = z >> 2, k = z & 3, H2 = H / 2, W2 = W / 2, NP = D + 2 * NST;
  const int cols = min(DT, D - d0);
  const bool on = tid < cols;
  const int d = on ? d0 + tid : d0 + cols - 1;  // threads past D run a valid channel
  const int cs = d - d0;
  const int l0 = c * TC, nt = min(L, l0 + TC) - l0;
  const float* pr = proj + ((long long)z * L + l0) * NP;
  fd::stage_tile(sB, pr + D + n0, NP, nt, NS, NS, tid, DT);
  if (FINAL) fd::stage_tile(sC, pr + D + NST + n0, NP, nt, NS, NS, tid, DT);
  constexpr int V = 16 / sizeof(T);
  const bool uvec = D % V == 0 && (reinterpret_cast<uintptr_t>(xs) & 15) == 0;
  auto issue = [&](int sb) {
    const int r0 = sb * TS, rows = min(TS, nt - r0);
    float* dd = sd + (sb & 1) * TS * DT;
    T* du = su + (sb & 1) * TS * DT;
    fd::stage_tile(dd, pr + (long long)r0 * NP + d0, NP, rows, cols, DT, tid, DT);
    // u: row r is the pixel of step l0 + r0 + r of direction k
    const int per = uvec ? (cols + V - 1) / V : cols;
    for (int i = tid; i < rows * per; i += DT) {
      const int r = i / per, e = (i - r * per) * (uvec ? V : 1);
      int py, px;
      fd::dir_pixel(k, l0 + r0 + r, H2, W2, py, px);
      const T* src = xs + (((long long)b * H + py) * W + px) * D + d0 + e;
      if (uvec) fd::cp_async16(du + r * DT + e, src, min(V, cols - e) * (int)sizeof(T));
      else du[r * DT + e] = *src;
    }
  };
  const int nsub = (nt + TS - 1) / TS;
  issue(0);
  fd::cp_async_commit();

  float a[NS], h[NS];
  float* st = hb + ((long long)z * NC + c) * NST * D + (long long)n0 * D + d;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a[n] = A[((long long)k * D + d) * NST + n0 + n];
    h[n] = FINAL ? st[(long long)n * D] : 0.f;
  }
  const float dsk = FINAL ? Dskip[k * D + d] : 0.f;
  float dsm = 0.f;
  for (int sb = 0; sb < nsub; ++sb) {
    if (sb + 1 < nsub) issue(sb + 1);
    fd::cp_async_commit();
    fd::cp_async_wait<1>();
    __syncthreads();
    const float* dd = sd + (sb & 1) * TS * DT;
    const T* du = su + (sb & 1) * TS * DT;
    const int rows = min(TS, nt - sb * TS);
    for (int r = 0; r < rows; ++r) {
      const int t = sb * TS + r;
      const float dl = dd[r * DT + cs];
      const float u = fd::to_f<T>(du[r * DT + cs]);
      const float dlu = dl * u;
      const float* Bt = sB + t * NS;
      const float* Ct = sC + t * NS;
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        h[n] = expf(dl * a[n]) * h[n] + dlu * Bt[n];
        if (FINAL) y = fmaf(Ct[n], h[n], y);
      }
      if (FINAL) {
        if (on) {
          const long long i = ((long long)z * L + l0 + t) * D + d;
          if (mode == 0) ys[i] = fd::from_f<T>(y + dsk * u);
          else if (mode == 1) yacc[i] = y + dsk * u;
          else if (mode == 2) yacc[i] = yacc[i] + y;
          else ys[i] = fd::from_f<T>(yacc[i] + y);
        }
      } else {
        dsm += dl;
      }
    }
    __syncthreads();  // sub-tile sb's buffer is refilled by the next issue
  }
  if (!FINAL && on) {
#pragma unroll
    for (int n = 0; n < NS; ++n) st[(long long)n * D] = h[n];
    if (n0 == 0) dsum[((long long)z * NC + c) * D + d] = dsm;
  }
}

// The two chunk passes and the carry for NST states in groups of NS.
template <typename T, int NS>
int scan_passes(const T* xs, const float* proj, const float* A, const float* Ds, float* hb,
                float* dsum, T* ys, float* yacc, int B, int H, int W, int D, int NST, int L,
                int TC, cudaStream_t s) {
  const int NC = (L + TC - 1) / TC, G = B * 4, ngroups = NST / NS;
  const dim3 grid(G, NC, (D + DT - 1) / DT);
  auto pass = [&](auto final_pass, int i, int mode) {
    constexpr bool FINAL = decltype(final_pass)::value;
    const size_t smem = (FINAL ? 2 : 1) * (size_t)TC * NS * 4 + 2 * TS * DT * (4 + sizeof(T));
    if constexpr (NS == GROUP) {
      if (ngroups > 1)
        return fd::launch(chunk_kernel<T, NS, FINAL, true>, grid, DT, smem, s, xs, proj, A, Ds,
                          hb, dsum, ys, yacc, mode, H, W, D, L, NST, i * NS, TC, NC);
    }
    return fd::launch(chunk_kernel<T, NS, FINAL, false>, grid, DT, smem, s, xs, proj, A, Ds, hb,
                      dsum, ys, yacc, mode, H, W, D, L, NST, i * NS, TC, NC);
  };
  for (int i = 0; i < ngroups; ++i)
    if (int rc = pass(std::false_type{}, i, 0)) return rc;
  FD_TRY(fd::carry_scan<false>(A, dsum, hb, 4, D, NST, NC, G, s));
  for (int i = 0; i < ngroups; ++i) {
    const int mode = ngroups == 1 ? 0 : i == 0 ? 1 : i == ngroups - 1 ? 3 : 2;
    if (int rc = pass(std::true_type{}, i, mode)) return rc;
  }
  return 0;
}

// softplus to about 4e-6 of its value (fp32): the fast exponential and
// logarithm where log1p(e) >= 0.095 (there __logf errs by 2^-21.4 at
// most), below that log1p's series to e^8.  The fused blocks' EpiProj keeps
// the library softplus, and its bits.
__device__ __forceinline__ float softplus_fast(float v) {
  const float e = __expf(-fabsf(v));
  float l;
  if (e < 0.1f) {
    l = 1.f / 8;
#pragma unroll
    for (int i = 7; i >= 1; --i) l = fmaf(l, -e, 1.f / i);
    l *= e;
  } else {
    l = __logf(1.f + e);
  }
  return fmaxf(v, 0.f) + l;
}

struct EpiProjFast {  // delta = softplus(acc + bias) | B | C, fp32
  float* out;
  const float* dbias;
  int L, D, NP;
  __device__ __forceinline__ void operator()(int z, int l, int n, float acc) const {
    float v = acc;
    if (n < D) v = softplus_fast(v + dbias[(z & 3) * D + n]);
    out[((long long)z * L + l) * NP + n] = v;
  }
};

template <typename T>
int run(const void* xs_, const void* wproj_, const float* A, const float* Ds,
        const float* dbias, void* ys_, float* proj, float* hb, float* dsum, float* yacc, int B,
        int H, int W, int D, int NS, int TC, cudaStream_t s) {
  const T* xs = static_cast<const T*>(xs_);
  const T* wproj = static_cast<const T*>(wproj_);
  T* ys = static_cast<T*>(ys_);
  const int H2 = H / 2, W2 = W / 2, L = H2 * W2, NP = D + 2 * NS;
  FD_TRY((fd::gemm_mma<T>(B * 4, L, NP, D, fd::RowGather<T>{xs, H, W, H2, W2, D}, D, xs, wproj,
                          (long long)D * NP, 4, NP, EpiProjFast{proj, dbias, L, D, NP}, s)));
#define FD_PASSES(NSV) \
  scan_passes<T, NSV>(xs, proj, A, Ds, hb, dsum, ys, yacc, B, H, W, D, NS, L, TC, s)
  switch (NS) {
    case 4: return FD_PASSES(4);
    case 8: return FD_PASSES(8);
    case 16: return FD_PASSES(16);
    case 32: return FD_PASSES(32);
    default:
      if (NS % GROUP || (NS > GROUP && yacc == nullptr)) return (int)cudaErrorInvalidValue;
      return FD_PASSES(64);
  }
#undef FD_PASSES
}

}  // namespace

// xs [B, H, W, D] and wproj [4, D, D+2N] (delta | B | C) at the io dtype;
// A [4, D, N], Ds and dbias [4, D] fp32; ys [B, 4, L, D] at the io dtype;
// N in {4, 8, 16, 32} or a multiple of 64 (the wrapper pads other sizes);
// TC steps a chunk.  Scratch, fp32: proj [B*4*L*(D+2N)], hb [B*4*NC*N*D],
// dsum [B*4*NC*D], and for N > 64 yacc [B*4*L*D] (else unused).
extern "C" int scan_image_forward(const void* xs, const void* wproj, const float* A,
                                  const float* Ds, const float* dbias, void* ys, float* proj,
                                  float* hb, float* dsum, float* yacc, int B, int H, int W,
                                  int D, int NS, int TC, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(xs, wproj, A, Ds, dbias, ys, proj, hb, dsum, yacc, B, H, W, D, NS, TC, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(xs, wproj, A, Ds, dbias, ys, proj, hb, dsum, yacc, B, H, W, D, NS,
                              TC, s);
  return (int)cudaErrorInvalidValue;
}
