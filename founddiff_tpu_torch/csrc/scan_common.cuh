// Device code shared by the selective scans (scan.cu, scan_image.cu,
// ss2d_tail.cuh): the pixel map of the four step-2 decimated directions,
// the projection GEMM's row gather and epilogues, the three-pass chunked
// image scan of the fused blocks, the operand staging and parallel carry
// of the runtime-N scans, and the staged chunk passes that scan_image.cu
// and scan.cu's fused-projection forward share (chunk_passes_n below).
//
// The fused blocks' image scan (image_scan below) cuts each direction's L
// steps into chunks of TC steps:
//   1. pass 1: one thread per (direction, chunk, channel) runs the
//      recurrence from a zero state with all N states in registers and keeps
//      the chunk's end state and its sum of delta (so the chunk's decay is
//      exp(A * sum), never a positive exponent);
//   2. carry: one thread per (direction, channel, state) walks the chunks
//      and turns end states into entry states;
//   3. pass 2: each chunk reruns from its entry state and hands
//      y = C.h + D*u to an output functor.
// N is a template argument, 4, 8, 16, 32 or 64 (the wrappers pad other
// sizes up with states whose B and C are zero); N above 64, a multiple of
// 64, runs the chunk passes in groups of 64 states with one carry over all:
// the groups' y add up in an fp32 buffer in order (D*u with the first), and
// the last hands the sum to the output functor.
#pragma once

#include "common.cuh"

namespace fd {

constexpr int SCAN_THREADS = 128;

// pixel (py, px) of step l of direction k (efficient_scan order)
__device__ __forceinline__ void dir_pixel(int k, int l, int H2, int W2, int& py, int& px) {
  if (k == 0 || k == 2) {
    py = 2 * (l / W2);
    px = 2 * (l % W2) + (k == 2);
  } else {
    py = 2 * (l % H2) + 1;
    px = 2 * (l / H2) + (k == 3);
  }
}

// SILU: the GEMMs of common.cuh take each element through silu_io (the
// fused block's FOUNDDIFF_SILU=kernel input); the chunk passes do not.
template <typename T, bool SILU_ = false>
struct RowGather {  // A rows of the projection GEMM: xs pixels in direction order
  static constexpr bool SILU = SILU_;
  const T* xs;
  int H, W, H2, W2, D;
  __device__ __forceinline__ const T* operator()(int z, int l) const {
    int py, px;
    dir_pixel(z & 3, l, H2, W2, py, px);
    return xs + (((long long)(z >> 2) * H + py) * W + px) * D;
  }
};

struct EpiProj {  // delta = softplus(acc + bias) | B | C, fp32
  float* out;
  const float* dbias;
  int L, D, NP;
  __device__ __forceinline__ void operator()(int z, int l, int n, float acc) const {
    float v = acc;
    if (n < D) v = softplus(v + dbias[(z & 3) * D + n]);
    out[((long long)z * L + l) * NP + n] = v;
  }
};

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

struct EpiProjFast {  // EpiProj with softplus_fast (scan_image.cu, scan.cu)
  float* out;
  const float* dbias;
  int L, D, NP;
  __device__ __forceinline__ void operator()(int z, int l, int n, float acc) const {
    float v = acc;
    if (n < D) v = softplus_fast(v + dbias[(z & 3) * D + n]);
    out[((long long)z * L + l) * NP + n] = v;
  }
};

// y into its pixel of the merged [B, H, W, D] fp32 map (EfficientMerge)
struct StoreMerged {
  float* y;
  __device__ __forceinline__ void operator()(int, int, long long pix, int d, int D,
                                             float v) const {
    y[pix * D + d] = v;
  }
};

// y into [B, 4, L, D] direction sequences at the io dtype
template <typename T>
struct StoreSeq {
  T* ys;
  int L;
  __device__ __forceinline__ void operator()(int z, int l, long long, int d, int D,
                                             float v) const {
    ys[((long long)z * L + l) * D + d] = from_f<T>(v);
  }
};

// GROUPED: states [n0, n0 + NS) of NST, y by mode: 0 out(y); 1 yacc = y;
// 2 yacc += C.h; 3 out(yacc + C.h) (y = C.h + D*u).  Otherwise NST = NS, one
// group, its strides known at compile time.  SILU: u = silu_io(xs) (the
// projection GEMM's A rows take the same).
template <typename T, int NS, bool FINAL, class Out, bool GROUPED, bool SILU = false>
__global__ void __launch_bounds__(SCAN_THREADS)
image_scan_chunk_kernel(const T* __restrict__ xs, const float* __restrict__ proj,
                        const float* __restrict__ A, const float* __restrict__ Dskip,
                        float* __restrict__ chunk_sum, float* __restrict__ chunk_state,
                        Out out, float* __restrict__ yacc, int mode, int H, int W, int D,
                        int L, int NST, int n0, int TC, int NC) {
  if (!GROUPED) NST = NS, n0 = 0, mode = 0;
  const int d = blockIdx.x * SCAN_THREADS + threadIdx.x;
  const int c = blockIdx.y, z = blockIdx.z;
  if (d >= D) return;
  const int b = z >> 2, k = z & 3;
  const int H2 = H / 2, W2 = W / 2, NP = D + 2 * NST;
  float a[NS], h[NS];
  float* st = chunk_state + (((long long)z * NC + c) * D + d) * NST + n0;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a[n] = A[((long long)k * D + d) * NST + n0 + n];
    h[n] = FINAL ? st[n] : 0.f;
  }
  const float dsk = FINAL ? Dskip[k * D + d] : 0.f;
  float dsum = 0.f;
  const int l1 = min(L, (c + 1) * TC);
  for (int l = c * TC; l < l1; ++l) {
    int py, px;
    dir_pixel(k, l, H2, W2, py, px);
    const long long pix = ((long long)b * H + py) * W + px;
    const float* pr = proj + ((long long)z * L + l) * NP;
    const float dl = pr[d];
    float u = to_f<T>(xs[pix * D + d]);
    if constexpr (SILU) u = silu_io<T>(u);
    const float du = dl * u;
    float y = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      h[n] = expf(dl * a[n]) * h[n] + du * pr[D + n0 + n];
      if (FINAL) y = fmaf(pr[D + NST + n0 + n], h[n], y);
    }
    if (FINAL) {
      const long long i = ((long long)z * L + l) * D + d;
      if (mode == 0) out(z, l, pix, d, D, y + dsk * u);
      else if (mode == 1) yacc[i] = y + dsk * u;
      else if (mode == 2) yacc[i] = yacc[i] + y;
      else out(z, l, pix, d, D, yacc[i] + y);
    } else {
      dsum += dl;
    }
  }
  if (!FINAL) {
#pragma unroll
    for (int n = 0; n < NS; ++n) st[n] = h[n];
    chunk_sum[((long long)z * NC + c) * D + d] = dsum;
  }
}

// end states -> entry states, one thread per (z, d, n); state layout [z, c, d, n]
__global__ void image_scan_carry_kernel(const float* __restrict__ A,
                                        const float* __restrict__ chunk_sum,
                                        float* __restrict__ chunk_state, int D, int NS,
                                        int NC, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = idx % NS;
  const int d = (idx / NS) % D;
  const long long z = idx / ((long long)NS * D);
  const float a = A[((z & 3) * D + d) * NS + n];
  float carry = 0.f;
  for (int c = 0; c < NC; ++c) {
    const long long si = (z * NC + c) * D + d;
    const float hend = chunk_state[si * NS + n];
    chunk_state[si * NS + n] = carry;
    carry = expf(a * chunk_sum[si]) * carry + hend;
  }
}

// ---------------------------------------------------------------------------
// Pieces of the chunked scans with the states at run time (scan.cu) and of
// the image scan's chunk passes (scan_image.cu).
// ---------------------------------------------------------------------------
constexpr int CARRY_LANES = 32;  // channels of one carry_scan_kernel block
constexpr int CARRY_WARPS = 16;  // chunk segments of carry_scan_kernel
constexpr int CARRY_BATCH = 8;   // chunks whose loads carry_scan_kernel issues at once

// rows x [0, cols) of src (row stride ld elements) into dst [rows][ldd]:
// 16-byte cp.async where src rows are 16-byte aligned (a ragged end copies
// fewer bytes), element copies elsewhere.  The caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ld, int rows,
                                           int cols, int ldd, int tid, int nthr) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | (uintptr_t)(ld * sizeof(T))) & 15) == 0;
  if (vec) {
    const int per = (cols + V - 1) / V;
    for (int i = tid; i < rows * per; i += nthr) {
      const int r = i / per, c = (i - r * per) * V;
      cp_async16(dst + (long long)r * ldd + c, src + r * ld + c,
                 min(V, cols - c) * (int)sizeof(T));
    }
  } else {
    for (int i = tid; i < rows * cols; i += nthr) {
      const int r = i / cols, c = i - r * cols;
      dst[(long long)r * ldd + c] = src[r * ld + c];
    }
  }
}

// Chunk summaries -> chunk carries, per (g, n, d); st [G, NC, N, D].
// Forward: st holds end states and becomes entry states (left to right).
// Backward: st holds abar_first * gh_first from a zero carry and becomes the
// carry entering each chunk at its last step (right to left).  Block: 32
// channels x WARPS segments of chunks (CARRY_WARPS; the fused-projection
// forward takes 4 where it has at most 32 chunks, so that its blocks do
// not idle).  last (forward only, may be null): the carry one chunk past the
// last, the state after step L, written by the segment that ends at NC into
// [G, D, N].  (scan.cu, scan_image.cu)
template <bool REVERSE, int WARPS = CARRY_WARPS>
__global__ void __launch_bounds__(CARRY_LANES * WARPS)
carry_scan_kernel(const float* __restrict__ A, const float* __restrict__ dsum,
                  float* __restrict__ st, float* __restrict__ last, int K, int D, int N,
                  int NC) {
  __shared__ float seg_b[WARPS][CARRY_LANES], seg_s[WARPS][CARRY_LANES];
  const int lane = threadIdx.x & (CARRY_LANES - 1), w = threadIdx.x / CARRY_LANES;
  const int d = blockIdx.x * CARRY_LANES + lane, n = blockIdx.y;
  const long long g = blockIdx.z;
  const bool on = d < D;
  const int dd = on ? d : D - 1;
  const float a = A[((g % K) * D + dd) * N + n];
  const int S = (NC + WARPS - 1) / WARPS;
  const int i0 = min(NC, w * S), i1 = min(NC, i0 + S);
  auto sidx = [&](int i) {
    const int c = REVERSE ? NC - 1 - i : i;
    return ((g * NC + c) * N + n) * D + dd;
  };
  auto didx = [&](int i) { return (g * NC + (REVERSE ? NC - 1 - i : i)) * D + dd; };
  // CARRY_BATCH chunks' loads issued before their dependent steps
  float v[CARRY_BATCH], ds[CARRY_BATCH];
  auto load = [&](int i) {
#pragma unroll
    for (int k = 0; k < CARRY_BATCH; ++k) {
      v[k] = i + k < i1 ? st[sidx(i + k)] : 0.f;
      ds[k] = i + k < i1 ? dsum[didx(i + k)] : 0.f;
    }
  };
  float b = 0.f, s = 0.f;
  for (int i = i0; i < i1; i += CARRY_BATCH) {
    load(i);
#pragma unroll
    for (int k = 0; k < CARRY_BATCH; ++k) {
      if (i + k < i1) {
        b = expf(a * ds[k]) * b + v[k];
        s += ds[k];
      }
    }
  }
  seg_b[w][lane] = b;
  seg_s[w][lane] = s;
  __syncthreads();
  if (w == 0) {  // the segments' entries, in order
    float carry = 0.f;
    for (int j = 0; j < WARPS; ++j) {
      const float bj = seg_b[j][lane], sj = seg_s[j][lane];
      seg_b[j][lane] = carry;
      carry = expf(a * sj) * carry + bj;
    }
  }
  __syncthreads();
  float carry = seg_b[w][lane];
  for (int i = i0; i < i1; i += CARRY_BATCH) {
    load(i);
#pragma unroll
    for (int k = 0; k < CARRY_BATCH; ++k) {
      if (i + k < i1) {
        if (on) st[sidx(i + k)] = carry;
        carry = expf(a * ds[k]) * carry + v[k];
      }
    }
  }
  if (last != nullptr && on && i0 < i1 && i1 == NC) last[(g * D + d) * N + n] = carry;
}

template <bool REVERSE, int WARPS = CARRY_WARPS>
cudaError_t carry_scan(const float* A, const float* dsum, float* st, int K, int D, int N, int NC,
                       int G, cudaStream_t s, float* last = nullptr) {
  const dim3 grid((D + CARRY_LANES - 1) / CARRY_LANES, N, G);
  carry_scan_kernel<REVERSE, WARPS><<<grid, CARRY_LANES * WARPS, 0, s>>>(A, dsum, st, last, K,
                                                                          D, N, NC);
  return cudaGetLastError();
}

// The three passes on the caller's stream for NST states in groups of NS;
// proj is [B*4, L, D+2N] from the RowGather/EpiProj GEMM, csum [B*4, NC, D],
// cstate [B*4, NC, D, N], yacc [B*4, L, D] fp32 (several groups only);
// SILU: the passes read silu_io(xs).
template <typename T, int NS, class Out, bool SILU = false>
int image_scan(const T* xs, const float* proj, const float* A, const float* Ds, float* csum,
               float* cstate, Out out, float* yacc, int B, int H, int W, int D, int NST, int L,
               int TC, int NC, cudaStream_t s) {
  dim3 grid((D + SCAN_THREADS - 1) / SCAN_THREADS, NC, B * 4);
  const int ngroups = NST / NS;
  auto pass = [&](auto final_pass, int i, int mode) {
    constexpr bool FINAL = decltype(final_pass)::value;
    if constexpr (NS == 64) {
      if (ngroups > 1) {
        image_scan_chunk_kernel<T, NS, FINAL, Out, true, SILU><<<grid, SCAN_THREADS, 0, s>>>(
            xs, proj, A, Ds, csum, cstate, out, yacc, mode, H, W, D, L, NST, i * NS, TC, NC);
        return cudaGetLastError();
      }
    }
    image_scan_chunk_kernel<T, NS, FINAL, Out, false, SILU><<<grid, SCAN_THREADS, 0, s>>>(
        xs, proj, A, Ds, csum, cstate, out, yacc, mode, H, W, D, L, NST, i * NS, TC, NC);
    return cudaGetLastError();
  };
  for (int i = 0; i < ngroups; ++i) FD_TRY(pass(std::false_type{}, i, 0));
  const long long total = (long long)B * 4 * D * NST;
  image_scan_carry_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(A, csum, cstate, D,
                                                                         NST, NC, total);
  FD_TRY(cudaGetLastError());
  for (int i = 0; i < ngroups; ++i)
    FD_TRY(pass(std::true_type{}, i, ngroups == 1 ? 0 : i == 0 ? 1 : i == ngroups - 1 ? 3 : 2));
  return 0;
}

// image_scan for a runtime state size: 4, 8, 16, 32, 64, or a multiple of
// 64 with yacc
template <typename T, class Out, bool SILU = false>
int image_scan_n(const T* xs, const float* proj, const float* A, const float* Ds, float* csum,
                 float* cstate, Out out, float* yacc, int B, int H, int W, int D, int NS, int L,
                 int TC, int NC, cudaStream_t s) {
#define FD_IMAGE_SCAN(NSV) \
  image_scan<T, NSV, Out, SILU>(xs, proj, A, Ds, csum, cstate, out, yacc, B, H, W, D, NS, L, \
                                TC, NC, s)
  switch (NS) {
    case 4: return FD_IMAGE_SCAN(4);
    case 8: return FD_IMAGE_SCAN(8);
    case 16: return FD_IMAGE_SCAN(16);
    case 32: return FD_IMAGE_SCAN(32);
    default:
      if (NS % 64 || (NS > 64 && yacc == nullptr)) return (int)cudaErrorInvalidValue;
      return FD_IMAGE_SCAN(64);
  }
#undef FD_IMAGE_SCAN
}

// ---------------------------------------------------------------------------
// The staged chunk passes of scan_image.cu and of scan.cu's fused-projection
// forward: per (sequence z, chunk c of TC steps, PASS_DT channels) block,
//   pass 1 (!FINAL): the chunk from a zero state, writing only what the
//     carry needs: the end state into hs [z, c, n, d] and sum delta' into
//     dsum [z, c, d] (group 0);
//   the carry (carry_scan_kernel) turns hs into entry states;
//   pass 2 (FINAL): the chunk again from its entry state, y = C.h + D*u at
//     the io dtype into ys [z, l, d]; with BOUNDS also the state entering
//     every TCB-step chunk into hb [z, l / TCB, n, d] (TC % TCB == 0), the
//     h_bounds of a backward whose chunk is shorter than the passes'.
// Step l of sequence z reads its u row at rows(z, l) (RowGather: pixels of
// an NHWC image in direction order; RowStrided: a [G, L, D] sequence) and
// its delta' | B | C row from proj [z, l, D+2NST] fp32 (the projection
// GEMM's EpiProjFast).  The chunk's B (and C) rows are copied into shared
// memory once per block, delta' and the u rows move in sub-tiles of
// PASS_TS steps by 16-byte cp.async, the next sub-tile in flight while the
// steps read the current one.  A thread holds the NS (up to 64) states of
// its channel in registers; NST above 64 runs in groups of NS = 64 (GROUPED)
// whose y meet in the fp32 yacc [z, l, d] in order by mode: 0 ys = io(C.h +
// Ds u); 1 yacc = C.h + Ds u; 2 yacc += C.h; 3 ys = io(yacc + C.h).
// EXP2: the decay exp(delta' A) as exp2f(delta' (A log2 e)) (scan.cu: the
// hardware's base-2 exponential without expf's range reduction, to about 2
// ulp); scan_image.cu keeps expf and its bits.
// ---------------------------------------------------------------------------
constexpr int PASS_DT = 128;  // channels of a block, one thread each
constexpr int PASS_TS = 16;   // steps of one staged sub-tile
constexpr int PASS_GROUP = 64;

template <typename T, int NS, bool FINAL, bool GROUPED, bool BOUNDS, bool EXP2, class Rows>
__global__ void __launch_bounds__(PASS_DT)
chunk_pass_kernel(Rows rows, const float* __restrict__ proj, const float* __restrict__ A,
                  const float* __restrict__ Dskip, float* __restrict__ hs,
                  float* __restrict__ dsum, T* __restrict__ ys, float* __restrict__ yacc,
                  float* __restrict__ hb, int mode, int D, int L, int NST, int n0, int TC,
                  int NC, int TCB, int NCB) {
  static_assert(!RowSilu<Rows>::value, "the chunk passes take u rows as they are");
  if (!GROUPED) NST = NS, n0 = 0, mode = 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sB = reinterpret_cast<float*>(smem_raw);
  float* sC = sB + TC * NS;
  float* sd = sC + (FINAL ? TC * NS : 0);  // [2][PASS_TS][PASS_DT]
  T* su = reinterpret_cast<T*>(sd + 2 * PASS_TS * PASS_DT);  // [2][PASS_TS][PASS_DT]
  const int tid = threadIdx.x;
  const int z = blockIdx.x, c = blockIdx.y, d0 = blockIdx.z * PASS_DT;
  const int k = z & 3, NP = D + 2 * NST;
  const int cols = min(PASS_DT, D - d0);
  const bool on = tid < cols;
  const int d = on ? d0 + tid : d0 + cols - 1;  // threads past D run a valid channel
  const int cs = d - d0;
  const int l0 = c * TC, nt = min(L, l0 + TC) - l0;
  const float* pr = proj + ((long long)z * L + l0) * NP;
  stage_tile(sB, pr + D + n0, NP, nt, NS, NS, tid, PASS_DT);
  if (FINAL) stage_tile(sC, pr + D + NST + n0, NP, nt, NS, NS, tid, PASS_DT);
  constexpr int V = 16 / sizeof(T);
  const bool uvec = D % V == 0 && (reinterpret_cast<uintptr_t>(rows(0, 0)) & 15) == 0;
  auto prefetch = [&](int sb) {
    const int r0 = sb * PASS_TS, rows_n = min(PASS_TS, nt - r0);
    float* dd = sd + (sb & 1) * PASS_TS * PASS_DT;
    T* du = su + (sb & 1) * PASS_TS * PASS_DT;
    stage_tile(dd, pr + (long long)r0 * NP + d0, NP, rows_n, cols, PASS_DT, tid, PASS_DT);
    const int per = uvec ? (cols + V - 1) / V : cols;
    for (int i = tid; i < rows_n * per; i += PASS_DT) {
      const int r = i / per, e = (i - r * per) * (uvec ? V : 1);
      const T* src = rows(z, l0 + r0 + r) + d0 + e;
      if (uvec) cp_async16(du + r * PASS_DT + e, src, min(V, cols - e) * (int)sizeof(T));
      else du[r * PASS_DT + e] = *src;
    }
  };
  const int nsub = (nt + PASS_TS - 1) / PASS_TS;
  prefetch(0);
  cp_async_commit();

  float a[NS], h[NS];
  float* st = hs + ((long long)z * NC + c) * NST * D + (long long)n0 * D + d;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a[n] = A[((long long)k * D + d) * NST + n0 + n];
    if (EXP2) a[n] *= 1.4426950408889634f;  // log2 e
    h[n] = FINAL ? st[(long long)n * D] : 0.f;
  }
  const float dsk = FINAL ? Dskip[k * D + d] : 0.f;
  float dsm = 0.f;
  for (int sb = 0; sb < nsub; ++sb) {
    if (sb + 1 < nsub) prefetch(sb + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* dd = sd + (sb & 1) * PASS_TS * PASS_DT;
    const T* du = su + (sb & 1) * PASS_TS * PASS_DT;
    const int rows_n = min(PASS_TS, nt - sb * PASS_TS);
    for (int r = 0; r < rows_n; ++r) {
      const int t = sb * PASS_TS + r;
      if (BOUNDS && on && t % TCB == 0) {  // the state entering chunk (l0 + t) / TCB
        float* hbp = hb + ((long long)z * NCB + (l0 + t) / TCB) * NST * D +
                     (long long)n0 * D + d;
#pragma unroll
        for (int n = 0; n < NS; ++n) hbp[(long long)n * D] = h[n];
      }
      const float dl = dd[r * PASS_DT + cs];
      const float u = to_f<T>(du[r * PASS_DT + cs]);
      const float dlu = dl * u;
      const float* Bt = sB + t * NS;
      const float* Ct = sC + t * NS;
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        h[n] = (EXP2 ? exp2f(dl * a[n]) : expf(dl * a[n])) * h[n] + dlu * Bt[n];
        if (FINAL) y = fmaf(Ct[n], h[n], y);
      }
      if (FINAL) {
        if (on) {
          const long long i = ((long long)z * L + l0 + t) * D + d;
          if (mode == 0) ys[i] = from_f<T>(y + dsk * u);
          else if (mode == 1) yacc[i] = y + dsk * u;
          else if (mode == 2) yacc[i] = yacc[i] + y;
          else ys[i] = from_f<T>(yacc[i] + y);
        }
      } else {
        dsm += dl;
      }
    }
    __syncthreads();  // sub-tile sb's buffer is refilled by the next prefetch
  }
  if (!FINAL && on) {
#pragma unroll
    for (int n = 0; n < NS; ++n) st[(long long)n * D] = h[n];
    if (n0 == 0) dsum[((long long)z * NC + c) * D + d] = dsm;
  }
}

// The two passes and the carry over G sequences of L steps, NST states in
// groups of NS, chunks of TC steps; hb == nullptr: no h_bounds (BOUNDS off);
// few_warps: the carry's 4-warp blocks.
template <typename T, int NS, bool EXP2, class Rows>
int chunk_passes(Rows rows, const float* proj, const float* A, const float* Ds, float* hs,
                 float* dsum, T* ys, float* yacc, float* hb, int G, int D, int NST, int L,
                 int TC, int TCB, bool few_warps, cudaStream_t s) {
  const int NC = (L + TC - 1) / TC, NCB = (L + TCB - 1) / TCB, ngroups = NST / NS;
  const dim3 grid(G, NC, (D + PASS_DT - 1) / PASS_DT);
  auto pass = [&](auto final_pass, auto bounds, int i, int mode) {
    constexpr bool FINAL = decltype(final_pass)::value, BOUNDS = decltype(bounds)::value;
    const size_t smem =
        (FINAL ? 2 : 1) * (size_t)TC * NS * 4 + 2 * PASS_TS * PASS_DT * (4 + sizeof(T));
    if constexpr (NS == PASS_GROUP) {
      if (ngroups > 1)
        return launch(chunk_pass_kernel<T, NS, FINAL, true, BOUNDS, EXP2, Rows>, grid, PASS_DT,
                      smem, s, rows, proj, A, Ds, hs, dsum, ys, yacc, hb, mode, D, L, NST,
                      i * NS, TC, NC, TCB, NCB);
    }
    return launch(chunk_pass_kernel<T, NS, FINAL, false, BOUNDS, EXP2, Rows>, grid, PASS_DT,
                  smem, s, rows, proj, A, Ds, hs, dsum, ys, yacc, hb, mode, D, L, NST, i * NS,
                  TC, NC, TCB, NCB);
  };
  for (int i = 0; i < ngroups; ++i)
    FD_TRY(pass(std::false_type{}, std::false_type{}, i, 0));
  FD_TRY((few_warps ? carry_scan<false, 4>(A, dsum, hs, 4, D, NST, NC, G, s)
                    : carry_scan<false>(A, dsum, hs, 4, D, NST, NC, G, s)));
  for (int i = 0; i < ngroups; ++i) {
    const int mode = ngroups == 1 ? 0 : i == 0 ? 1 : i == ngroups - 1 ? 3 : 2;
    FD_TRY(hb != nullptr ? pass(std::true_type{}, std::true_type{}, i, mode)
                         : pass(std::true_type{}, std::false_type{}, i, mode));
  }
  return 0;
}

// chunk_passes for a runtime state count NST: 4, 8, 16, 32, or a multiple of
// 64 (above 64 with yacc); the wrappers pad other sizes.
template <typename T, bool EXP2, class Rows>
int chunk_passes_n(Rows rows, const float* proj, const float* A, const float* Ds, float* hs,
                   float* dsum, T* ys, float* yacc, float* hb, int G, int D, int NST, int L,
                   int TC, int TCB, bool few_warps, cudaStream_t s) {
#define FD_PASSES(NSV)                                                                \
  chunk_passes<T, NSV, EXP2>(rows, proj, A, Ds, hs, dsum, ys, yacc, hb, G, D, NST, L, TC, \
                             TCB, few_warps, s)
  switch (NST) {
    case 4: return FD_PASSES(4);
    case 8: return FD_PASSES(8);
    case 16: return FD_PASSES(16);
    case 32: return FD_PASSES(32);
    default:
      if (NST % PASS_GROUP || (NST > PASS_GROUP && yacc == nullptr))
        return (int)cudaErrorInvalidValue;
      return FD_PASSES(64);
  }
#undef FD_PASSES
}

}  // namespace fd
