// Device code shared by the selective scans (scan.cu, scan_image.cu,
// ss2d_tail.cuh): the pixel map of the four step-2 decimated directions,
// the projection GEMM's row gather and epilogue, the three-pass chunked
// image scan of the fused blocks, and the operand staging and parallel carry
// of the runtime-N scans and of scan_image.cu.
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

template <typename T>
struct RowGather {  // A rows of the projection GEMM: xs pixels in direction order
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
// group, its strides known at compile time.
template <typename T, int NS, bool FINAL, class Out, bool GROUPED>
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
    const float u = to_f<T>(xs[pix * D + d]);
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
// channels x CARRY_WARPS segments of chunks.  (scan.cu, scan_image.cu)
template <bool REVERSE>
__global__ void __launch_bounds__(CARRY_LANES * CARRY_WARPS)
carry_scan_kernel(const float* __restrict__ A, const float* __restrict__ dsum,
                  float* __restrict__ st, int K, int D, int N, int NC) {
  __shared__ float seg_b[CARRY_WARPS][CARRY_LANES], seg_s[CARRY_WARPS][CARRY_LANES];
  const int lane = threadIdx.x & (CARRY_LANES - 1), w = threadIdx.x / CARRY_LANES;
  const int d = blockIdx.x * CARRY_LANES + lane, n = blockIdx.y;
  const long long g = blockIdx.z;
  const bool on = d < D;
  const int dd = on ? d : D - 1;
  const float a = A[((g % K) * D + dd) * N + n];
  const int S = (NC + CARRY_WARPS - 1) / CARRY_WARPS;
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
    for (int j = 0; j < CARRY_WARPS; ++j) {
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
}

template <bool REVERSE>
cudaError_t carry_scan(const float* A, const float* dsum, float* st, int K, int D, int N, int NC,
                       int G, cudaStream_t s) {
  const dim3 grid((D + CARRY_LANES - 1) / CARRY_LANES, N, G);
  carry_scan_kernel<REVERSE><<<grid, CARRY_LANES * CARRY_WARPS, 0, s>>>(A, dsum, st, K, D, N, NC);
  return cudaGetLastError();
}

// The three passes on the caller's stream for NST states in groups of NS;
// proj is [B*4, L, D+2N] from the RowGather/EpiProj GEMM, csum [B*4, NC, D],
// cstate [B*4, NC, D, N], yacc [B*4, L, D] fp32 (several groups only).
template <typename T, int NS, class Out>
int image_scan(const T* xs, const float* proj, const float* A, const float* Ds, float* csum,
               float* cstate, Out out, float* yacc, int B, int H, int W, int D, int NST, int L,
               int TC, int NC, cudaStream_t s) {
  dim3 grid((D + SCAN_THREADS - 1) / SCAN_THREADS, NC, B * 4);
  const int ngroups = NST / NS;
  auto pass = [&](auto final_pass, int i, int mode) {
    constexpr bool FINAL = decltype(final_pass)::value;
    if constexpr (NS == 64) {
      if (ngroups > 1) {
        image_scan_chunk_kernel<T, NS, FINAL, Out, true><<<grid, SCAN_THREADS, 0, s>>>(
            xs, proj, A, Ds, csum, cstate, out, yacc, mode, H, W, D, L, NST, i * NS, TC, NC);
        return cudaGetLastError();
      }
    }
    image_scan_chunk_kernel<T, NS, FINAL, Out, false><<<grid, SCAN_THREADS, 0, s>>>(
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
template <typename T, class Out>
int image_scan_n(const T* xs, const float* proj, const float* A, const float* Ds, float* csum,
                 float* cstate, Out out, float* yacc, int B, int H, int W, int D, int NS, int L,
                 int TC, int NC, cudaStream_t s) {
#define FD_IMAGE_SCAN(NSV) \
  image_scan<T, NSV>(xs, proj, A, Ds, csum, cstate, out, yacc, B, H, W, D, NS, L, TC, NC, s)
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

}  // namespace fd
