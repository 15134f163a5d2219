// SS2D epilogue: EfficientMerge + LayerNorm + z gate + conditioning, and
// with fold the MambaBlock tail:
//
//   og  = (LN(merge(ys)) * g + b) * gate_fn(z) + local     (gate_fn: silu or identity)
//   out = fold ? x_raw + gate * (round_io(og) @ proj_w) : round_io(og)
//
// Replaces the TPU kernel _epilogue_kernel (founddiff_tpu/ops/ss2d_fused.py:32,
// pallas_call :198 in _fused_fwd, through merge_ln_gate :271 and
// merge_ln_gate_split :365), the tail of the SS2D blocks on an even grid the
// fused block does not take (models/ss2d.py:319-389).
//
// Bound on the H100: bytes (ys and z read, og or out written, about 14 fp32
// operations and one exponential per element); with fold also out_proj's
// C * Co multiply-adds per pixel and the weight [C, Co] read once, which is
// all the work at the 2x2 grids of a 16^2 slice (P = 4 pixels per image).
// The first port wrote og to device memory and ran out_proj on the fp32
// CUDA cores of common.cuh's tiled GEMM: at P = 4 it launched Co / 64
// blocks, each walking K = C in dependent steps of 16.
//
// Design.  Each pixel's row of ys is gathered from its direction (k = (y &
// 1) + 2 * (x & 1), dirs 1 and 3 column-major) through that direction's
// pointer and batch stride, so one body serves the joint [B, 4, L, C] layout
// and the split rows [B, 2, L, C] / cols [B, 2, L, C] layout without a copy;
// one warp takes a pixel: its fp32 statistics in one pass (E[y^2] -
// mean^2), then og rounded to the io dtype (og_row).  With fold, one launch
// (fold_kernel) keeps og on chip, as the TPU kernel keeps it in VMEM: a
// block takes RM pixels and CN output channels, starts the copy of its
// whole weight slice pw[:, n0:n0+CN] into shared memory (16-byte cp.async),
// computes its pixels' og rows into shared memory meanwhile, and then runs
// out_proj on the tensor cores (fd::warp_mma: bf16 mma; fp32 as three TF32
// products, which hold the fp32 tolerance), adding x_raw + gate * acc in its
// epilogue.  Two tilings, chosen on the host (ops/ss2d_fused.py _fold_plan):
//   - few pixels (P <= 64: the 2x2 grids): RM = 16, CN = 16, so Co / 16
//     blocks read the weight once between them, each its 32-byte-wide
//     column slice in one burst; the 8 warps split K, and their partial
//     16 x 16 sums add up in shared memory in warp order (fixed, so every
//     run gives the same bits);
//   - many pixels: RM = 64, CN = 64, 8 warps as 4 x 2 tiles of 16 x 32.
// Where og and the weight slice exceed a block's shared memory (C above
// about 2,500 in fp32), the two-launch form stays: og through device memory
// (merge_ln_gate_kernel), then out_proj as fd::gemm_mma with the residual
// epilogue.  Without fold, merge_ln_gate_kernel writes og as the output.
// The TPU kernel's row blocks, in-VMEM transposes and register interleave
// are Mosaic's schedule and are not ported.
#include "ss2d_tail.cuh"

namespace {

constexpr int FOLD_THREADS = 256;
constexpr int FOLD_SMEM_MAX = 227 * 1024;

template <typename T>
struct Dirs {  // step l of direction k in image b at p[k] + b * sb[k & 1] + l * C
  const T* p[4];
  long long sb[2];  // batch strides of the row-major (0, 2) and column-major (1, 3) dirs
};

template <typename T>
struct EpiArgs {  // what og_row reads besides ys
  const T* z;
  const float* g;
  const float* bln;
  const float* local;  // [B, C] or null
  int H, W, C;
  float eps;
  int gate_silu;
};

// One warp: og of pixel pix (C values) rounded to the io dtype into orow.
template <typename T>
__device__ __forceinline__ void og_row(const Dirs<T>& ys, const EpiArgs<T>& e, long long pix,
                                       T* orow, int lane) {
  const int C = e.C;
  const int px = (int)(pix % e.W), py = (int)((pix / e.W) % e.H);
  const long long b = pix / ((long long)e.H * e.W);
  // out[2i, 2j] = dir0, [2i+1, 2j] = dir1, [2i, 2j+1] = dir2, [2i+1, 2j+1] = dir3
  const int k = (py & 1) + 2 * (px & 1), i = py >> 1, j = px >> 1;
  const int l = (k & 1) ? j * (e.H / 2) + i : i * (e.W / 2) + j;
  // a select, not ys.p[k]: a runtime index into a parameter array goes
  // through local memory
  const T* base = k == 0 ? ys.p[0] : k == 1 ? ys.p[1] : k == 2 ? ys.p[2] : ys.p[3];
  const T* yr = base + b * ((k & 1) ? ys.sb[1] : ys.sb[0]) + (long long)l * C;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = fd::to_f<T>(yr[c]);
    s += v;
    ss += v * v;
  }
  s = fd::warp_sum(s);
  ss = fd::warp_sum(ss);
  const float mean = s / C;
  const float rstd = rsqrtf(ss / C - mean * mean + e.eps);
  const T* zr = e.z + pix * C;
  for (int c = lane; c < C; c += 32) {
    const float yn = (fd::to_f<T>(yr[c]) - mean) * rstd * e.g[c] + e.bln[c];
    float zf = fd::to_f<T>(zr[c]);
    if (e.gate_silu) zf = zf / (1.f + expf(-zf));
    float o = yn * zf;
    if (e.local != nullptr) o += e.local[b * C + c];
    orow[c] = fd::from_f<T>(o);
  }
}

template <typename T>
__global__ void __launch_bounds__(fd::LN_THREADS)
merge_ln_gate_kernel(Dirs<T> ys, EpiArgs<T> e, T* __restrict__ og, long long P) {
  const long long pix = (long long)blockIdx.x * (fd::LN_THREADS / 32) + threadIdx.x / 32;
  if (pix < P) og_row(ys, e, pix, og + pix * e.C, threadIdx.x & 31);
}

// Shared-memory row padding of og (A) and of the weight slice (B): fp32
// fragment loads and bf16 ldmatrix rows without bank conflicts.
template <typename T> __host__ __device__ constexpr int pad_a() {
  return std::is_same<T, float>::value ? 4 : 8;
}
constexpr int PAD_B = 8;

// fold with 8 warps as WM (16 rows each) x WN x WK (K split), CN columns;
// C padded to Cp (a multiple of 16 * WK) with zeros in og and the weight.
template <typename T, int WM, int WN, int WK, int CN>
struct Fold {
  static constexpr int RM = 16 * WM, NJ = CN / (8 * WN), KQ = 16 * WK;
  static_assert(WM * WN * WK == FOLD_THREADS / 32 && NJ % 2 == 0, "tiling");
  static int cpad(int C) { return (C + KQ - 1) / KQ * KQ; }
  static size_t smem(int C) {
    const int Cp = cpad(C);
    return ((size_t)RM * (Cp + pad_a<T>()) + (size_t)Cp * (CN + PAD_B)) * sizeof(T) +
           (WK > 1 ? (size_t)WK * RM * CN * 4 : 0);
  }
};

template <typename T, int WM, int WN, int WK, int CN>
__global__ void __launch_bounds__(FOLD_THREADS)
fold_kernel(Dirs<T> ys, EpiArgs<T> e, const T* __restrict__ pw, fd::EpiResidual<T> epi,
            long long P, int Co, int Cp) {
  using F = Fold<T, WM, WN, WK, CN>;
  constexpr int RM = F::RM, NJ = F::NJ;
  const int C = e.C, lda = Cp + pad_a<T>(), ldb = CN + PAD_B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);                 // og [RM][lda]
  T* sB = sA + RM * lda;                                   // weight [Cp][ldb]
  float* red = reinterpret_cast<float*>(sB + Cp * ldb);   // [WK][RM][CN] (WK > 1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long m0 = (long long)blockIdx.y * RM;
  const int n0 = blockIdx.x * CN, ncols = min(CN, Co - n0);
  // the weight slice in flight while og is computed; its rows past C are
  // zero (its columns past Co feed only outputs that are not written)
  fd::stage_tile(sB, pw + n0, Co, C, ncols, ldb, tid, FOLD_THREADS);
  fd::cp_async_commit();
  const T zero = fd::from_f<T>(0.f);
  for (int i = tid; i < (Cp - C) * ldb; i += FOLD_THREADS) sB[C * ldb + i] = zero;
  for (int r = warp; r < RM; r += FOLD_THREADS / 32) {
    T* orow = sA + r * lda;
    if (m0 + r < P) {
      og_row(ys, e, m0 + r, orow, lane);
      for (int c = C + lane; c < Cp; c += 32) orow[c] = zero;
    } else {
      for (int c = lane; c < Cp; c += 32) orow[c] = zero;
    }
  }
  fd::cp_async_wait<0>();
  __syncthreads();
  const int wk = warp % WK, wn = (warp / WK) % WN, wm = warp / (WK * WN);
  const int kc = Cp / WK;
  float acc[1][NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[0][j][q] = 0.f;
  fd::warp_mma<T, 1, NJ>(acc, sA + 16 * wm * lda + wk * kc, lda,
                         sB + (long long)wk * kc * ldb + wn * NJ * 8, ldb, kc, lane);
  // fragment element q of tile j: row lane/4 (+8 for q >= 2), column
  // 8 j + 2 (lane % 4) + q % 2
  auto row = [&](int q) { return 16 * wm + (lane >> 2) + 8 * (q >> 1); };
  auto col = [&](int j, int q) { return wn * NJ * 8 + 8 * j + 2 * (lane & 3) + (q & 1); };
  if constexpr (WK == 1) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long m = m0 + row(q);
        const int n = n0 + col(j, q);
        if (m < P && n < Co) epi(0, (int)m, n, acc[0][j][q]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) red[(wk * RM + row(q)) * CN + col(j, q)] = acc[0][j][q];
    __syncthreads();
    for (int i = tid; i < RM * CN; i += FOLD_THREADS) {  // the K parts in warp order
      const long long m = m0 + i / CN;
      const int n = n0 + i % CN;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WK; ++w) v += red[w * RM * CN + i];
      if (m < P && n < Co) epi(0, (int)m, n, v);
    }
  }
}

template <typename T, int WM, int WN, int WK, int CN>
int fold(const Dirs<T>& ys, const EpiArgs<T>& e, const T* pw, fd::EpiResidual<T> epi,
         long long P, int Co, cudaStream_t s) {
  using F = Fold<T, WM, WN, WK, CN>;
  const size_t smem = F::smem(e.C);
  if (smem > FOLD_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((Co + CN - 1) / CN, (unsigned)((P + F::RM - 1) / F::RM));
  FD_TRY(fd::launch(fold_kernel<T, WM, WN, WK, CN>, grid, FOLD_THREADS, smem, s, ys, e, pw, epi,
                    P, Co, F::cpad(e.C)));
  return 0;
}

// plan (with fold): 1 few pixels, 2 many pixels, 0 the two launches
template <typename T>
int run(const Dirs<T>& ys, const EpiArgs<T>& e, const void* pw_, const float* gate,
        const void* rx, void* out_, void* og_, int B, int Co, int fold_, int plan,
        cudaStream_t s) {
  const long long P = (long long)B * e.H * e.W;
  const T* pw = static_cast<const T*>(pw_);
  T* out = static_cast<T*>(out_);
  const fd::EpiResidual<T> epi{static_cast<const T*>(rx), gate, out, Co, e.H * e.W};
  if (fold_ && plan == 1) return fold<T, 1, 1, 8, 16>(ys, e, pw, epi, P, Co, s);
  if (fold_ && plan == 2) return fold<T, 4, 2, 1, 64>(ys, e, pw, epi, P, Co, s);
  T* og = fold_ ? static_cast<T*>(og_) : out;
  const int per_block = fd::LN_THREADS / 32;
  merge_ln_gate_kernel<T><<<(unsigned)((P + per_block - 1) / per_block), fd::LN_THREADS, 0, s>>>(
      ys, e, og, P);
  FD_TRY(cudaGetLastError());
  if (fold_)
    FD_TRY((fd::gemm_mma<T>(1, (int)P, Co, e.C, fd::RowStrided<T>{og, 0, e.C}, e.C, og, pw, 0,
                            1, Co, epi, s)));
  return 0;
}

template <typename T>
int run_t(const void* y0, const void* y1, const void* y2, const void* y3, long long sb_rows,
          long long sb_cols, const void* z, const float* g, const float* b, const float* local,
          const void* pw, const float* gate, const void* rx, void* out, void* og, int B, int H,
          int W, int C, int Co, float eps, int gate_silu, int fold_, int plan, cudaStream_t s) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  const Dirs<T> ys{{c(y0), c(y1), c(y2), c(y3)}, {sb_rows, sb_cols}};
  const EpiArgs<T> e{c(z), g, b, local, H, W, C, eps, gate_silu};
  return run<T>(ys, e, pw, gate, rx, out, og, B, Co, fold_, plan, s);
}

}  // namespace

// y0..y3: direction k's [L, C] rows of image 0 at the io dtype (L = H/2 * W/2;
// dirs 1 and 3 column-major), image b at + b * sb_rows (dirs 0, 2) or
// + b * sb_cols (dirs 1, 3) elements; z [B, H, W, C] io; g, b [C] and local
// [B, C] (or null) fp32.  fold: pw [C, Co] io, gate [B, Co] fp32, rx and out
// [B, H, W, Co] io; plan 1 (few pixels) or 2 (many pixels) keeps og on chip,
// plan 0 writes it to the scratch og [B, H, W, C] io first.  Without fold,
// out [B, H, W, C] io.
extern "C" int ss2d_epilogue_forward(const void* y0, const void* y1, const void* y2,
                                     const void* y3, const void* z, const float* g,
                                     const float* b, const float* local, const void* pw,
                                     const float* gate, const void* rx, void* out, void* og,
                                     long long sb_rows, long long sb_cols, int B, int H, int W,
                                     int C, int Co, float eps, int gate_silu, int fold,
                                     int plan, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fold && plan == 0 && og == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run_t<float>(y0, y1, y2, y3, sb_rows, sb_cols, z, g, b, local, pw, gate, rx, out, og,
                        B, H, W, C, Co, eps, gate_silu, fold, plan, s);
  if (dtype == 1)
    return run_t<__nv_bfloat16>(y0, y1, y2, y3, sb_rows, sb_cols, z, g, b, local, pw, gate, rx,
                                out, og, B, H, W, C, Co, eps, gate_silu, fold, plan, s);
  return (int)cudaErrorInvalidValue;
}
