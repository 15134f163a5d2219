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
// Bound on the H100: bytes without fold (ys and z read, og written, about
// 12 fp32 operations per element); with fold the out_proj product, C * Co
// multiply-adds per pixel on the fp32 CUDA cores of common.cuh's tiled GEMM.
// Design, in one or two launches on the caller's stream: one warp per pixel
// gathers that pixel's row of ys from its direction (k = (y & 1) + 2 * (x & 1),
// dirs 1 and 3 column-major), takes its fp32 statistics in one pass
// (E[y^2] - mean^2), and writes og rounded to the io dtype; with fold,
// out_proj is the GEMM of ss2d_tail.cuh whose epilogue adds gate * acc to
// the residual (EpiResidual).  Each direction is read through its own
// pointer and batch stride, so one body serves the joint [B, 4, L, C]
// layout and the split rows [B, 2, L, C] / cols [B, 2, L, C] layout
// without a copy.  The TPU kernel's row blocks, in-VMEM transposes and
// register interleave are Mosaic's schedule and are not ported.
#include "ss2d_tail.cuh"

namespace {

template <typename T>
struct Dirs {  // step l of direction k in image b at p[k] + b * sb[k & 1] + l * C
  const T* p[4];
  long long sb[2];  // batch strides of the row-major (0, 2) and column-major (1, 3) dirs
};

template <typename T>
__global__ void __launch_bounds__(fd::LN_THREADS)
merge_ln_gate_kernel(Dirs<T> ys, const T* __restrict__ z, const float* __restrict__ g,
                     const float* __restrict__ bln, const float* __restrict__ local,
                     T* __restrict__ og, long long P, int H, int W, int C, float eps,
                     int gate_silu) {
  const long long pix = (long long)blockIdx.x * (fd::LN_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (pix >= P) return;
  const int px = (int)(pix % W), py = (int)((pix / W) % H);
  const long long b = pix / ((long long)H * W);
  // out[2i, 2j] = dir0, [2i+1, 2j] = dir1, [2i, 2j+1] = dir2, [2i+1, 2j+1] = dir3
  const int k = (py & 1) + 2 * (px & 1), i = py >> 1, j = px >> 1;
  const int l = (k & 1) ? j * (H / 2) + i : i * (W / 2) + j;
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
  const float rstd = rsqrtf(ss / C - mean * mean + eps);
  const T* zr = z + pix * C;
  for (int c = lane; c < C; c += 32) {
    const float yn = (fd::to_f<T>(yr[c]) - mean) * rstd * g[c] + bln[c];
    float zf = fd::to_f<T>(zr[c]);
    if (gate_silu) zf = zf / (1.f + expf(-zf));
    float o = yn * zf;
    if (local != nullptr) o += local[b * C + c];
    og[pix * C + c] = fd::from_f<T>(o);
  }
}

template <typename T>
int run(const Dirs<T>& ys, const void* z, const float* g, const float* b, const float* local,
        const void* pw, const float* gate, const void* rx, void* out, void* og, int B, int H,
        int W, int C, int Co, float eps, int gate_silu, int fold, cudaStream_t s) {
  const long long P = (long long)B * H * W;
  const int per_block = fd::LN_THREADS / 32;
  T* ogt = static_cast<T*>(fold ? og : out);
  merge_ln_gate_kernel<T><<<(unsigned)((P + per_block - 1) / per_block), fd::LN_THREADS, 0,
                            s>>>(ys, static_cast<const T*>(z), g, b, local, ogt, P, H, W, C,
                                 eps, gate_silu);
  FD_TRY(cudaGetLastError());
  if (fold)
    FD_TRY((fd::gemm<T>(1, (int)P, Co, C, fd::RowStrided<T>{ogt, 0, C},
                        static_cast<const T*>(pw), 0, 1, Co,
                        fd::EpiResidual<T>{static_cast<const T*>(rx), gate,
                                           static_cast<T*>(out), Co, H * W},
                        s)));
  return 0;
}

template <typename T>
Dirs<T> dirs(const void* y0, const void* y1, const void* y2, const void* y3, long long sb_rows,
             long long sb_cols) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  return Dirs<T>{{c(y0), c(y1), c(y2), c(y3)}, {sb_rows, sb_cols}};
}

}  // namespace

// y0..y3: direction k's [L, C] rows of image 0 at the io dtype (L = H/2 * W/2;
// dirs 1 and 3 column-major), image b at + b * sb_rows (dirs 0, 2) or
// + b * sb_cols (dirs 1, 3) elements; z [B, H, W, C] io; g, b [C] and local
// [B, C] (or null) fp32.  fold: pw [C, Co] io, gate [B, Co] fp32, rx and out
// [B, H, W, Co] io, scratch og [B, H, W, C] io; else out [B, H, W, C] io.
extern "C" int ss2d_epilogue_forward(const void* y0, const void* y1, const void* y2,
                                     const void* y3, const void* z, const float* g,
                                     const float* b, const float* local, const void* pw,
                                     const float* gate, const void* rx, void* out, void* og,
                                     long long sb_rows, long long sb_cols, int B, int H, int W,
                                     int C, int Co, float eps, int gate_silu, int fold,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(dirs<float>(y0, y1, y2, y3, sb_rows, sb_cols), z, g, b, local, pw, gate,
                      rx, out, og, B, H, W, C, Co, eps, gate_silu, fold, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(dirs<__nv_bfloat16>(y0, y1, y2, y3, sb_rows, sb_cols), z, g, b,
                              local, pw, gate, rx, out, og, B, H, W, C, Co, eps, gate_silu,
                              fold, s);
  return (int)cudaErrorInvalidValue;
}
