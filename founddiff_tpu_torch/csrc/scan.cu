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
// Bound on the H100: the bytes of the [G, L, D] operands at small N (one
// read of u, delta, dy, one write of each output), the fp32 scan operations
// and exponentials (about 6N per step and channel forward, 3x that
// backward) at N = 32 and above.  L is cut into chunks of TC steps
// (scan_chunk in ops/scan.py), h_bounds [G, NC, N, D] holds the state
// entering each chunk; the fused-projection forward below writes the same.
//
// Design (forward, scan_forward; backward, scan_backward):
// - States at run time.  A thread holds NG = 4 or 8 states of one channel;
//   ng = N / NG lanes (a power of two, at most 8) share a channel and sum
//   y, and the block is a tile of DT channels (128 down to 32) times ng.
//   N above 64 runs in launches of 64 states each: y (and the backward's
//   sums over n) go through an fp32 buffer in a fixed order, Dskip u added
//   once, rounded after the last.  No register array depends on N, so no
//   size spills.
// - Operands staged in shared memory.  Each block runs one chunk of one
//   channel tile.  The chunk's B and C rows are copied once per block; u,
//   delta and dy move in sub-tiles of TS steps by 16-byte cp.async (element
//   copies where a row is not 16-byte aligned), double-buffered: the next
//   sub-tile is in flight while the step loop reads the current one from
//   shared memory, never from device memory.
// - A parallel carry.  Chunk summaries compose associatively,
//   (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2), with a = exp(A * sum delta'),
//   so a decay exponent is never positive.  fd::carry_scan_kernel
//   (scan_common.cuh, shared with scan_image.cu) gives each of
//   16 warps a segment of chunks (32 channels a warp), composes the
//   segments in shared memory and rewalks each segment from its entry:
//   2 NC / 16 + 16 dependent steps instead of NC, the loads of 8 chunks
//   issued together ahead of their steps.
// - Forward: pass 1 (chunk end states from zero, and sum delta'), the
//   carry, pass 2 (rerun from the entry states, y).  The bounds-only mode
//   (y == nullptr) stops after the carry: what a backward needs.
// - Backward: the local pass (the adjoint from a zero carry, right to
//   left, and sum delta'), the reverse carry, then the main pass: per
//   chunk, a forward walk keeps the state at each sub-tile's start in
//   shared memory; then, sub-tile by sub-tile from the right, the states
//   of its TS = 4 steps are replayed into registers and the adjoint walks
//   them back, writing gu and gdelta and the per-chunk partials of gA, gD
//   and gbias.  abar = exp(delta' A) is computed again in the adjoint
//   rather than kept beside the states: kept, it costs TS * NG more
//   registers, and the pass ran slower (PERF.md section 6).  A thread holds
//   at most 128 registers (two blocks of 256 threads an SM); at NG = 8 that
//   spills a few values, which costs less than the lost blocks.  gB and gC
//   are summed over the block's channels: a butterfly reduce-scatter within
//   each warp (2NG values, about 2NG shuffles a step instead of 2NG * 5),
//   then the warps' sums in order through shared memory, one partial per
//   (step, state, channel tile).  Two reduce kernels add the partials in a
//   fixed order (gA, gD, gbias: 16 rows of a block over the chunks, then
//   the rows in order).  No float atomics: every run gives the same bits.
// The TPU kernel's Hillis-Steele tile scans and 128-lane layout are Mosaic
// constraints and are not ported; a chunk simply ends at L (the TPU's
// padded steps have delta' = 0 and change nothing).
//
// The fused-projection forward replaces the TPU kernel _scan_kernel_fused
// (scan_pallas.py:630, pallas_call :738 in _pallas_fwd_fused, through
// selective_scan_pallas_fused :817), the scan of the SS2D blocks on an odd
// grid (models/ss2d.py:467-475).  Its input is the decimated sequence xs
// [G, L, D] with the folded weights [K, D, D+2N] (delta | B | C); its
// outputs are y and the same h_bounds as the forward above, so its
// backward is scan_backward (_ssf_bwd, :791-812).  Bound on the H100: the
// [D, D+2N] projection at D = 512 and 1024 (2 * D * (D + 2N) operations per
// step against the scan's 6 * N * D and N exponentials), then the bytes of
// the fp32 projections it passes through device memory.  The first port ran
// that product on the fp32 CUDA cores, a chunk pass of one thread per
// channel reading B and C from device memory at every step, and a carry
// serial over 67 chunks of 8 steps (L 529 at 45^2); the carry and the
// product took two thirds of its time.  Design, as scan_image.cu's:
//   1. the product on the tensor cores (fd::gemm_mma: bf16 mma, fp32 as
//      three TF32 products), A rows strided in xs, softplus(delta + bias)
//      in its epilogue (EpiProjFast: the fast exponential and logarithm, to
//      about 4e-6 of the value), the fp32 projections written once;
//   2. scan_common.cuh's staged chunk passes (chunk_passes_n, shared with
//      scan_image.cu, u rows strided here) over chunks of TC steps (1024 /
//      N, 32 at N = 32: a chunk's B and C rows in shared memory), pass 1
//      bounds-only, the parallel carry fd::carry_scan_kernel between;
//   3. pass 2 writes, beside y, the state entering every chunk of TCB =
//      scan_chunk(N) steps (8 at N = 32), the h_bounds layout [G, NCB, N, D]
//      scan_backward reads; serving (no gradient) passes hb == nullptr and
//      writes none.
// delta'/B/C stay unrounded in fp32, as the TPU kernel keeps them in VMEM.
// A chunk ends at L (L = 529 at 45^2).
#include "scan_common.cuh"

namespace {

constexpr int WARP = 32;
constexpr int GROUP = 64;        // states of one launch of the runtime-N kernels
constexpr int RP_ROWS = 16;      // rows of reduce_params_kernel

// ---------------------------------------------------------------------------
// runtime-N scan kernels (scan_forward, scan_backward)
// ---------------------------------------------------------------------------
template <typename T>
struct ScanArgs {
  const T* u;
  const T* dl;
  const T* Bm;
  const T* Cm;
  const T* dy;
  const float* A;
  const float* Ds;
  const float* bias;
  int K, L, D, N, TC, NC;  // N: all states (the stride of B, C, A and h_bounds)
  int n0, nloc;            // this launch's states [n0, n0 + nloc)
  int ng, DT;              // lanes per channel, channels per block
};

// Launch geometry of nloc states: NG states a thread, ng lanes a channel
// (a power of two), DT channels a block of NT = DT * ng threads; NLP: nloc
// rounded up to 8 (the rows of B and C in shared memory).  Sub-tiles (a
// template argument TS): 8 steps at NG = 4, 4 at NG = 8, and 4 in the
// backward's main pass, whose registers hold TS * NG replayed states.
struct Geometry {
  int NG, ng, DT, NT, NLP;
};

Geometry geometry(int nloc) {
  Geometry g;
  g.NG = nloc <= 4 ? 4 : 8;
  g.ng = 1;
  while (g.ng * g.NG < nloc) g.ng *= 2;
  g.DT = g.ng == 1 ? 128 : 256 / g.ng > 128 ? 128 : 256 / g.ng;
  g.NT = g.DT * g.ng;
  g.NLP = (nloc + 7) & ~7;
  return g;
}

// v[i] summed with the other lanes of v[i]'s channel group: lanes that
// differ in a bit at or above ng (the channels of a warp).  Reduce-scatter
// halves the values at each level while two or more remain, so a lane ends
// with max(1, V * ng / 32) sums; returns the index of its first one.
template <int V>
__device__ __forceinline__ int channel_reduce(float (&v)[V], int lane, int ng) {
  int idx = 0;
#pragma unroll
  for (int lv = 0; lv < 5; ++lv) {
    const int o = 16 >> lv;
    if (o >= ng) {
      constexpr int one = 1;
      const int cnt = (V >> lv) > one ? (V >> lv) : one;
      if (cnt > 1) {
        const bool up = lane & o;
#pragma unroll
        for (int i = 0; i < (V >> (lv + 1)); ++i) {
          const float send = up ? v[i] : v[i + (V >> (lv + 1))];
          const float keep = up ? v[i + (V >> (lv + 1))] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
        if (up) idx += V >> (lv + 1);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
      }
    }
  }
  return idx;
}

// sum over the ng lanes of one channel
__device__ __forceinline__ float group_sum(float v, int ng) {
  for (int o = 1; o < ng; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Forward chunk pass, one block per (channel tile, chunk, sequence).  Pass 1
// (!FINAL): the chunk from a zero state; writes its end state into hb and
// sum delta' into dsum.  Pass 2: the chunk from its entry state in hb; y by
// mode: 0 y = io(C.h + Ds u); 1 yacc = C.h + Ds u; 2 yacc += C.h; 3 y =
// io(yacc + C.h) (N above 64: one launch per group of 64 states).
// Shared memory: B (and C) [TC][NLP], then two sub-tiles of u and delta.
template <typename T, int NG, int TS, bool FINAL>
__global__ void __launch_bounds__(256)
fwd_kernel(ScanArgs<T> p, T* __restrict__ y, float* __restrict__ yacc, int mode,
           float* __restrict__ hb, float* __restrict__ dsum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x, ng = p.ng, DT = p.DT;
  const int grp = tid & (ng - 1), cl = tid / ng;
  const int d0 = blockIdx.x * DT, d = d0 + cl;
  const int c = blockIdx.y, g = blockIdx.z, k = g % p.K;
  const int cols = min(DT, p.D - d0);
  const bool on = cl < cols;
  const int dd = on ? d : d0 + cols - 1;  // lanes past D run a valid channel, store nothing
  const int cs = dd - d0;
  const int l0 = c * p.TC, nt = min(p.L, l0 + p.TC) - l0, NLP = (p.nloc + 7) & ~7;
  const long long row0 = (long long)g * p.L + l0;
  T* sB = reinterpret_cast<T*>(smem_raw);
  T* sC = sB + p.TC * NLP;
  T* ring = sC + (FINAL ? p.TC * NLP : 0);  // [2][u, delta][TS][DT]
  fd::stage_tile(sB, p.Bm + row0 * p.N + p.n0, p.N, nt, p.nloc, NLP, tid, nthr);
  if (FINAL) fd::stage_tile(sC, p.Cm + row0 * p.N + p.n0, p.N, nt, p.nloc, NLP, tid, nthr);
  auto issue = [&](int s) {
    T* dst = ring + (s & 1) * 2 * TS * DT;
    const long long r = row0 + s * TS;
    const int rows = min(TS, nt - s * TS);
    fd::stage_tile(dst, p.u + r * p.D + d0, p.D, rows, cols, DT, tid, nthr);
    fd::stage_tile(dst + TS * DT, p.dl + r * p.D + d0, p.D, rows, cols, DT, tid, nthr);
  };
  const int nsub = (nt + TS - 1) / TS;
  issue(0);
  fd::cp_async_commit();

  float a[NG], h[NG];
  const long long hbase = ((long long)g * p.NC + c) * p.N + p.n0;  // [g, c, n, d]
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int n = grp * NG + j;
    const bool sv = n < p.nloc;
    a[j] = sv ? p.A[((long long)k * p.D + dd) * p.N + p.n0 + n] : 0.f;
    h[j] = FINAL && sv ? hb[(hbase + n) * p.D + dd] : 0.f;
  }
  const float bs = p.bias[k * p.D + dd];
  const float dsk = p.Ds[k * p.D + dd];
  float s = 0.f;
  for (int sb = 0; sb < nsub; ++sb) {
    if (sb + 1 < nsub) issue(sb + 1);
    fd::cp_async_commit();
    fd::cp_async_wait<1>();
    __syncthreads();
    const T* su = ring + (sb & 1) * 2 * TS * DT;
    const T* sd = su + TS * DT;
    const int rows = min(TS, nt - sb * TS);
    for (int r = 0; r < rows; ++r) {
      const int t = sb * TS + r;
      const float dlt = fd::softplus(fd::to_f<T>(sd[r * DT + cs]) + bs);
      const float uu = fd::to_f<T>(su[r * DT + cs]);
      const float du = dlt * uu;
      float yv = 0.f;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int n = grp * NG + j;
        const bool sv = n < p.nloc;
        const float bn = sv ? fd::to_f<T>(sB[t * NLP + n]) : 0.f;
        h[j] = expf(dlt * a[j]) * h[j] + du * bn;
        if (FINAL) yv = fmaf(sv ? fd::to_f<T>(sC[t * NLP + n]) : 0.f, h[j], yv);
      }
      if (FINAL) {
        yv = group_sum(yv, ng);
        if (grp == 0 && on) {
          const long long i = (row0 + t) * p.D + d;
          if (mode == 0) y[i] = fd::from_f<T>(yv + dsk * uu);
          else if (mode == 1) yacc[i] = yv + dsk * uu;
          else if (mode == 2) yacc[i] = yacc[i] + yv;
          else y[i] = fd::from_f<T>(yacc[i] + yv);
        }
      } else {
        s += dlt;
      }
    }
    __syncthreads();  // sub-tile sb's buffer is refilled by the next issue
  }
  if (!FINAL && on) {
#pragma unroll
    for (int j = 0; j < NG; ++j)
      if (grp * NG + j < p.nloc) hb[(hbase + grp * NG + j) * p.D + d] = h[j];
    if (grp == 0 && p.n0 == 0) dsum[((long long)g * p.NC + c) * p.D + d] = s;
  }
}

// Backward local pass: per (channel tile, chunk, sequence) the adjoint from
// a zero carry, right to left: zl [G, NC, N, D] = abar_first * gh_first, and
// sum delta' into dsum.  Shared memory: C [TC][NLP], two sub-tiles of
// delta and dy.
template <typename T, int NG, int TS>
__global__ void __launch_bounds__(256)
bwd_local_kernel(ScanArgs<T> p, float* __restrict__ zl, float* __restrict__ dsum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x, ng = p.ng, DT = p.DT;
  const int grp = tid & (ng - 1), cl = tid / ng;
  const int d0 = blockIdx.x * DT, d = d0 + cl;
  const int c = blockIdx.y, g = blockIdx.z, k = g % p.K;
  const int cols = min(DT, p.D - d0);
  const bool on = cl < cols;
  const int dd = on ? d : d0 + cols - 1;
  const int cs = dd - d0;
  const int l0 = c * p.TC, nt = min(p.L, l0 + p.TC) - l0, NLP = (p.nloc + 7) & ~7;
  const long long row0 = (long long)g * p.L + l0;
  T* sC = reinterpret_cast<T*>(smem_raw);
  T* ring = sC + p.TC * NLP;  // [2][delta, dy][TS][DT]
  fd::stage_tile(sC, p.Cm + row0 * p.N + p.n0, p.N, nt, p.nloc, NLP, tid, nthr);
  const int nsub = (nt + TS - 1) / TS;
  auto issue = [&](int i) {  // item i: sub-tile nsub - 1 - i
    const int sb = nsub - 1 - i;
    T* dst = ring + (i & 1) * 2 * TS * DT;
    const long long r = row0 + sb * TS;
    const int rows = min(TS, nt - sb * TS);
    fd::stage_tile(dst, p.dl + r * p.D + d0, p.D, rows, cols, DT, tid, nthr);
    fd::stage_tile(dst + TS * DT, p.dy + r * p.D + d0, p.D, rows, cols, DT, tid, nthr);
  };
  issue(0);
  fd::cp_async_commit();
  float a[NG], z[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int n = grp * NG + j;
    a[j] = n < p.nloc ? p.A[((long long)k * p.D + dd) * p.N + p.n0 + n] : 0.f;
    z[j] = 0.f;
  }
  const float bs = p.bias[k * p.D + dd];
  float s = 0.f;
  for (int i = 0; i < nsub; ++i) {
    if (i + 1 < nsub) issue(i + 1);
    fd::cp_async_commit();
    fd::cp_async_wait<1>();
    __syncthreads();
    const T* sd = ring + (i & 1) * 2 * TS * DT;
    const T* sy = sd + TS * DT;
    const int sb = nsub - 1 - i, rows = min(TS, nt - sb * TS);
    for (int r = rows - 1; r >= 0; --r) {
      const int t = sb * TS + r;
      const float dlt = fd::softplus(fd::to_f<T>(sd[r * DT + cs]) + bs);
      const float dyv = fd::to_f<T>(sy[r * DT + cs]);
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int n = grp * NG + j;
        const float cn = n < p.nloc ? fd::to_f<T>(sC[t * NLP + n]) : 0.f;
        z[j] = expf(dlt * a[j]) * fmaf(cn, dyv, z[j]);
      }
      s += dlt;
    }
    __syncthreads();
  }
  if (on) {
    const long long zb = ((long long)g * p.NC + c) * p.N + p.n0;
#pragma unroll
    for (int j = 0; j < NG; ++j)
      if (grp * NG + j < p.nloc) zl[(zb + grp * NG + j) * p.D + d] = z[j];
    if (grp == 0 && p.n0 == 0) dsum[((long long)g * p.NC + c) * p.D + d] = s;
  }
}

// Backward main pass, one block per (channel tile, chunk, sequence); cin
// [G, NC, N, D] the carry entering the chunk at its last step.  Writes gu,
// gdelta (by mode: 0 from this launch's states; 1 sacc/hacc = its sums over
// n; 2 add to them; 3 from sacc/hacc plus its sums), gB/gC partials [G, L,
// N, nb] (nb channel tiles), and gA [G, NC, N, D], gD and gbias [G, NC, D]
// chunk partials.  Shared memory: B, C [TC][NLP]; two sub-tiles of u,
// delta, dy; the state at the start of each sub-tile but the first,
// [nsub - 1][NG][NT] fp32; the warps' gB/gC sums [warps][TS][2][NLP] fp32.
template <typename T, int NG, int TS>
__global__ void __launch_bounds__(256, 2)
bwd_main_kernel(ScanArgs<T> p, const float* __restrict__ hb, const float* __restrict__ cin,
                T* __restrict__ gu, T* __restrict__ gdl, float* __restrict__ gBp,
                float* __restrict__ gCp, float* __restrict__ gAp, float* __restrict__ gDp,
                float* __restrict__ gbp, float* __restrict__ sacc, float* __restrict__ hacc,
                int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x, ng = p.ng, DT = p.DT;
  const int lane = tid & (WARP - 1), warp = tid / WARP, nwarps = nthr / WARP;
  const int grp = tid & (ng - 1), cl = tid / ng;
  const int d0 = blockIdx.x * DT, d = d0 + cl, nb = gridDim.x;
  const int c = blockIdx.y, g = blockIdx.z, k = g % p.K;
  const int cols = min(DT, p.D - d0);
  const bool on = cl < cols;
  const float live = on ? 1.f : 0.f;
  const int dd = on ? d : d0 + cols - 1;
  const int cs = dd - d0;
  const int l0 = c * p.TC, nt = min(p.L, l0 + p.TC) - l0, NLP = (p.nloc + 7) & ~7;
  const int nsub = (nt + TS - 1) / TS, nsub_max = (p.TC + TS - 1) / TS;
  const long long row0 = (long long)g * p.L + l0;
  T* sB = reinterpret_cast<T*>(smem_raw);
  T* sC = sB + p.TC * NLP;
  T* ring = sC + p.TC * NLP;  // [2][u, delta, dy][TS][DT]
  float* ck = reinterpret_cast<float*>(ring + 2 * 3 * TS * DT);  // [nsub_max - 1][NG][NT]
  float* wred = ck + (nsub_max - 1) * NG * nthr;                 // [warps][TS][2][NLP]
  fd::stage_tile(sB, p.Bm + row0 * p.N + p.n0, p.N, nt, p.nloc, NLP, tid, nthr);
  fd::stage_tile(sC, p.Cm + row0 * p.N + p.n0, p.N, nt, p.nloc, NLP, tid, nthr);
  // items: sub-tiles 0 .. nsub-2 forward (checkpoints), then nsub-1 .. 0 (adjoint)
  const int nf = nsub - 1, items = nf + nsub;
  auto sub_of = [&](int i) { return i < nf ? i : nsub - 1 - (i - nf); };
  auto issue = [&](int i) {
    const int sb = sub_of(i);
    T* dst = ring + (i & 1) * 3 * TS * DT;
    const long long r = row0 + sb * TS;
    const int rows = min(TS, nt - sb * TS);
    fd::stage_tile(dst, p.u + r * p.D + d0, p.D, rows, cols, DT, tid, nthr);
    fd::stage_tile(dst + TS * DT, p.dl + r * p.D + d0, p.D, rows, cols, DT, tid, nthr);
    if (i >= nf)
      fd::stage_tile(dst + 2 * TS * DT, p.dy + r * p.D + d0, p.D, rows, cols, DT, tid, nthr);
  };
  issue(0);
  fd::cp_async_commit();

  float a[NG], h0[NG], h[NG], z[NG], ga[NG];
  const long long sbase = ((long long)g * p.NC + c) * p.N + p.n0;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int n = grp * NG + j;
    const bool sv = n < p.nloc;
    a[j] = sv ? p.A[((long long)k * p.D + dd) * p.N + p.n0 + n] : 0.f;
    h0[j] = sv ? hb[(sbase + n) * p.D + dd] : 0.f;
    h[j] = h0[j];
    z[j] = sv ? live * cin[(sbase + n) * p.D + dd] : 0.f;
    ga[j] = 0.f;
  }
  const float bs = p.bias[k * p.D + dd];
  const float dsk = p.Ds[k * p.D + dd];
  float gds = 0.f, gbs = 0.f;
  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) issue(i + 1);
    fd::cp_async_commit();
    fd::cp_async_wait<1>();
    __syncthreads();
    const T* su = ring + (i & 1) * 3 * TS * DT;
    const T* sd = su + TS * DT;
    const T* sy = sd + TS * DT;
    const int sb = sub_of(i), rows = min(TS, nt - sb * TS);
    if (i < nf) {  // the forward walk: the state at the start of sub-tile sb + 1
      for (int r = 0; r < rows; ++r) {
        const int t = sb * TS + r;
        const float dlt = fd::softplus(fd::to_f<T>(sd[r * DT + cs]) + bs);
        const float du = dlt * fd::to_f<T>(su[r * DT + cs]);
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int n = grp * NG + j;
          const float bn = n < p.nloc ? fd::to_f<T>(sB[t * NLP + n]) : 0.f;
          h[j] = expf(dlt * a[j]) * h[j] + du * bn;
        }
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) ck[(sb * NG + j) * nthr + tid] = h[j];
    } else {
      float hs[NG], tr[TS][NG], dls[TS];
#pragma unroll
      for (int j = 0; j < NG; ++j) hs[j] = sb == 0 ? h0[j] : ck[((sb - 1) * NG + j) * nthr + tid];
      // replay the sub-tile's states into registers
#pragma unroll
      for (int r = 0; r < TS; ++r) {
        if (r < rows) {
          const int t = sb * TS + r;
          dls[r] = fd::softplus(fd::to_f<T>(sd[r * DT + cs]) + bs);
          const float du = dls[r] * fd::to_f<T>(su[r * DT + cs]);
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            const int n = grp * NG + j;
            const float bn = n < p.nloc ? fd::to_f<T>(sB[t * NLP + n]) : 0.f;
            tr[r][j] = expf(dls[r] * a[j]) * (r > 0 ? tr[r - 1][j] : hs[j]) + du * bn;
          }
        }
      }
      // the adjoint, right to left
#pragma unroll
      for (int r = TS - 1; r >= 0; --r) {
        if (r < rows) {
          const int t = sb * TS + r;
          const float raw = fd::to_f<T>(sd[r * DT + cs]) + bs;
          const float dlt = dls[r];
          const float uu = fd::to_f<T>(su[r * DT + cs]);
          const float dyv = live * fd::to_f<T>(sy[r * DT + cs]);
          float sbv = 0.f, sh = 0.f, v[2 * NG];
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            const int n = grp * NG + j;
            const bool sv = n < p.nloc;
            const float bn = sv ? fd::to_f<T>(sB[t * NLP + n]) : 0.f;
            const float cn = sv ? fd::to_f<T>(sC[t * NLP + n]) : 0.f;
            const float gh = fmaf(cn, dyv, z[j]);
            const float hp = r > 0 ? tr[r - 1][j] : hs[j];
            sbv = fmaf(gh, bn, sbv);
            const float ab = expf(dlt * a[j]);  // the replay's, recomputed
            const float gha = gh * hp * ab;
            sh = fmaf(gha, a[j], sh);
            ga[j] = fmaf(gha, dlt, ga[j]);
            z[j] = ab * gh;
            v[j] = gh * dlt * uu;      // this channel's share of gB[t, n]
            v[NG + j] = tr[r][j] * dyv;  // and of gC[t, n]
          }
          sbv = group_sum(sbv, ng);
          sh = group_sum(sh, ng);
          const long long ix = (row0 + t) * p.D + dd;
          const bool store = grp == 0 && on;
          if (mode == 1 && store) {
            sacc[ix] = sbv;
            hacc[ix] = sh;
          } else if (mode == 2 && store) {
            sacc[ix] = sacc[ix] + sbv;
            hacc[ix] = hacc[ix] + sh;
          } else if (mode == 3) {
            sbv = sacc[ix] + sbv;
            sh = hacc[ix] + sh;
          }
          if (mode == 0 || mode == 3) {
            const float gd = fmaf(uu, sbv, sh) / (1.f + expf(-raw));
            if (store) {
              gu[ix] = fd::from_f<T>(fmaf(dsk, dyv, dlt * sbv));
              gdl[ix] = fd::from_f<T>(gd);
            }
            gds = fmaf(dyv, uu, gds);
            gbs += gd;
          }
          const int first = channel_reduce(v, lane, ng);
          constexpr int HELD = (2 * NG * 8 / WARP) > 1 ? (2 * NG * 8 / WARP) : 1;
          const int held = max(1, 2 * NG * ng / WARP);
#pragma unroll
          for (int q = 0; q < HELD; ++q) {
            if (q < held) {
              const int vi = first + q, which = vi / NG, n = grp * NG + vi % NG;
              if (n < p.nloc) wred[((warp * TS + r) * 2 + which) * NLP + n] = v[q];
            }
          }
        }
      }
      __syncthreads();
      // the block's gB/gC partial: the warps' sums in order
      for (int e = tid; e < rows * 2 * p.nloc; e += nthr) {
        const int r = e / (2 * p.nloc), rem = e - r * 2 * p.nloc;
        const int which = rem / p.nloc, n = rem - which * p.nloc;
        float acc = 0.f;
        for (int w = 0; w < nwarps; ++w) acc += wred[((w * TS + r) * 2 + which) * NLP + n];
        float* out = which ? gCp : gBp;
        out[((row0 + sb * TS + r) * p.N + p.n0 + n) * nb + blockIdx.x] = acc;
      }
    }
    __syncthreads();
  }
  if (on) {
#pragma unroll
    for (int j = 0; j < NG; ++j)
      if (grp * NG + j < p.nloc) gAp[(sbase + grp * NG + j) * p.D + d] = ga[j];
    if (grp == 0 && (mode == 0 || mode == 3)) {
      gDp[((long long)g * p.NC + c) * p.D + d] = gds;
      gbp[((long long)g * p.NC + c) * p.D + d] = gbs;
    }
  }
}

// gB, gC [G, L, N] at the io dtype from [G, L, N, nb] partials
template <typename T>
__global__ void reduce_bc_kernel(const float* __restrict__ gBp, const float* __restrict__ gCp,
                                 T* __restrict__ gB, T* __restrict__ gC, int nb,
                                 long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sb = 0.f, sc = 0.f;
  for (int j = 0; j < nb; ++j) {
    sb += gBp[i * nb + j];
    sc += gCp[i * nb + j];
  }
  gB[i] = fd::from_f<T>(sb);
  gC[i] = fd::from_f<T>(sc);
}

// gA [K, D, N] from [G, NC, N, D] partials; gD, gbias [K, D] from [G, NC, D]
// partials.  Block (32 channels, n, k): row ry sums the (b, chunk) pairs
// ry, ry + RP_ROWS, ... in order, then the rows are added in order.
__global__ void __launch_bounds__(WARP * RP_ROWS)
reduce_params_kernel(const float* __restrict__ gAp, const float* __restrict__ gDp,
                     const float* __restrict__ gbp, float* __restrict__ gA,
                     float* __restrict__ gD, float* __restrict__ gbias, int Bsz, int K, int D,
                     int N, int NC) {
  __shared__ float part[3][RP_ROWS][WARP];
  const int lane = threadIdx.x & (WARP - 1), ry = threadIdx.x / WARP;
  const int d = blockIdx.x * WARP + lane, n = blockIdx.y, k = blockIdx.z;
  const bool on = d < D;
  const int dd = on ? d : D - 1;
  float sa = 0.f, sd = 0.f, sbias = 0.f;
  for (int j = ry; j < Bsz * NC; j += RP_ROWS) {
    const long long g = (long long)(j / NC) * K + k;
    const int c = j % NC;
    sa += gAp[((g * NC + c) * N + n) * D + dd];
    if (n == 0) {
      sd += gDp[(g * NC + c) * D + dd];
      sbias += gbp[(g * NC + c) * D + dd];
    }
  }
  part[0][ry][lane] = sa;
  part[1][ry][lane] = sd;
  part[2][ry][lane] = sbias;
  __syncthreads();
  if (ry == 0 && on) {
    sa = sd = sbias = 0.f;
    for (int r = 0; r < RP_ROWS; ++r) {
      sa += part[0][r][lane];
      sd += part[1][r][lane];
      sbias += part[2][r][lane];
    }
    gA[((long long)k * D + d) * N + n] = sa;
    if (n == 0) {
      gD[(long long)k * D + d] = sd;
      gbias[(long long)k * D + d] = sbias;
    }
  }
}

// the mode of group i of ngroups (see fwd_kernel and bwd_main_kernel)
int group_mode(int i, int ngroups) {
  return ngroups == 1 ? 0 : i == 0 ? 1 : i == ngroups - 1 ? 3 : 2;
}

template <typename T, int NG, int TS>
int forward_pass(ScanArgs<T> p, const Geometry& q, bool final_pass, T* y, float* yacc,
                 int mode, float* hb, float* dsum, int G, cudaStream_t s) {
  const size_t es = sizeof(T);
  const size_t smem = (final_pass ? 2 : 1) * (size_t)p.TC * q.NLP * es + 2 * 2 * TS * q.DT * es;
  const dim3 grid((p.D + q.DT - 1) / q.DT, p.NC, G);
  if (final_pass)
    return fd::launch(fwd_kernel<T, NG, TS, true>, grid, q.NT, smem, s, p, y, yacc, mode, hb,
                      dsum);
  return fd::launch(fwd_kernel<T, NG, TS, false>, grid, q.NT, smem, s, p, y, yacc, mode, hb,
                    dsum);
}

// One geometry for every group: that of the first (the last may have fewer
// states, whose lanes then hold none).
template <typename T>
int forward(ScanArgs<T> p, T* y, float* yacc, float* hb, float* dsum, int G, cudaStream_t s) {
  const int ngroups = (p.N + GROUP - 1) / GROUP;
  const Geometry q = geometry(min(p.N, GROUP));
  p.ng = q.ng;
  p.DT = q.DT;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      FD_TRY(fd::carry_scan<false>(p.A, dsum, hb, p.K, p.D, p.N, p.NC, G, s));
      if (y == nullptr) return 0;  // bounds only
    }
    for (int i = 0; i < ngroups; ++i) {
      p.n0 = i * GROUP;
      p.nloc = min(GROUP, p.N - p.n0);
      const int mode = group_mode(i, ngroups);
      const int rc = q.NG == 4 ? forward_pass<T, 4, 8>(p, q, pass, y, yacc, mode, hb, dsum, G, s)
                               : forward_pass<T, 8, 4>(p, q, pass, y, yacc, mode, hb, dsum, G, s);
      if (rc) return rc;
    }
  }
  return 0;
}

template <typename T, int NG, int TS>
int backward_local(ScanArgs<T> p, const Geometry& q, float* zl, float* dsum, int G,
                   cudaStream_t s) {
  const size_t es = sizeof(T);
  const size_t smem = (size_t)p.TC * q.NLP * es + 2 * 2 * TS * q.DT * es;
  const dim3 grid((p.D + q.DT - 1) / q.DT, p.NC, G);
  return fd::launch(bwd_local_kernel<T, NG, TS>, grid, q.NT, smem, s, p, zl, dsum);
}

template <typename T, int NG, int TS>
int backward_main(ScanArgs<T> p, const Geometry& q, const float* hb, const float* cin, T* gu,
                  T* gdl, float* gBp, float* gCp, float* gAp, float* gDp, float* gbp,
                  float* sacc, float* hacc, int mode, int G, cudaStream_t s) {
  const size_t es = sizeof(T);
  const int nsub_max = (p.TC + TS - 1) / TS;
  const size_t smem = 2 * (size_t)p.TC * q.NLP * es + 2 * 3 * TS * q.DT * es +
                      ((size_t)(nsub_max - 1) * NG * q.NT + (q.NT / WARP) * TS * 2 * q.NLP) * 4;
  const dim3 grid((p.D + q.DT - 1) / q.DT, p.NC, G);
  return fd::launch(bwd_main_kernel<T, NG, TS>, grid, q.NT, smem, s, p, hb, cin, gu, gdl, gBp,
                    gCp, gAp, gDp, gbp, sacc, hacc, mode);
}

template <typename T>
int backward(ScanArgs<T> p, const float* hb, T* gu, T* gdl, T* gB, T* gC, float* gA,
             float* gD, float* gbias, float* zl, float* dsum, float* gBp, float* gCp,
             float* gAp, float* gDp, float* gbp, float* sacc, float* hacc, int Bsz,
             cudaStream_t s) {
  const int G = Bsz * p.K, ngroups = (p.N + GROUP - 1) / GROUP;
  const Geometry q = geometry(min(p.N, GROUP));
  p.ng = q.ng;
  p.DT = q.DT;
  const int nb = (p.D + q.DT - 1) / q.DT;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      FD_TRY(fd::carry_scan<true>(p.A, dsum, zl, p.K, p.D, p.N, p.NC, G, s));
    }
    for (int i = 0; i < ngroups; ++i) {
      p.n0 = i * GROUP;
      p.nloc = min(GROUP, p.N - p.n0);
      const int mode = group_mode(i, ngroups);
      int rc;
      if (pass == 0)
        rc = q.NG == 4 ? backward_local<T, 4, 8>(p, q, zl, dsum, G, s)
                       : backward_local<T, 8, 4>(p, q, zl, dsum, G, s);
      else
        rc = q.NG == 4 ? backward_main<T, 4, 4>(p, q, hb, zl, gu, gdl, gBp, gCp, gAp, gDp, gbp,
                                                sacc, hacc, mode, G, s)
                       : backward_main<T, 8, 4>(p, q, hb, zl, gu, gdl, gBp, gCp, gAp, gDp, gbp,
                                                sacc, hacc, mode, G, s);
      if (rc) return rc;
    }
  }
  const long long nbc = (long long)G * p.L * p.N;
  reduce_bc_kernel<T><<<(unsigned)((nbc + 255) / 256), 256, 0, s>>>(gBp, gCp, gB, gC, nb, nbc);
  FD_TRY(cudaGetLastError());
  const dim3 rg((p.D + WARP - 1) / WARP, p.N, p.K);
  reduce_params_kernel<<<rg, WARP * RP_ROWS, 0, s>>>(gAp, gDp, gbp, gA, gD, gbias, Bsz, p.K,
                                                     p.D, p.N, p.NC);
  FD_TRY(cudaGetLastError());
  return 0;
}

template <typename T>
ScanArgs<T> scan_args(const void* u, const void* dl, const void* Bm, const void* Cm,
                      const void* dy, const float* A, const float* Ds, const float* bias, int K,
                      int L, int D, int NS, int TC) {
  ScanArgs<T> p;
  p.u = static_cast<const T*>(u);
  p.dl = static_cast<const T*>(dl);
  p.Bm = static_cast<const T*>(Bm);
  p.Cm = static_cast<const T*>(Cm);
  p.dy = static_cast<const T*>(dy);
  p.A = A;
  p.Ds = Ds;
  p.bias = bias;
  p.K = K;
  p.L = L;
  p.D = D;
  p.N = NS;
  p.TC = TC;
  p.NC = (L + TC - 1) / TC;
  p.n0 = 0;
  p.nloc = NS;
  p.ng = 1;
  p.DT = 128;
  return p;
}

// ---------------------------------------------------------------------------
// fused-projection forward: the projection product on the tensor cores, then
// scan_common.cuh's staged chunk passes over the [G, L, D] rows of xs, chunks
// of TC steps, h_bounds at every TCB steps (TC % TCB == 0)
// ---------------------------------------------------------------------------
template <typename T>
int fused_forward(const T* u, const T* wproj, const float* A, const float* Ds,
                  const float* bias, T* y, float* yacc, float* hb, float* proj, float* hs,
                  float* dsum, int G, int L, int D, int NS, int TC, int TCB, cudaStream_t s) {
  const int NP = D + 2 * NS;
  const fd::RowStrided<T> rows{u, (long long)L * D, D};
  FD_TRY((fd::gemm_mma<T>(G, L, NP, D, rows, D, u, wproj, (long long)D * NP, 4, NP,
                          fd::EpiProjFast{proj, bias, L, D, NP}, s)));
  const bool few_chunks = (L + TC - 1) / TC <= 32;  // the carry's 4-warp blocks
  return fd::chunk_passes_n<T, true>(rows, proj, A, Ds, hs, dsum, y, yacc, hb, G, D, NS, L, TC,
                                     TCB, few_chunks, s);
}

}  // namespace

// u, dl [G, L, D], Bm, Cm [G, L, N] at the io dtype (G = Bsz * K, direction
// g % K); A [K, D, N], Ds and bias [K, D] fp32; any N >= 1.  Writes hb
// [G, NC, N, D] fp32, the state entering each chunk of TC steps, and, unless
// y is null (the bounds-only mode), y [G, L, D] (io).  Scratch: dsum
// [G, NC, D] fp32, and for N > 64 yacc [G, L, D] fp32 (else unused).
extern "C" int scan_forward(const void* u, const void* dl, const void* Bm, const void* Cm,
                            const float* A, const float* Ds, const float* bias, void* y,
                            float* hb, float* dsum, float* yacc, int G, int K, int L, int D,
                            int NS, int TC, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NS < 1 || (NS > GROUP && y != nullptr && yacc == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return forward<float>(scan_args<float>(u, dl, Bm, Cm, nullptr, A, Ds, bias, K, L, D, NS, TC),
                          static_cast<float*>(y), yacc, hb, dsum, G, s);
  if (dtype == 1)
    return forward<__nv_bfloat16>(
        scan_args<__nv_bfloat16>(u, dl, Bm, Cm, nullptr, A, Ds, bias, K, L, D, NS, TC),
        static_cast<__nv_bfloat16*>(y), yacc, hb, dsum, G, s);
  return (int)cudaErrorInvalidValue;
}

// The forward's inputs, its hb and dy [G, L, D] (io); any N >= 1.  Writes
// gu, gdl [G, L, D] and gB, gC [G, L, N] at the io dtype; gA [K, D, N], gD
// and gbias [K, D] fp32.  Scratch (fp32): zl [G, NC, N, D], dsum [G, NC, D],
// gBp and gCp of G * L * N * nb floats, room for ceil(D / DT) channel tiles
// of DT (geometry above; ceil(D / 32) always is), gAp [G, NC, N, D], gDp and
// gbp [G, NC, D]; for N > 64 sacc and hacc [G, L, D] (else unused).
extern "C" int scan_backward(const void* u, const void* dl, const void* Bm, const void* Cm,
                             const float* A, const float* Ds, const float* bias,
                             const float* hb, const void* dy, void* gu, void* gdl, void* gB,
                             void* gC, float* gA, float* gD, float* gbias, float* zl,
                             float* dsum, float* gBp, float* gCp, float* gAp, float* gDp,
                             float* gbp, float* sacc, float* hacc, int Bsz, int K, int L, int D,
                             int NS, int TC, int nb, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NS < 1 || (NS > GROUP && (sacc == nullptr || hacc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int DT = geometry(min(NS, GROUP)).DT;
  if (nb < (D + DT - 1) / DT) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return backward<float>(scan_args<float>(u, dl, Bm, Cm, dy, A, Ds, bias, K, L, D, NS, TC),
                           hb, static_cast<float*>(gu), static_cast<float*>(gdl),
                           static_cast<float*>(gB), static_cast<float*>(gC), gA, gD, gbias, zl,
                           dsum, gBp, gCp, gAp, gDp, gbp, sacc, hacc, Bsz, s);
  if (dtype == 1) {
    using B16 = __nv_bfloat16;
    return backward<B16>(scan_args<B16>(u, dl, Bm, Cm, dy, A, Ds, bias, K, L, D, NS, TC), hb,
                         static_cast<B16*>(gu), static_cast<B16*>(gdl), static_cast<B16*>(gB),
                         static_cast<B16*>(gC), gA, gD, gbias, zl, dsum, gBp, gCp, gAp, gDp,
                         gbp, sacc, hacc, Bsz, s);
  }
  return (int)cudaErrorInvalidValue;
}

// xs [G, L, D] (G = Bsz * 4, direction g % 4) and wproj [4, D, D+2N]
// (delta | B | C) at the io dtype; A [4, D, N], Ds and bias [4, D] fp32;
// N in {4, 8, 16, 32} or a multiple of 64.  Writes y [G, L, D] (io) and,
// unless hb is null, hb [G, NCB, N, D] fp32, the state entering each chunk
// of TCB steps, as scan_forward does at chunk TCB.  The passes run chunks of
// TC steps, a multiple of TCB.  Scratch (fp32): proj [G, L, D+2N], dsum
// [G, NC, D] and hs [G, NC, N, D] (NC = ceil(L / TC)), for N > 64 yacc
// [G, L, D] (else unused).
extern "C" int scan_fused_forward(const void* xs, const void* wproj, const float* A,
                                  const float* Ds, const float* bias, void* y, float* hb,
                                  float* proj, float* dsum, float* yacc, float* hs, int G, int L,
                                  int D, int NS, int TCB, int TC, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (TCB < 1 || TC % TCB) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return fused_forward<float>(static_cast<const float*>(xs), static_cast<const float*>(wproj),
                                A, Ds, bias, static_cast<float*>(y), yacc, hb, proj, hs, dsum,
                                G, L, D, NS, TC, TCB, s);
  if (dtype == 1)
    return fused_forward<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(xs),
                                        static_cast<const __nv_bfloat16*>(wproj), A, Ds, bias,
                                        static_cast<__nv_bfloat16*>(y), yacc, hb, proj, hs,
                                        dsum, G, L, D, NS, TC, TCB, s);
  return (int)cudaErrorInvalidValue;
}
