// The guarded separable (row-anchored) warp and its exact adjoint.
//
// Replaces the Pallas TPU kernels in mine_tpu/kernels/warp_sep.py:
//   * pallas_sep_bilinear_sample (body _sep_fwd_kernel)
//       -> separable_sample_kernel
//   * _sep_bwd (body _sep_bwd_kernel) -> anchored_splat_rows_kernel, then
//       csrc/warp.cu's bilinear_splat_tiled_kernel for the exact branch
// The TPU kernels DMA a band of source rows per block of 8 target rows,
// resample it in y at one scalar tent per row (the row's anchor) on the
// VPU and in x on the MXU; the separability is what makes the MXU work
// small there. A GPU reads the two source rows each pixel needs directly,
// so here there is no band, and the anchored sample is a gather at
// (cx, anchor) with the JAX package's tent weights.
//
// What they compute (ops/warp_separable.py anchored_sample):
//   x = clamp(cx, 0, W_s-1), a = the row's anchor (clamped likewise),
//   x0 = floor(x), y0 = floor(a), x1 = min(x0+1, W_s-1), y1 likewise,
//   wx0 = 1-(x-x0), wx1 = 1-((x0+1)-x), wy0 = 1-(a-y0), wy1 = 1-((y0+1)-a)
//   out = (v00 wy0 + v10 wy1) wx0 + (v01 wy0 + v11 wy1) wx1  (y, then x)
// each product and sum rounded on its own (no FMA contraction), the same
// operation order as the plain PyTorch version.
//
// The guard is part of the function. The JAX package takes the anchored
// sample only inside its domain (the anchors' block span fits the band,
// sep_err <= warp_sep_tol) and the exact gather elsewhere (lax.cond). The
// decision is computed on the device by the wrapper (a 0-dim flag); the
// kernels read it through `ok` and run the anchored sample/splat or the
// exact gather/splat, whose rounding is that of csrc/warp.cu (and of the
// plain gather). No host read decides the branch.
//
// Design of the forward: the gather of csrc/warp.cu with cy replaced by
// the row anchor, one thread per (plane b', target pixel), looping over
// the C channels.
//
// Design of the backward, the adjoint of the branch the forward took
// (the coordinates get no gradient), two launches on the stream:
//   1. anchored_splat_rows_kernel, owner-computes: one block per (plane
//      b', source row r). On the anchored branch target row i reads only
//      source rows lo(i) = floor(a_i) and hi(i) = min(lo+1, H_s-1), with
//      one y weight pair per row, so the inverse map is cheap: the block
//      evaluates every row's Tent of its plane bit for bit and selects in
//      ascending i the rows with lo == r (weight w_lo) or hi == r (w_hi;
//      both at the bottom border, where lo == hi). For each selected row
//      it loads the row's cx and cotangent at once (all loads in flight
//      together, staged in shared memory), sorts the row's pixels by their
//      lo column (a counting sort with integer shared atomics), and each
//      column's owner thread sums the taps that land on it, (g w_x) w_y
//      each product rounded as the forward's adjoint, into a shared
//      [C][W_s] accumulator. The C rows of d_src[b', :, r, :] are written
//      once with plain coalesced stores: no zero fill, no atomics on floats
//      at all. Where `ok` is 0 the block writes zeros instead (the exact
//      branch's zero fill).
//   2. the exact branch: the tiled splat of csrc/warp.cu
//      (mtpu_bilinear_splat_acc, the same kernel code as the gather's
//      splat, bit for bit the same addends), given `ok` as its skip flag,
//      so every block returns at once on the anchored branch.
// Only the order of the f32 sums differs from the plain version.
//
// Bound on the card: bytes. At scale 0 of the LLFF train step (B'=64,
// C=7, 384x512) the anchored branch reads the source (0.35 GB), cx
// (0.05 GB) and the anchors (0.1 MB) and writes the output (0.35 GB):
// ~0.76 GB, ~0.23 ms at 3.35 TB/s; the gather branch reads cy instead of
// the anchors (+0.05 GB). The backward likewise, with the cotangent in
// the source's place. The anchored splat reads each target row twice
// (for its lo and its hi row; the second read mostly from L2, as blocks
// run in row order) and writes d_src once. Latency holds it back: a block
// handles its ~2 selected rows one after another, each a load, a sort and
// a sum between barriers, with 4 blocks resident on an SM (64 registers).
// The exact branch moves what csrc/warp.cu's splat moves (~1.5 GB), its
// zero fill done by the row kernel. ~10 flops a pixel and channel, far
// below the f32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  // a*(1-t) + b*t, each step rounded (the exact gather's lerp)
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, t)), __fmul_rn(b, t));
}

__device__ __forceinline__ float clamp_coord(float c, int size) {
  // ops/warp.py clamp_coords: NaN reads pixel 0
  return isnan(c) ? 0.0f : fminf(fmaxf(c, 0.0f), (float)(size - 1));
}

// One axis' two taps and tent weights: lo = floor(c), hi = min(lo+1,
// size-1), w_lo = 1-(c-lo), w_hi = 1-((lo+1)-c).
struct Tent {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ Tent tent(float c, int size) {
  const float f = floorf(c);
  Tent t;
  t.lo = (int)f;
  t.hi = min(t.lo + 1, size - 1);
  t.w_lo = __fsub_rn(1.0f, __fsub_rn(c, f));
  t.w_hi = __fsub_rn(1.0f, __fsub_rn(__fadd_rn(f, 1.0f), c));
  return t;
}

// The exact gather's taps: lo/hi as Tent, t = c - floor(c).
struct Lerp {
  int lo, hi;
  float t;
};

__device__ __forceinline__ Lerp lerp_taps(float c, int size) {
  const float f = floorf(c);
  Lerp l;
  l.lo = (int)f;
  l.hi = min(l.lo + 1, size - 1);
  l.t = __fsub_rn(c, f);
  return l;
}

__global__ void separable_sample_kernel(
    const float* __restrict__ src, const float* __restrict__ coords_x,
    const float* __restrict__ coords_y, const float* __restrict__ anchor,
    const int* __restrict__ ok, float* __restrict__ out, int C, int H_s,
    int W_s, int H_t, int64_t n_tgt, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / n_tgt;
  const int64_t p = i - b * n_tgt;
  const int64_t plane = (int64_t)H_s * W_s;
  const float* s = src + b * C * plane;
  float* o = out + b * C * n_tgt + p;
  const float x = clamp_coord(coords_x[i], W_s);

  if (*ok) {
    const int row = (int)(p / (n_tgt / H_t));
    const float a = clamp_coord(anchor[b * H_t + row], H_s);
    const Tent tx = tent(x, W_s);
    const Tent ty = tent(a, H_s);
    const int64_t o00 = (int64_t)ty.lo * W_s + tx.lo;
    const int64_t o10 = (int64_t)ty.hi * W_s + tx.lo;
    const int64_t o01 = (int64_t)ty.lo * W_s + tx.hi;
    const int64_t o11 = (int64_t)ty.hi * W_s + tx.hi;
    for (int c = 0; c < C; ++c) {
      const float t0 = __fadd_rn(__fmul_rn(__ldg(s + o00), ty.w_lo),
                                 __fmul_rn(__ldg(s + o10), ty.w_hi));
      const float t1 = __fadd_rn(__fmul_rn(__ldg(s + o01), ty.w_lo),
                                 __fmul_rn(__ldg(s + o11), ty.w_hi));
      o[(int64_t)c * n_tgt] =
          __fadd_rn(__fmul_rn(t0, tx.w_lo), __fmul_rn(t1, tx.w_hi));
      s += plane;
    }
  } else {
    const Lerp lx = lerp_taps(x, W_s);
    const Lerp ly = lerp_taps(clamp_coord(coords_y[i], H_s), H_s);
    const int64_t o00 = (int64_t)ly.lo * W_s + lx.lo;
    const int64_t o01 = (int64_t)ly.lo * W_s + lx.hi;
    const int64_t o10 = (int64_t)ly.hi * W_s + lx.lo;
    const int64_t o11 = (int64_t)ly.hi * W_s + lx.hi;
    for (int c = 0; c < C; ++c) {
      const float top = lerp_rn(__ldg(s + o00), __ldg(s + o01), lx.t);
      const float bot = lerp_rn(__ldg(s + o10), __ldg(s + o11), lx.t);
      o[(int64_t)c * n_tgt] = lerp_rn(top, bot, ly.t);
      s += plane;
    }
  }
}

constexpr int ROW_THREADS = 256;
constexpr int ROW_CHUNK = 512;     // target pixels of a row sorted at a time
constexpr int ROW_CHANNELS = 8;    // channels summed in registers a pass
constexpr int PER_THREAD = ROW_CHUNK / ROW_THREADS;

struct RowShared {
  int row[2 * ROW_THREADS];  // the selected target rows, ascending
  float wy[2 * ROW_THREADS];  // and their y weights
  int count[ROW_THREADS / 32];
  int order[ROW_CHUNK];  // a row chunk's pixels sorted by lo column
  float wlo[ROW_CHUNK];
  float whi[ROW_CHUNK];
  int dx[ROW_CHUNK];  // hi - lo
  float g[ROW_CHANNELS][ROW_CHUNK];
};
// the row kernel's dynamic shared memory in words, the sums [per_pass][wc]
// and the cell ranges [wc + 2]: what a block may hold without opting in
// to more than 48 KB, less RowShared
constexpr int ROW_SMEM_WORDS =
    (int)((48 * 1024 - sizeof(RowShared)) / sizeof(float));

// The anchored splat of one source row r of plane b per block (blockIdx.x
// = b*H_s + r); a pass covers per_pass channels and wc columns (all of
// them in one pass at the train step's widths).
__global__ void __launch_bounds__(ROW_THREADS) anchored_splat_rows_kernel(
    const float* __restrict__ g, const float* __restrict__ coords_x,
    const float* __restrict__ anchor, const int* __restrict__ ok,
    float* __restrict__ d_src, int C, int H_s, int W_s, int H_t, int W_t,
    int per_pass, int wc) {
  extern __shared__ float acc[];
  int* s_cell = reinterpret_cast<int*>(acc + per_pass * wc);
  __shared__ RowShared sh;

  const int b = blockIdx.x / H_s;
  const int r = blockIdx.x - b * H_s;
  const int64_t plane = (int64_t)H_s * W_s;
  const int64_t n_tgt = (int64_t)H_t * W_t;
  float* d = d_src + (int64_t)b * C * plane + (int64_t)r * W_s;
  if (!*ok) {  // the exact branch: its zero fill
    for (int c = 0; c < C; ++c)
      for (int x = threadIdx.x; x < W_s; x += ROW_THREADS)
        d[c * plane + x] = 0.0f;
    return;
  }
  const float* gb = g + (int64_t)b * C * n_tgt;
  const float* cxb = coords_x + (int64_t)b * n_tgt;
  const float* ab = anchor + (int64_t)b * H_t;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int c0 = 0; c0 < C; c0 += per_pass) {
    const int nc = min(per_pass, C - c0);
    for (int xc = 0; xc < W_s; xc += wc) {
      const int nx = min(wc, W_s - xc);
      for (int k = threadIdx.x; k < nc * wc; k += ROW_THREADS) acc[k] = 0.0f;
      for (int i0 = 0; i0 < H_t; i0 += ROW_THREADS) {
        // select the rows of this chunk that read source row r, in
        // ascending i (the lo entry of a row before its hi entry)
        const int i = i0 + threadIdx.x;
        bool e_lo = false, e_hi = false;
        float w_lo = 0.0f, w_hi = 0.0f;
        if (i < H_t) {
          const Tent ty = tent(clamp_coord(ab[i], H_s), H_s);
          e_lo = ty.lo == r;
          e_hi = ty.hi == r;
          w_lo = ty.w_lo;
          w_hi = ty.w_hi;
        }
        const unsigned m_lo = __ballot_sync(0xffffffffu, e_lo);
        const unsigned m_hi = __ballot_sync(0xffffffffu, e_hi);
        const unsigned below = (1u << lane) - 1u;
        int pos = __popc(m_lo & below) + __popc(m_hi & below);
        if (lane == 0) sh.count[warp] = __popc(m_lo) + __popc(m_hi);
        __syncthreads();
        int total = 0;
        for (int w = 0; w < ROW_THREADS / 32; ++w) {
          const int n = sh.count[w];
          pos += w < warp ? n : 0;
          total += n;
        }
        if (e_lo) {
          sh.row[pos] = i;
          sh.wy[pos] = w_lo;
        }
        if (e_hi) {
          sh.row[pos + e_lo] = i;
          sh.wy[pos + e_lo] = w_hi;
        }
        __syncthreads();
        // x-splat each selected row, owner-computes: sort the row's pixels
        // by their lo column (a counting sort with integer shared
        // atomics); column u sums the taps of the pixels with lo == u
        // (w_lo, and w_hi where hi == lo at the border) and lo == u - 1
        // (w_hi): d v(r, u) += (g w_x) w_y
        for (int k = 0; k < total; ++k) {
          const float wy = sh.wy[k];
          const int64_t row = (int64_t)sh.row[k] * W_t;
          for (int j0 = 0; j0 < W_t; j0 += ROW_CHUNK) {
            const int nj = min(ROW_CHUNK, W_t - j0);
            const float* gr = gb + (int64_t)c0 * n_tgt + row + j0;
            // this chunk's cx and cotangent, every load in flight at once
            float cxv[PER_THREAD], gv[PER_THREAD][ROW_CHANNELS];
#pragma unroll
            for (int m = 0; m < PER_THREAD; ++m) {
              const int jj = threadIdx.x + m * ROW_THREADS;
              const bool in = jj < nj;
              cxv[m] = in ? __ldg(cxb + row + j0 + jj) : 0.0f;
#pragma unroll
              for (int c = 0; c < ROW_CHANNELS; ++c)
                gv[m][c] = in && c < nc ? __ldg(gr + (int64_t)c * n_tgt + jj)
                                        : 0.0f;
            }
            // cell lo - (xc - 1) in [0, nx]; s_cell[cell + 1] counts it
            for (int q = threadIdx.x; q < nx + 2; q += ROW_THREADS)
              s_cell[q] = 0;
            __syncthreads();
            int cells[PER_THREAD], ranks[PER_THREAD];
#pragma unroll
            for (int m = 0; m < PER_THREAD; ++m) {
              const int jj = threadIdx.x + m * ROW_THREADS;
              cells[m] = -1;
              if (jj >= nj) continue;
#pragma unroll
              for (int c = 0; c < ROW_CHANNELS; ++c) sh.g[c][jj] = gv[m][c];
              const Tent tx = tent(clamp_coord(cxv[m], W_s), W_s);
              sh.wlo[jj] = tx.w_lo;
              sh.whi[jj] = tx.w_hi;
              sh.dx[jj] = tx.hi - tx.lo;
              const int cell = tx.lo - xc + 1;
              if (cell < 0 || cell > nx) continue;
              cells[m] = cell;
              ranks[m] = atomicAdd(&s_cell[cell + 1], 1);
            }
            __syncthreads();
            block_inclusive_scan<ROW_THREADS>(s_cell, nx + 2, sh.count);
#pragma unroll
            for (int m = 0; m < PER_THREAD; ++m)
              if (cells[m] >= 0)
                sh.order[s_cell[cells[m]] + ranks[m]] =
                    threadIdx.x + m * ROW_THREADS;
            __syncthreads();
            for (int x = threadIdx.x; x < nx; x += ROW_THREADS) {
              float sum[ROW_CHANNELS];
#pragma unroll
              for (int c = 0; c < ROW_CHANNELS; ++c) sum[c] = 0.0f;
              // cell x + 1: lo == u; cell x: lo == u - 1
#pragma unroll
              for (int from = 0; from < 2; ++from) {
                const int qc = x + 1 - from;
                for (int e = s_cell[qc]; e < s_cell[qc + 1]; ++e) {
                  const int jj = sh.order[e];
                  const int dx = sh.dx[jj];
                  // the taps of pixel jj on u: lo (from 0), hi (hi - lo
                  // == from)
#pragma unroll
                  for (int tap = 0; tap < 2; ++tap) {
                    if ((tap ? dx : 0) != from) continue;
                    const float wx = tap ? sh.whi[jj] : sh.wlo[jj];
#pragma unroll
                    for (int c = 0; c < ROW_CHANNELS; ++c)
                      if (c < nc)
                        sum[c] = __fadd_rn(
                            sum[c], __fmul_rn(__fmul_rn(sh.g[c][jj], wx), wy));
                  }
                }
              }
#pragma unroll
              for (int c = 0; c < ROW_CHANNELS; ++c)
                if (c < nc)
                  acc[c * wc + x] = __fadd_rn(acc[c * wc + x], sum[c]);
            }
            __syncthreads();  // the cell ranges and sh.order are rewritten
          }
        }
      }
      for (int c = 0; c < nc; ++c)
        for (int x = threadIdx.x; x < nx; x += ROW_THREADS)
          d[(c0 + c) * plane + xc + x] = acc[c * wc + x];
      __syncthreads();  // the next pass zeroes acc again
    }
  }
}

}  // namespace

// src [Bp, C, H_s, W_s], coords_x/coords_y [Bp, H_t, W_t], anchor
// [Bp, H_t], out [Bp, C, H_t, W_t] float32; ok one int32 (0: the exact
// gather, else the anchored sample); all contiguous on the current device.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mtpu_separable_sample(const void* src, const void* coords_x,
                                     const void* coords_y, const void* anchor,
                                     const void* ok, void* out, int Bp, int C,
                                     int H_s, int W_s, int H_t, int W_t,
                                     void* stream) {
  const int64_t n_tgt = (int64_t)H_t * W_t;
  const int64_t total = (int64_t)Bp * n_tgt;
  if (total > 0) {
    const int threads = 256;
    const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
    separable_sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)src, (const float*)coords_x, (const float*)coords_y,
        (const float*)anchor, (const int*)ok, (float*)out, C, H_s, W_s, H_t,
        n_tgt, total);
  }
  return (int)cudaGetLastError();
}

// The exact splat of csrc/warp.cu into d_src, without its zero fill;
// blocks return at once where *skip is nonzero.
extern "C" int mtpu_bilinear_splat_acc(const void* g, const void* coords_x,
                                       const void* coords_y, const void* skip,
                                       void* d_src, int Bp, int C, int H_s,
                                       int W_s, int H_t, int W_t,
                                       void* stream);

// g [Bp, C, H_t, W_t] (cotangent of the sample's output), the sample's
// coords, anchor and ok, d_src [Bp, C, H_s, W_s]; float32, contiguous, on
// the current device. The row kernel writes every element of d_src (the
// anchored splat where ok, zeros where not), then the exact splat adds
// into it where not ok. Returns the first CUDA error of the two launches
// (0 = launched).
extern "C" int mtpu_separable_splat(const void* g, const void* coords_x,
                                    const void* coords_y, const void* anchor,
                                    const void* ok, void* d_src, int Bp, int C,
                                    int H_s, int W_s, int H_t, int W_t,
                                    void* stream) {
  const int64_t rows = (int64_t)Bp * H_s;
  if (rows > 0 && C > 0 && W_s > 0) {
    // wc columns a pass: the sums of at least one channel and the wc + 2
    // cell ranges fit ROW_SMEM_WORDS
    const int wc = min(W_s, (ROW_SMEM_WORDS - 2) / 2);
    const int per_pass =
        min(min(C, ROW_CHANNELS), (ROW_SMEM_WORDS - 2 - wc) / wc);
    anchored_splat_rows_kernel<<<(unsigned int)rows, ROW_THREADS,
                                 (per_pass * wc + wc + 2) * sizeof(int),
                                 (cudaStream_t)stream>>>(
        (const float*)g, (const float*)coords_x, (const float*)anchor,
        (const int*)ok, (float*)d_src, C, H_s, W_s, H_t, W_t, per_pass, wc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return mtpu_bilinear_splat_acc(g, coords_x, coords_y, ok, d_src, Bp, C, H_s,
                                 W_s, H_t, W_t, stream);
}
