// Bilinear gather of a plane volume at per-pixel source coordinates, and
// its adjoint, the bilinear splat.
//
// The gather replaces the Pallas TPU kernel mine_tpu/kernels/warp.py:
// pallas_bilinear_sample (body _warp_kernel). That kernel DMAs a row band of
// the source into VMEM and turns the gather into tent-weight matmuls, which
// is exact only while a row block's source span fits the band. A GPU reads
// scattered addresses through L1/L2 directly, so this kernel is a plain
// gather with no band, exact for every pose, and needs no domain guard.
//
// What it computes (ops/warp.py _lerp_gather, border clamp):
//   x = clamp(cx, 0, W_s-1), y = clamp(cy, 0, H_s-1)
//   x0 = floor(x), x1 = min(x0+1, W_s-1) (y likewise), tx = x-x0, ty = y-y0
//   out = (v00(1-tx) + v01 tx)(1-ty) + (v10(1-tx) + v11 tx) ty
// Each product and sum is rounded on its own (no FMA contraction), the
// same operation order as the plain PyTorch version, so the two agree to
// the last bit.
//
// Design: one thread per (plane b', target pixel), looping over the C
// channels of that plane. The coordinates are read once per thread and the
// four tap offsets reused for every channel. Consecutive threads take
// consecutive target pixels, so coordinate loads and output stores coalesce;
// the taps land near each other for smooth warps and are served by L2.
//
// Bound on the card: bytes. At one 8-pose LLFF bucket (B'=256, C=7,
// 384x512) the source and output are 1.41 GB each and the coordinates
// 0.40 GB: ~3.22 GB, ~0.96 ms at 3.35 TB/s. The arithmetic (~30 flops a
// pixel and channel) is far below the f32 rate.
//
// The splat replaces the Pallas TPU kernel mine_tpu/kernels/warp_vjp.py:
// _warp_bwd (body _bwd_splat_kernel), the backward of the training warp.
// The TPU kernel walks the forward's target-row bands and contracts tent
// weights against the cotangent on the MXU, accumulating a full-height
// d_src block resident in VMEM. Blocks on the GPU run in no order, so here
// the adjoint is a scatter-add of each target pixel's four weighted taps
// into d_src, zeroed first: the same taps and weights as the gather (same
// clamp, floor and border duplicates; coinciding border taps add), each
// weight autograd's of the gather's lerps,
//   d v00 = (g(1-ty))(1-tx)  d v01 = (g(1-ty))tx
//   d v10 = (g ty)(1-tx)     d v11 = (g ty)tx
// each product rounded on its own. The coordinates get no gradient.
//
// Design: the splat is tiled so that most of the adding happens in shared
// memory, without float atomics there (on sm_90 a shared-memory float
// atomicAdd is a compare-and-swap loop). One block of 256 threads takes a
// tile of 8 target rows x 32 columns of one plane b' (the grid is
// plane-major, raster within the plane, so tiles whose windows share an
// edge run close in time and their flushes meet in L2). Each thread loads
// its pixel's coordinates and, with them, its cotangent (the two loads'
// latencies overlap), computes the four taps, and the block reduces
// the taps' bounding box with warp reductions. If the box fits a window of
// at most 24 x 64 source pixels (its x extent rounded out to 16 bytes),
// the block sorts its pixels by the window cell of their (y0, x0) tap (a
// counting sort with integer shared atomics and a block scan), and each
// window pixel's owner thread sums, in registers, the taps that land on it
// from at most four cells (as many channels a pass as 24 KB holds). The
// window is flushed into d_src with one global vector atomic (sm_90's
// float4 atomicAdd) per 4 window pixels and channel, coalesced along the
// window's rows. For near-identity training poses the window is ~9 x 36
// pixels for 256 target pixels: the global atomics fall from 4 per target
// pixel and channel to ~0.3 vector atomics. A tile whose box does not fit
// (a strong zoom-out, NaN or far-out coordinates that spread its taps) adds
// its taps straight into d_src with scalar global atomics, as a
// one-thread-a-pixel splat would; that route is part of the function
// (kernels/warp.py splat_wide_tiles counts it in plain torch). Only the
// order of the f32 sums differs from the plain version (and varies from
// run to run): the splat is held to it at a tolerance, not bitwise. The
// same kernel runs the exact branch of the separable splat
// (csrc/warp_sep.cu) through mtpu_bilinear_splat_acc, with a device flag
// that makes every block return at once.
//
// Bound on the card: bytes. At scale 0 of the LLFF train step (B'=64,
// C=7, 384x512) the cotangent and d_src are 0.35 GB each and the
// coordinates 0.10 GB: ~0.80 GB, ~0.24 ms at 3.35 TB/s. This design moves
// more: the zero fill writes d_src once more (a pass of its own),
// and the flush's atomics read d_src back from HBM (d_src is 7x the 50 MB
// L2) and write it again, ~1.5 GB in all. What holds it further back is
// latency, not bytes: a block's phases (loads, box, sort, sums, flush) run
// one after another between barriers, with 4 blocks resident on an SM
// (43 KB of shared memory, 48 registers), so too few loads are in flight.
// Keeping the next tile's loads in flight in a persistent block was
// slower (register pressure), as was a one-thread-a-pixel splat that
// merges coinciding taps through warp shuffles before its global atomics:
// L2's atomic sector throughput bounds that form, however few atomics it
// sends.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  // a*(1-t) + b*t, each step rounded (matches the unfused plain version)
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, t)), __fmul_rn(b, t));
}

__global__ void bilinear_sample_kernel(const float* __restrict__ src,
                                       const float* __restrict__ coords_x,
                                       const float* __restrict__ coords_y,
                                       float* __restrict__ out, int C,
                                       int H_s, int W_s, int64_t n_tgt,
                                       int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / n_tgt;
  const int64_t p = i - b * n_tgt;

  const float x = fminf(fmaxf(coords_x[i], 0.0f), (float)(W_s - 1));
  const float y = fminf(fmaxf(coords_y[i], 0.0f), (float)(H_s - 1));
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float tx = __fsub_rn(x, x0f);
  const float ty = __fsub_rn(y, y0f);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = min(x0 + 1, W_s - 1);
  const int y1 = min(y0 + 1, H_s - 1);

  const int64_t plane = (int64_t)H_s * W_s;
  const int64_t o00 = (int64_t)y0 * W_s + x0;
  const int64_t o01 = (int64_t)y0 * W_s + x1;
  const int64_t o10 = (int64_t)y1 * W_s + x0;
  const int64_t o11 = (int64_t)y1 * W_s + x1;
  const float* s = src + b * C * plane;
  float* o = out + b * C * n_tgt + p;
  for (int c = 0; c < C; ++c) {
    const float top = lerp_rn(__ldg(s + o00), __ldg(s + o01), tx);
    const float bot = lerp_rn(__ldg(s + o10), __ldg(s + o11), tx);
    o[(int64_t)c * n_tgt] = lerp_rn(top, bot, ty);
    s += plane;
  }
}

// the tiled splat's geometry (kernels/warp.py SPLAT_TILE, SPLAT_WINDOW
// mirror it for the plain count of wide tiles)
constexpr int TILE_H = 8;
constexpr int TILE_W = 32;
constexpr int SPLAT_THREADS = TILE_H * TILE_W;
constexpr int WIN_PIXELS = 24 * 64;   // the window budget, in source pixels
constexpr int WIN_FLOATS = 6144;      // the window's sums: 24 KB
constexpr int PASS_CHANNELS = 8;      // channels summed in registers a pass

__global__ void __launch_bounds__(SPLAT_THREADS) bilinear_splat_tiled_kernel(
    const float* __restrict__ g, const float* __restrict__ coords_x,
    const float* __restrict__ coords_y, const int* __restrict__ skip,
    float* __restrict__ d_src, int C, int H_s, int W_s, int H_t, int W_t,
    int tiles_x, int tiles_per_plane, int vec4) {
  if (skip != nullptr && *skip) return;  // the separable splat's other branch
  __shared__ __align__(16) float win[WIN_FLOATS];
  __shared__ float s_g[PASS_CHANNELS][SPLAT_THREADS];
  __shared__ float s_tx[SPLAT_THREADS];
  __shared__ float s_ty[SPLAT_THREADS];
  __shared__ int s_dxy[SPLAT_THREADS];  // (x1-x0) << 1 | (y1-y0)
  __shared__ int s_order[SPLAT_THREADS];
  __shared__ int s_cell[WIN_PIXELS + 1];
  __shared__ int s_red[4][SPLAT_THREADS / 32];

  const int b = blockIdx.x / tiles_per_plane;
  const int tile = blockIdx.x - b * tiles_per_plane;
  const int tile_y = tile / tiles_x;
  const int i = tile_y * TILE_H + (threadIdx.x >> 5);
  const int j = (tile - tile_y * tiles_x) * TILE_W + (threadIdx.x & 31);
  const bool valid = i < H_t && j < W_t;
  const int64_t n_tgt = (int64_t)H_t * W_t;
  const int64_t plane = (int64_t)H_s * W_s;
  const int64_t p = (int64_t)i * W_t + j;
  const float* gp = g + (int64_t)b * C * n_tgt + p;
  // the cotangent of the first pass's channels, loaded with the
  // coordinates: the two loads' latencies overlap
  float g_first[PASS_CHANNELS];
#pragma unroll
  for (int c = 0; c < PASS_CHANNELS; ++c)
    g_first[c] = valid && c < C ? __ldg(gp + (int64_t)c * n_tgt) : 0.0f;

  // the gather's taps, bit for bit
  int x0 = 0, x1 = 0, y0 = 0, y1 = 0;
  float tx = 0.0f, ty = 0.0f;
  if (valid) {
    const int64_t ci = (int64_t)b * n_tgt + p;
    const float x = fminf(fmaxf(coords_x[ci], 0.0f), (float)(W_s - 1));
    const float y = fminf(fmaxf(coords_y[ci], 0.0f), (float)(H_s - 1));
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    tx = __fsub_rn(x, x0f);
    ty = __fsub_rn(y, y0f);
    x0 = (int)x0f;
    y0 = (int)y0f;
    x1 = min(x0 + 1, W_s - 1);
    y1 = min(y0 + 1, H_s - 1);
  }
  const float tx1 = __fsub_rn(1.0f, tx);
  const float ty1 = __fsub_rn(1.0f, ty);

  // the taps' bounding box (x1 >= x0, y1 >= y0); every tile has a valid
  // pixel. Maxima as minima of negated values.
  const int warp = threadIdx.x >> 5;
  const int red[4] = {valid ? x0 : INT_MAX, valid ? -x1 : INT_MAX,
                      valid ? y0 : INT_MAX, valid ? -y1 : INT_MAX};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = __reduce_min_sync(0xffffffffu, red[k]);
    if ((threadIdx.x & 31) == 0) s_red[k][warp] = m;
  }
  __syncthreads();
  int box[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    box[k] = s_red[k][0];
    for (int w = 1; w < SPLAT_THREADS / 32; ++w)
      box[k] = min(box[k], s_red[k][w]);
  }
  const int by0 = box[2];
  int wx0 = box[0], wx1 = 1 - box[1];  // window columns [wx0, wx1)
  if (vec4) {
    wx0 &= ~3;
    wx1 = (wx1 + 3) & ~3;
  }
  const int ww = wx1 - wx0;
  const int wh = 1 - box[3] - by0;
  float* d = d_src + (int64_t)b * C * plane;

  if (ww > WIN_PIXELS || wh > WIN_PIXELS || ww * wh > WIN_PIXELS) {
    // the wide route: this tile's taps straight into d_src
    if (!valid) return;
    const int64_t o00 = (int64_t)y0 * W_s + x0;
    const int64_t o01 = (int64_t)y0 * W_s + x1;
    const int64_t o10 = (int64_t)y1 * W_s + x0;
    const int64_t o11 = (int64_t)y1 * W_s + x1;
    for (int c = 0; c < C; ++c) {
      const float gv = __ldg(gp + (int64_t)c * n_tgt);
      const float gt = __fmul_rn(gv, ty1);
      const float gb = __fmul_rn(gv, ty);
      atomicAdd(d + o00, __fmul_rn(gt, tx1));
      atomicAdd(d + o01, __fmul_rn(gt, tx));
      atomicAdd(d + o10, __fmul_rn(gb, tx1));
      atomicAdd(d + o11, __fmul_rn(gb, tx));
      d += plane;
    }
    return;
  }

  // The window route, owner-computes: sort the tile's pixels by the
  // window cell of their (y0, x0) tap (a counting sort with integer
  // shared atomics), then each window pixel sums the taps that land on it
  // from at most four cells, in registers, and is written by its owner
  // thread alone: no float atomics in shared memory.
  const int pix = ww * wh;
  for (int k = threadIdx.x; k <= pix; k += SPLAT_THREADS) s_cell[k] = 0;
  s_tx[threadIdx.x] = tx;
  s_ty[threadIdx.x] = ty;
  s_dxy[threadIdx.x] = (x1 - x0) << 1 | (y1 - y0);
  __syncthreads();
  const int cell = (y0 - by0) * ww + (x0 - wx0);
  // s_cell[q + 1] counts cell q; its inclusive scan gives each cell's
  // range [s_cell[q], s_cell[q + 1]) in s_order
  const int rank = valid ? atomicAdd(&s_cell[cell + 1], 1) : 0;
  __syncthreads();
  block_inclusive_scan<SPLAT_THREADS>(s_cell, pix + 1, s_red[0]);
  if (valid) s_order[s_cell[cell] + rank] = threadIdx.x;
  const int per_pass = min(min(C, PASS_CHANNELS), WIN_FLOATS / pix);  // >= 4
  for (int c0 = 0; c0 < C; c0 += per_pass) {
    const int nc = min(per_pass, C - c0);
    if (c0 == 0) {
#pragma unroll
      for (int c = 0; c < PASS_CHANNELS; ++c)
        if (c < nc) s_g[c][threadIdx.x] = g_first[c];
    } else {
      for (int c = 0; c < nc; ++c)
        s_g[c][threadIdx.x] = valid ? __ldg(gp + (int64_t)(c0 + c) * n_tgt)
                                    : 0.0f;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < pix; q += SPLAT_THREADS) {
      const int v = q / ww;
      const int u = q - v * ww;
      float acc[PASS_CHANNELS];
#pragma unroll
      for (int c = 0; c < PASS_CHANNELS; ++c) acc[c] = 0.0f;
      // the cells whose pixels can tap (v, u): their (y0, x0) is (v, u),
      // (v, u-1), (v-1, u) or (v-1, u-1); tap (y0 + dy_t, x0 + dx_t) lands
      // here when that is (v, u)
#pragma unroll
      for (int from = 0; from < 4; ++from) {
        const int fy = from >> 1, fx = from & 1;
        if (v < fy || u < fx) continue;
        const int qc = q - fy * ww - fx;
        for (int e = s_cell[qc]; e < s_cell[qc + 1]; ++e) {
          const int k = s_order[e];
          const int dxy = s_dxy[k];
          const int dx = dxy >> 1, dy = dxy & 1;
          const float kt = s_tx[k], ky = s_ty[k];
          const float kt1 = __fsub_rn(1.0f, kt), ky1 = __fsub_rn(1.0f, ky);
          // the taps (ty_sel, tx_sel) of pixel k that land on (v, u)
#pragma unroll
          for (int tap = 0; tap < 4; ++tap) {
            const int ty_t = tap >> 1, tx_t = tap & 1;
            if ((ty_t ? dy : 0) != fy || (tx_t ? dx : 0) != fx) continue;
            const float wy = ty_t ? ky : ky1;
            const float wx = tx_t ? kt : kt1;
#pragma unroll
            for (int c = 0; c < PASS_CHANNELS; ++c)
              if (c < nc)
                acc[c] = __fadd_rn(acc[c],
                                   __fmul_rn(__fmul_rn(s_g[c][k], wy), wx));
          }
        }
      }
#pragma unroll
      for (int c = 0; c < PASS_CHANNELS; ++c)
        if (c < nc) win[c * pix + q] = acc[c];
    }
    __syncthreads();
    // flush: one global add per window pixel (4 with vec4) and channel,
    // window pixels that took no tap skipped
    float* dc = d + (int64_t)c0 * plane + (int64_t)by0 * W_s + wx0;
    if (vec4) {
      const int qw = ww >> 2;
      const int nq = qw * wh;
      for (int k = threadIdx.x; k < nc * nq; k += SPLAT_THREADS) {
        const int c = k / nq;
        const int q = k - c * nq;
        const int r = q / qw;
        const int col = (q - r * qw) << 2;
        const float4 v =
            *reinterpret_cast<const float4*>(win + c * pix + r * ww + col);
        if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
          atomicAdd(reinterpret_cast<float4*>(dc + c * plane +
                                              (int64_t)r * W_s + col),
                    v);
      }
    } else {
      for (int k = threadIdx.x; k < nc * pix; k += SPLAT_THREADS) {
        const int c = k / pix;
        const int q = k - c * pix;
        const int r = q / ww;
        const float v = win[k];
        if (v != 0.0f)
          atomicAdd(dc + c * plane + (int64_t)r * W_s + (q - r * ww), v);
      }
    }
    __syncthreads();  // the next pass rewrites s_g and the window
  }
}

}  // namespace

// src [Bp, C, H_s, W_s], coords_x/coords_y [Bp, H_t, W_t], out
// [Bp, C, H_t, W_t]; all float32, contiguous, on the current device.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mtpu_bilinear_sample(const void* src, const void* coords_x,
                                    const void* coords_y, void* out, int Bp,
                                    int C, int H_s, int W_s, int H_t, int W_t,
                                    void* stream) {
  const int64_t n_tgt = (int64_t)H_t * W_t;
  const int64_t total = (int64_t)Bp * n_tgt;
  if (total > 0) {
    const int threads = 256;
    const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
    bilinear_sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)src, (const float*)coords_x, (const float*)coords_y,
        (float*)out, C, H_s, W_s, n_tgt, total);
  }
  return (int)cudaGetLastError();
}

// g [Bp, C, H_t, W_t] (cotangent of the gather's output), coords_x/coords_y
// [Bp, H_t, W_t], d_src [Bp, C, H_s, W_s]; all float32, contiguous, on the
// current device. Adds the splat into d_src (no zero fill); skip is a
// device int, or null: where it is nonzero every block returns at once.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mtpu_bilinear_splat_acc(const void* g, const void* coords_x,
                                       const void* coords_y, const void* skip,
                                       void* d_src, int Bp, int C, int H_s,
                                       int W_s, int H_t, int W_t,
                                       void* stream) {
  const int tiles_x = (W_t + TILE_W - 1) / TILE_W;
  const int tiles_y = (H_t + TILE_H - 1) / TILE_H;
  const int64_t blocks = (int64_t)Bp * tiles_x * tiles_y;
  if (blocks > 0 && C > 0) {
    // float4 atomics need 16-byte aligned rows of d_src
    const int vec4 = W_s % 4 == 0 && (uintptr_t)d_src % 16 == 0;
    bilinear_splat_tiled_kernel<<<(unsigned int)blocks, SPLAT_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        (const float*)g, (const float*)coords_x, (const float*)coords_y,
        (const int*)skip, (float*)d_src, C, H_s, W_s, H_t, W_t, tiles_x,
        tiles_x * tiles_y, vec4);
  }
  return (int)cudaGetLastError();
}

// As mtpu_bilinear_splat_acc, into d_src zeroed first on the stream.
// Returns the first CUDA error of the two (0 = launched).
extern "C" int mtpu_bilinear_splat(const void* g, const void* coords_x,
                                   const void* coords_y, void* d_src, int Bp,
                                   int C, int H_s, int W_s, int H_t, int W_t,
                                   void* stream) {
  const size_t src_bytes = (size_t)Bp * C * H_s * W_s * sizeof(float);
  cudaError_t err = cudaMemsetAsync(d_src, 0, src_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return mtpu_bilinear_splat_acc(g, coords_x, coords_y, nullptr, d_src, Bp, C,
                                 H_s, W_s, H_t, W_t, stream);
}
