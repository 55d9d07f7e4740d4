// A block-wide inclusive prefix sum over an int array in shared memory,
// used by the splats' counting sorts (csrc/warp.cu, csrc/warp_sep.cu).
#pragma once

// a[0..n) <- its inclusive prefix sums. Every thread of the block (THREADS
// of them) calls it; s_warp holds one int a warp. Ends in __syncthreads.
template <int THREADS>
__device__ void block_inclusive_scan(int* a, int n, int* s_warp) {
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = min(n, (int)threadIdx.x * per);
  const int hi = min(n, lo + per);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += a[k];
  const int lane = threadIdx.x & 31;
  int incl = sum;  // inclusive scan of the threads' sums within the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[threadIdx.x >> 5] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < (int)(threadIdx.x >> 5); ++w) run += s_warp[w];
  for (int k = lo; k < hi; ++k) {
    run += a[k];
    a[k] = run;
  }
  __syncthreads();
}
