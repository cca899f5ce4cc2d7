// Block-wide helpers shared by the encode scans' kernels (scans.cu, ll2.cu,
// uv.cu), whose CTAs walk a row's positions a thread each.
#pragma once

#include <cuda_runtime.h>

namespace nhw {

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }

// fired = f and an even offset within f's run, over the CTA's threads in
// order (thread j = position j, blockDim.x a multiple of 32): the greedy
// rule that fires and skips the next position, over a static predicate.
// The run starts are a block max-scan of warp ballots; warp_last:
// blockDim.x / 32 ints of shared memory.  Every thread of the CTA calls it.
__device__ __forceinline__ bool run_parity_block(bool f, int* warp_last) {
  const int j = threadIdx.x, lane = j & 31, w = j >> 5;
  const unsigned nf = __ballot_sync(0xFFFFFFFFu, !f);
  if (lane == 0) warp_last[w] = nf ? w * 32 + 31 - __clz(nf) : -1;
  __syncthreads();
  const unsigned le = nf & (lane == 31 ? 0xFFFFFFFFu : ((2u << lane) - 1u));
  int last = -1;
  if (le) {
    last = w * 32 + 31 - __clz(le);
  } else {
    for (int k = 0; k < w; ++k) last = max(last, warp_last[k]);
  }
  __syncthreads();
  return f && ((j - (last + 1)) & 1) == 0;
}

}  // namespace nhw
