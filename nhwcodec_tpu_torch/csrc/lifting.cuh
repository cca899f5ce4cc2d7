// 5/3 lifting synthesis arithmetic shared by the kernels of dwt.cu.
//
// One row of length 2m holds its low band L[0..m) and high band H[0..m).
// Output pair k (out[2k], out[2k+1]) reads only L[k..k+1] and H[k-1..k+1],
// so a row pass is fully parallel over k (decoder/filters.c:143-194,
// nhwcodec_tpu/ops/pallas_dwt.py:30-57).  All arithmetic is int32 and
// wraps to int16 exactly where the reference stores into `short`.
#pragma once

#include <cstdint>

namespace nhw {

__device__ __forceinline__ int wrap16(int x) {
  return ((x + 32768) & 65535) - 32768;
}

// Arithmetic shift right written without relying on implementation-defined
// behaviour: floor(x / 2^s) for every int x.
__device__ __forceinline__ int asr(int x, int s) {
  return x >= 0 ? (x >> s) : ~((~x) >> s);
}

// upfilter53I + upfilter53III for output pair k of a row of m pairs, read
// through a window of it: L[k + d] is Ls[i + d] and H[k + d] is Hs[i + d]
// (d in -1..1; L[k + 1] only for k < m - 1, H[k - 1] only for k > 0,
// H[k + 1] only for k < m - 1).  The wrapped un-normalised even (out[2k])
// and odd (out[2k+1]) values.  Ls and Hs may point to shared or global
// memory.
__device__ __forceinline__ void unnorm_pair_at(const int16_t* Ls,
                                               const int16_t* Hs, int m, int k,
                                               int i, int& even, int& odd) {
  const int lk = Ls[i];
  const int hk = Hs[i];
  const int e = wrap16(lk * 8);
  const int o = wrap16(k < m - 1 ? (Ls[i + 1] + lk) * 4 : lk * 8);
  const int sub_even = k == 0 ? hk * 4 : (hk + Hs[i - 1]) * 2;
  int add_odd;
  if (k == 0) {
    add_odd = 5 * hk - Hs[i + 1];   // H[1]
  } else if (k == m - 1) {
    add_odd = 5 * hk - Hs[i - 1];   // H[m - 2]
  } else {
    add_odd = 6 * hk - Hs[i + 1] - Hs[i - 1];
  }
  even = wrap16(e - sub_even);
  odd = wrap16(o + add_odd);
}

// The same on a whole row: L[0..m) and H[0..m).
__device__ __forceinline__ void unnorm_pair(const int16_t* L, const int16_t* H,
                                            int m, int k, int& even,
                                            int& odd) {
  unnorm_pair_at(L, H, m, k, k, even, odd);
}

// upfilter53VI on one un-normalised value: +32 on positives, then /64.
__device__ __forceinline__ int norm_value(int t) {
  return asr(wrap16(t > 0 ? t + 32 : t), 6);
}

}  // namespace nhw
