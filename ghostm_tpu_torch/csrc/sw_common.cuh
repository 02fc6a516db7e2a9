// Pieces shared by the banded Smith-Waterman kernels B3 (sw_fused.cu),
// B5 (sw_scored.cu) and B6 (sw_wave.cu): the cell sentinels, the int8 tile
// widening, the row step of the row-scan kernels and the _finalize
// tie-break (max score, then min i, then min b; (-1, -1) when the score is
// <= 0), all as in kernels/sw_xla.py.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define NEG (-(1 << 30))
#define MASKED_I8 (-128)
#define FULL 0xffffffffu

// A score-tile value as the DP uses it: an int8 tile's MASKED_I8 becomes
// NEG; an int32 tile's values (LOW cells included) are taken as they are.
__device__ __forceinline__ int widen(int8_t v) {
  return v == MASKED_I8 ? NEG : (int)v;
}
__device__ __forceinline__ int widen(int32_t v) { return v; }

// One row of the banded DP (sw_xla._row_step) for a warp whose lane owns
// the D diagonals b = lane * D + d; s holds this row's scores (NEG past B).
//   F from diagonal b + 1 of the previous row (__shfl_down_sync),
//   E by an exact prefix max over Ht[b'] + b' * ge (__shfl_up_sync scan),
//   the per-diagonal best with the first row on a strict '>'.
template <int D>
__device__ __forceinline__ void sw_row_step(int (&H)[D], int (&F)[D],
                                            int (&bH)[D], int (&bI)[D],
                                            const int (&s)[D], int i,
                                            int lane, int B, int go1,
                                            int ge) {
  // diagonal b + 1 of the previous row: own next diagonal, or lane + 1's
  const int Hup = __shfl_down_sync(FULL, H[0], 1);
  const int Fup = __shfl_down_sync(FULL, F[0], 1);
  int Fn[D], Ht[D], loc[D];
  int run = NEG;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int b = lane * D + d;
    int h1 = d + 1 < D ? H[d + 1] : Hup;
    int f1 = d + 1 < D ? F[d + 1] : Fup;
    if (b + 1 >= B) {
      h1 = NEG;
      f1 = NEG;
    }
    Fn[d] = max(h1 - go1, f1 - ge);
    Ht[d] = max(max(H[d] + s[d], Fn[d]), 0);
    run = max(run, b < B ? Ht[d] + b * ge : NEG);
    loc[d] = run;  // inclusive prefix max within the lane
  }
  // inclusive warp scan of the lane maxima, then exclusive for this lane
  int incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl = max(incl, o);
  }
  int excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = NEG;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int b = lane * D + d;
    const int P = d == 0 ? excl : max(excl, loc[d - 1]);
    const int E = P - (go1 + (b - 1) * ge);
    const int Hn = max(Ht[d], E);
    if (b < B && Hn > bH[d]) {
      bH[d] = Hn;
      bI[d] = i;
    }
    H[d] = Hn;
    F[d] = Fn[d];
  }
}

// _finalize over the K per-lane candidates (best H, its row, its diagonal
// bb; entries with bb >= B are ignored) of a group of `width` lanes (a
// power of two <= 32, aligned within the warp). Every lane of the group
// gets the result.
template <int K>
__device__ __forceinline__ void sw_finalize(const int (&bH)[K],
                                            const int (&bI)[K],
                                            const int (&bb)[K], int B,
                                            int width, int& score, int& iend,
                                            int& bend) {
  int best = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (bb[k] < B) best = max(best, bH[k]);
  for (int off = width >> 1; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(FULL, best, off, width));
  int ci = 1 << 30;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (bb[k] < B && bH[k] == best) ci = min(ci, bI[k]);
  for (int off = width >> 1; off > 0; off >>= 1)
    ci = min(ci, __shfl_xor_sync(FULL, ci, off, width));
  int cb = 1 << 30;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (bb[k] < B && bH[k] == best && bI[k] == ci) cb = min(cb, bb[k]);
  for (int off = width >> 1; off > 0; off >>= 1)
    cb = min(cb, __shfl_xor_sync(FULL, cb, off, width));
  score = best;
  iend = best > 0 ? ci : -1;
  bend = best > 0 ? cb : -1;
}
