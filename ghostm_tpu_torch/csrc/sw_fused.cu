// Kernel B3: banded Smith-Waterman (Gotoh, affine gaps) with the
// substitution scores looked up in-kernel.
//
// Replaces ghostm_tpu/kernels/sw_fused.py::_fused_kernel (entry
// sw_fused_wave), the align phase: N query frames of Lq codes against N
// windows of >= Lq + B subject codes, over B diagonals (393,216 alignments
// of 40 x 32 cells per config-2 batch). Per alignment it returns
// (score, i_end, b_end): max score, then min i, then min b; (-1, -1) when
// the score is <= 0 — equal to sw_xla.sw_banded(banded_scores_i8(...)).
//
// Bound on the H100: integer operations (~12 per cell: the H, E, F
// recurrences and the best-cell update), not bytes (112 code bytes per
// 1280-cell alignment). Design: one warp per alignment, lane l owning the
// D = ceil(B / 32) diagonals b = l * D + d (B = 32: one diagonal a lane).
// Rows advance in order, as sw_xla._row_step:
//   F from diagonal b + 1 of the previous row (__shfl_down_sync),
//   E by an exact prefix max over Ht[b'] + b' * ge (__shfl_up_sync scan),
//   the per-diagonal best with the first row on a strict '>'.
// The 32 x 32 score table sits in shared memory as int8 with -128 for a
// masked entry (a LOW matrix entry, or a window code >= code_limit); the
// subject-span mask [rel_lo, rel_hi) is tested per cell. The TPU kernel's
// nibble-packed profile words existed only because the TPU has no gather.
// Hopper's DPX instructions (__viaddmax_s32 ...) fit this recurrence: later.
#include <cstdint>
#include <cuda_runtime.h>

#define NEG (-(1 << 30))
#define MASKED_I8 (-128)
#define FULL 0xffffffffu
#define WARPS 4

template <int D>
__global__ void sw_fused_kernel(const int8_t* __restrict__ q,
                                const int8_t* __restrict__ w,
                                const int32_t* __restrict__ rel_lo,
                                const int32_t* __restrict__ rel_hi,
                                const int8_t* __restrict__ table, int N, int Lq,
                                int Wl, int B, int go1, int ge,
                                int32_t* __restrict__ score,
                                int32_t* __restrict__ iend,
                                int32_t* __restrict__ bend) {
  __shared__ int8_t tab[32 * 32];
  for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warps exit; no block barrier follows
  const int8_t* qn = q + (size_t)n * Lq;
  const int8_t* wn = w + (size_t)n * Wl;
  const int lo = rel_lo[n], hi = rel_hi[n];

  int H[D], F[D], bH[D], bI[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    H[d] = 0;
    F[d] = NEG;
    bH[d] = 0;
    bI[d] = 0;
  }
  for (int i = 0; i < Lq; ++i) {
    // codes are < 32 by construction; & 31 keeps a bad code in the table
    const int8_t* trow = tab + ((qn[i] & 31) << 5);
    int s[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int b = lane * D + d;
      s[d] = NEG;
      if (b < B) {
        const int j = i + b;
        const int t = trow[wn[j] & 31];
        if (t != MASKED_I8 && j >= lo && j < hi) s[d] = t;
      }
    }
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
  // _finalize: max score, then min i, then min b
  int best = 0;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (lane * D + d < B) best = max(best, bH[d]);
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(FULL, best, off));
  int ci = 1 << 30;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (lane * D + d < B && bH[d] == best) ci = min(ci, bI[d]);
  for (int off = 16; off > 0; off >>= 1)
    ci = min(ci, __shfl_xor_sync(FULL, ci, off));
  int cb = 1 << 30;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (lane * D + d < B && bH[d] == best && bI[d] == ci)
      cb = min(cb, lane * D + d);
  for (int off = 16; off > 0; off >>= 1)
    cb = min(cb, __shfl_xor_sync(FULL, cb, off));
  if (lane == 0) {
    score[n] = best;
    iend[n] = best > 0 ? ci : -1;
    bend[n] = best > 0 ? cb : -1;
  }
}

// q: (N, Lq) int8; w: (N, Wl) int8 with Wl >= Lq + B; rel_lo, rel_hi: (N,)
// int32 window-local subject span; table: (32, 32) int8, -128 = masked;
// go1 = gap_open + gap_extend, ge = gap_extend; outputs (N,) int32.
// B even, 16 <= B <= 128.
extern "C" int ghostm_sw_fused(const int8_t* q, const int8_t* w,
                               const int32_t* rel_lo, const int32_t* rel_hi,
                               const int8_t* table, int N, int Lq, int Wl,
                               int B, int go1, int ge, int32_t* score,
                               int32_t* iend, int32_t* bend,
                               cudaStream_t stream) {
  const int blocks = (N + WARPS - 1) / WARPS;
  const int D = (B + 31) / 32;
#define LAUNCH(DD)                                                        \
  sw_fused_kernel<DD><<<blocks, 32 * WARPS, 0, stream>>>(                 \
      q, w, rel_lo, rel_hi, table, N, Lq, Wl, B, go1, ge, score, iend, bend)
  switch (D) {
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 3: LAUNCH(3); break;
    case 4: LAUNCH(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
