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
// The DP is sw_common.cuh's sw_rows (one thread per alignment, DPX
// recurrences, a lane-private shared-memory table), on the int8 (32, 32)
// matrix table: MASKED_I8 entries and the span column are NEG.
#include "sw_common.cuh"

// q: (N, Lq) int8; w: (N, Wl) int8 with Wl >= Lq + B; rel_lo, rel_hi: (N,)
// int32 window-local subject span; table: (32, 32) int8, -128 = masked,
// 16-byte aligned (a tensor from score_table);
// go1 = gap_open + gap_extend, ge = gap_extend, both >= 0; outputs (N,)
// int32. B even, 16 <= B <= 128; 127 * Lq < 2^26 (the key's range).
extern "C" int ghostm_sw_fused(const int8_t* q, const int8_t* w,
                               const int32_t* rel_lo, const int32_t* rel_hi,
                               const int8_t* table, int N, int Lq, int Wl,
                               int B, int go1, int ge, int32_t* score,
                               int32_t* iend, int32_t* bend,
                               cudaStream_t stream) {
  return sw_rows<int8_t>(q, w, rel_lo, rel_hi, table, N, Lq, Wl, B, go1, ge,
                         score, iend, bend, stream);
}
