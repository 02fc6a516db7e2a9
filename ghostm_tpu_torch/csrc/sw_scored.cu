// Kernels B5 and B6: banded Smith-Waterman (Gotoh, affine gaps) for the
// score-fed route, from the codes and an int32 score table.
//
// Replace ghostm_tpu/kernels/sw_pallas.py::_sw_kernel (entry
// sw_banded_pallas, B5: by rows) and ghostm_tpu/kernels/sw_wave.py::
// _wave_kernel (entry sw_banded_wave, B6: an anti-diagonal wavefront), the
// engine's align path for matrices outside the fused kernel's nibble range
// (BLOSUM50, PAM) or bands the fused kernel does not take. On the TPU both
// read an (N, Lq, B) score tile built beforehand; here the tile is never
// built: the DP is sw_common.cuh's sw_rows (one thread per alignment, DPX
// recurrences, a lane-private shared-memory table), on a (32, 33) int32
// table whose entry (q, w) is the tile's cell for query code q and window
// code w, column 32 the cell outside the subject span (kernels/
// sw_scored.py::code_table). A row needs no prefix scan on one thread, so
// the wavefront has no reason to exist on the card: B6's route runs the
// same DP through its own entry. Per alignment (score, i_end, b_end): max
// score, then min i, then min b; (-1, -1) when the score is <= 0 — equal
// to sw_xla.sw_banded on the tile.
#include "sw_common.cuh"

// q: (N, Lq) int8; w: (N, Wl) int8 with Wl >= Lq + B; rel_lo, rel_hi: (N,)
// int32 window-local subject span; table: (32, 33) int32, 16-byte aligned;
// go1 = gap_open + gap_extend, ge = gap_extend, both >= 0; outputs (N,)
// int32. 1 <= B <= 128; Lq times the table's largest value < 2^26.
extern "C" int ghostm_sw_scored(const int8_t* q, const int8_t* w,
                                const int32_t* rel_lo, const int32_t* rel_hi,
                                const int32_t* table, int N, int Lq, int Wl,
                                int B, int go1, int ge, int32_t* score,
                                int32_t* iend, int32_t* bend,
                                cudaStream_t stream) {
  return sw_rows<int32_t>(q, w, rel_lo, rel_hi, table, N, Lq, Wl, B, go1, ge,
                          score, iend, bend, stream);
}

// B6's entry: the same function and arguments.
extern "C" int ghostm_sw_wave(const int8_t* q, const int8_t* w,
                              const int32_t* rel_lo, const int32_t* rel_hi,
                              const int32_t* table, int N, int Lq, int Wl,
                              int B, int go1, int ge, int32_t* score,
                              int32_t* iend, int32_t* bend,
                              cudaStream_t stream) {
  return sw_rows<int32_t>(q, w, rel_lo, rel_hi, table, N, Lq, Wl, B, go1, ge,
                          score, iend, bend, stream);
}
