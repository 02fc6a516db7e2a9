// Stage R1: refine — the banded DP that records a move byte per cell, then
// the traceback walk, for the ranked hits of a batch, in one launch.
//
// Replaces the XLA stage ghostm_tpu/engine.py::_refine_device (no Pallas
// kernel there: sw_xla.banded_scores, the span mask, sw_xla.sw_banded_moves
// and sw_xla.traceback_stats_device inside the step's one device program).
// N = R * K hits (81,920 at 8192 reads and K 10); each gives the (9, N)
// int32 rows qstart, qend, sstart, send, length, matches, mismatch,
// gapopen, score — equal to kernels/refine.py::refine_stats_plain.
//
// Bound on the H100: instruction issue in the DP (two passes a row and the
// move byte: more instructions a cell than B3), which takes most of the
// time at every shape; the moves plane crosses device memory twice
// (written by the DP, read back by the walk), and the walk is a chain of
// dependent loads, ~Lq of them a hit, which shows at long frames.
// Design (simple first):
//  - The DP is sw_common.cuh's layout: one thread an alignment at B <= 32,
//    G = 2 or 4 lanes of 32 diagonals for wider bands, H and F of the
//    lane's diagonals in registers, F from the register of diagonal b + 1
//    (the next lane's first by a shuffle), E carried along the row and
//    across lanes by a max-plus scan. Unlike sw_row it holds the TRUE H, E
//    and F of the plain version (NEG fills, no "+ go1"), because the move
//    bits compare them: hc needs H + s and E as they are, and the edge bits
//    (f_open at b = B - 1, e_open at b = 0) come out of NEG arithmetic.
//    Diagonals past the band are not held at a sentinel: the diagonal
//    b = B - 1 reads NEG from above, as the plain version's shift fills it,
//    and nothing of a diagonal >= B reaches one < B (E flows to larger b).
//  - Scores from a (32, 33) int32 table in shared memory (the matrix as it
//    is, LOW entries included; column 32 is the cell outside the subject
//    span); window codes arrive a byte each, 4 to a register, shifted one
//    byte a row, with in_span's int32 test folded into the code.
//  - The move bytes of a row go to a global scratch plane of 32-bit words
//    at ((i * WPR + b / 4) * N + n): a warp's stores for one row coalesce.
//  - Then lane 0 of the group walks the plane back (sw_xla's state
//    machine, its bound 2 (Lq + B) + 4), reading the match bit from the
//    codes, and writes the 9 output rows.
#include "sw_common.cuh"

#define RTHREADS 128              // at most, a block
#define TAB_INTS (32 * TCOLS)

// Window code at window position p: MASK_CODE past the window or where
// g0 + p lies outside [lo, hi) (the int32 sum wraps as torch's does).
__device__ __forceinline__ unsigned rcode(const int8_t* __restrict__ wn,
                                          int p, int Wl, int g0, int lo,
                                          int hi) {
  const int j = (int)((unsigned)g0 + (unsigned)p);
  return p < Wl && j >= lo && j < hi ? (unsigned)(__ldg(wn + p) & 31)
                                     : MASK_CODE;
}

template <int G, bool PART>
__global__ void __launch_bounds__(RTHREADS)
    refine_kernel(const int8_t* __restrict__ q3,
                  const int32_t* __restrict__ packed,
                  const int8_t* __restrict__ w,
                  const int32_t* __restrict__ lo_,
                  const int32_t* __restrict__ hi_,
                  const int32_t* __restrict__ table, int N, int K, int Lq,
                  int Wl, int B, int gap_open, int gap_extend,
                  unsigned* plane, int walk, int32_t* __restrict__ out) {
  __shared__ int tab[TAB_INTS];
  for (int e = threadIdx.x; e < TAB_INTS; e += blockDim.x)
    tab[e] = __ldg(table + e);
  __syncthreads();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if ((tid & ~31) / G >= N) return;  // whole warps; no barrier follows
  const int g = G > 1 ? (int)(threadIdx.x & (G - 1)) : 0;
  const int n0 = tid / G;
  const bool active = n0 < N;
  const int n = active ? n0 : N - 1;  // a warp's spare lanes redo the last
  const int go1 = gap_open + gap_extend, ge = gap_extend;
  const int WPR = (B + 3) >> 2;       // plane words a row
  const int rem = B - 32 * g;         // this lane's diagonals in the band
  const int p0 = 32 * g;
  const int frame = min(max(packed[2 * N + n], 0), 5);
  const int8_t* qn = q3 + ((size_t)(n / K) * 6 + frame) * Lq;
  const int8_t* wn = w + (size_t)n * Wl;
  const int g0 = packed[6 * N + n], lo = lo_[n], hi = hi_[n];

  int H[32], F[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    H[k] = 0;
    F[k] = NEG;
  }
  unsigned W[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    unsigned word = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      word |= rcode(wn, p0 + 4 * m + u, Wl, g0, lo, hi) << (8 * u);
    W[m] = word;
  }
  int best = 0, bi = 0;
  for (int i = 0; i < Lq; ++i) {
    const unsigned nc = rcode(wn, i + p0 + 32, Wl, g0, lo, hi);
    const int* trow = tab + (__ldg(qn + i) & 31) * TCOLS;
    // H and F of diagonal b + 1 for the lane's last diagonal
    int hup = NEG, fup = NEG;
    if (G > 1) {
      hup = __shfl_down_sync(FULL, H[0], 1, G);
      fup = __shfl_down_sync(FULL, F[0], 1, G);
      if (g == G - 1) {
        hup = NEG;
        fup = NEG;
      }
    }
    // pass 1: F, Ht = max(H + s, F, 0); bit 3 f_open, bit 0 (H + s == Ht)
    unsigned M[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) M[m] = 0;
    int acc = NEG;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      int hu = k < 31 ? H[k + 1] : hup;
      int fu = k < 31 ? F[k + 1] : fup;
      if (PART && k + 1 >= rem) {  // diagonal b + 1 lies past the band
        hu = NEG;
        fu = NEG;
      }
      const int fo = hu - go1, fe = fu - ge;
      const int fn = max(fo, fe);
      const int c = (W[k >> 2] >> (8 * (k & 3))) & 0xff;
      const int hs = H[k] + trow[c];
      const int ht = max(max(hs, fn), 0);
      M[k >> 2] |= ((unsigned)(fo >= fe) << 3 | (unsigned)(hs == ht))
                   << (8 * (k & 3));
      F[k] = fn;
      H[k] = ht;
      if (G > 1) acc = max(acc - ge, ht);
    }
    // E entering the lane: NEG - gap_open at b = 0 (the plain version's
    // P - cvec there), else a max-plus scan over the lanes before it
    int E = NEG - gap_open;
    if (G > 1) {
      int x = acc;   // E + go1 leaving this lane
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const int y = __shfl_up_sync(FULL, x, d, G);
        if (g >= d) x = max(x, y - d * 32 * ge);
      }
      x = __shfl_up_sync(FULL, x, 1, G);
      if (g > 0) E = x - go1;
    }
    // pass 2: Hn = max(Ht, E); hc; bit 2 e_open from the final H to the
    // left (the lane's first diagonal after the shuffle below)
    const int e0 = E;
    int hl = NEG, rk = INT_MIN;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int ht = H[k];
      const int hn = max(ht, E);
      const int sh = 8 * (k & 3);
      const unsigned diag = (M[k >> 2] >> sh) & 1u;
      const unsigned hc = hn == 0                 ? 0u
                          : (diag && ht >= E)     ? 1u
                          : E == hn               ? 2u
                                                  : 3u;
      const unsigned eo = k > 0 && hl - go1 >= E;
      M[k >> 2] = (M[k >> 2] & ~(7u << sh)) | ((hc | eo << 2) << sh);
      E = max(E - ge, ht - go1);
      H[k] = hn;
      hl = hn;
      if (!(PART && k >= rem)) rk = max(rk, hn * 32 + (31 - k));
    }
    int hleft = NEG;
    if (G > 1) {
      hleft = __shfl_up_sync(FULL, H[31], 1, G);
      if (g == 0) hleft = NEG;
    }
    M[0] |= (unsigned)(hleft - go1 >= e0) << 2;
    if ((rk >> 5) > (best >> 5)) {  // a later row wins on H alone
      best = rk;
      bi = i;
    }
    if (active) {
      unsigned* row = plane + (size_t)i * WPR * N + n;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (8 * g + m < WPR) row[(size_t)(8 * g + m) * N] = M[m];
    }
#pragma unroll
    for (int m = 0; m < 7; ++m) W[m] = __funnelshift_r(W[m], W[m + 1], 8);
    W[7] = __funnelshift_r(W[7], nc, 8);
  }
  int sc, ie, be;
  if (G == 1) {
    sc = best >> 5;
    ie = sc > 0 ? bi : -1;
    be = sc > 0 ? 31 - (best & 31) : -1;
  } else {
    int bH[1] = {best >> 5}, bI[1] = {bi}, bb[1] = {p0 + 31 - (best & 31)};
    sw_finalize<1>(bH, bI, bb, B, G, sc, ie, be);
  }
  __syncwarp();  // the group's plane stores, visible to its lane 0
  if (!active || g != 0) return;
  if (!walk) {
    out[n] = sc;
    out[N + n] = ie;
    out[2 * N + n] = be;
    return;
  }
  // the walk: st 0 in H, 1 in E, 2 in F, 3 done
  int i = ie, b = be;
  int st = i >= 0 ? 0 : 3;
  int qstart = i >= 0 ? i : -1, sstart = i >= 0 ? i + b : -1;
  int length = 0, matches = 0, mismatch = 0, gapopen = 0;
  const int bound = 2 * (Lq + B) + 4;
  for (int t = 0; t < bound && st != 3; ++t) {
    const int ii = min(max(i, 0), Lq - 1), bb = min(max(b, 0), B - 1);
    const unsigned mv =
        plane[(size_t)(ii * WPR + (bb >> 2)) * N + n] >> (8 * (bb & 3));
    if (st == 0) {
      const unsigned c = mv & 3;
      if (c == 0 || i < 0 || b < 0 || b >= B) {
        st = 3;
      } else if (c == 1) {
        const int eq = __ldg(qn + ii) == __ldg(wn + ii + bb);
        matches += eq;
        mismatch += 1 - eq;
        length += 1;
        qstart = i;
        sstart = i + b;
        i -= 1;
      } else {
        st = c == 2 ? 1 : 2;
      }
    }
    if (st == 1) {
      length += 1;
      sstart = i + b - 1;
      b -= 1;
      if ((mv >> 2) & 1) {
        gapopen += 1;
        st = 0;
      }
    } else if (st == 2) {
      length += 1;
      qstart = i;
      i -= 1;
      b += 1;
      if ((mv >> 3) & 1) {
        gapopen += 1;
        st = 0;
      }
    }
    if (st == 0 && i < 0) st = 3;
  }
  const bool empty = ie < 0;
  out[n] = empty ? -1 : qstart;
  out[N + n] = ie;
  out[2 * N + n] = empty ? -1 : sstart;
  out[3 * N + n] = empty ? -1 : ie + be;
  out[4 * N + n] = length;
  out[5 * N + n] = matches;
  out[6 * N + n] = mismatch;
  out[7 * N + n] = gapopen;
  out[8 * N + n] = sc;
}

template <int G, bool PART>
static int refine_instance(int blocks, int threads, const int8_t* q3,
                           const int32_t* packed, const int8_t* w,
                           const int32_t* lo, const int32_t* hi,
                           const int32_t* table, int N, int K, int Lq, int Wl,
                           int B, int gap_open, int gap_extend,
                           unsigned* plane, int walk, int32_t* out,
                           cudaStream_t stream) {
  refine_kernel<G, PART><<<blocks, threads, 0, stream>>>(
      q3, packed, w, lo, hi, table, N, K, Lq, Wl, B, gap_open, gap_extend,
      plane, walk, out);
  return (int)cudaGetLastError();
}

// q3: (R, 6, Lq) int8 frames; packed: (9, R, K) int32 ranked hits (row 2
// the frame, row 6 g0); w: (N, Wl) int8 windows, Wl >= Lq + B; lo, hi:
// (N,) int32 subject span; table: (32, 33) int32 (column 32 outside the
// span); N = R * K; 1 <= B <= 128; gap costs >= 0; H < 2^26 (the best
// cell's key). plane: Lq * ceil(B / 4) * N words of scratch. walk != 0:
// out is (9, N) int32, the stat rows then the score; walk == 0 (the
// debug entry): out is (3, N), (score, i_end, b_end), and the plane holds
// the moves.
extern "C" int ghostm_refine(const int8_t* q3, const int32_t* packed,
                             const int8_t* w, const int32_t* lo,
                             const int32_t* hi, const int32_t* table, int N,
                             int K, int Lq, int Wl, int B, int gap_open,
                             int gap_extend, unsigned* plane, int walk,
                             int32_t* out, cudaStream_t stream) {
  const int D = (B + 31) / 32;
  if (D < 1 || D > 4 || K < 1) return (int)cudaErrorInvalidValue;
  const int G = D == 1 ? 1 : D == 2 ? 2 : 4;
  const bool part = B != 32 * G;
  // spread a small N over every SM: blocks of at least one warp
  static int sm_count[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sm_count[dev]) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sm_count[dev] = sms;
  }
  const long long lanes = (long long)N * G;
  const long long per_sm = (lanes / sm_count[dev] + 31) / 32;
  const int threads = per_sm >= RTHREADS / 32 ? RTHREADS
                      : per_sm < 1             ? 32
                                               : (int)per_sm * 32;
  const int blocks = (int)((lanes + threads - 1) / threads);
#define LAUNCH(GG, PP)                                                       \
  return refine_instance<GG, PP>(blocks, threads, q3, packed, w, lo, hi,     \
                                 table, N, K, Lq, Wl, B, gap_open,           \
                                 gap_extend, plane, walk, out, stream);
  if (G == 1) {
    if (part) LAUNCH(1, true) else LAUNCH(1, false)
  } else if (G == 2) {
    if (part) LAUNCH(2, true) else LAUNCH(2, false)
  }
  if (part) LAUNCH(4, true) else LAUNCH(4, false)
#undef LAUNCH
}
