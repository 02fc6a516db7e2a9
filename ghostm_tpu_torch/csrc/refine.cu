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
// Bound on the H100: instruction issue in the DP. The inputs and the 9 rows
// are a few MB; the DP needs ~12 int32 operations a cell for H, E, F and
// the best cell, over 67 T/s (chip_smoke.py's bound), and the move byte
// takes as many again. The move plane crosses device memory twice
// (written by the DP, read back by the walk), 105 MB at the main path's
// shape, and the walk is a chain of dependent steps, up to 2 (Lq + B) + 4
// a hit. Which of these holds a launch back depends on N and Lq, so there
// are two layouts, and kernels/refine.py::layout picks one from the hits
// an SM and Lq and passes its lanes an alignment:
//  - The thread layout (G = ceil(B / 32) rounded to 1, 2 or 4 lanes of 32
//    diagonals an alignment), for N that fills the card (the main path's
//    short frames: 2,560 warps). H and F1 of the lane's diagonals in
//    registers, window codes 4 to a register, shifted a byte a row (each
//    code loaded once, the next row's during this one), DPX for the
//    recurrences (__viaddmax_s32[_relu]). At G = 1 one pass a row: E
//    enters at b = 0 and is carried along the row with the move bits;
//    wider bands take F across the lane edge by a shuffle, E by a max-plus
//    scan, and a second pass. One score table in shared memory, blocks of
//    128 threads. Measured slower on an H100 and not kept (PERF.md section
//    6): a table copy a lane (B3's conflict-free layout, which holds a
//    block to one an SM), B3's 4-row groups, __vibmax_s32 for the f_open
//    and Ht >= E bits. The plane is 32-bit words at ((i * ceil(B/4) + b/4)
//    * N + n): a warp's stores of a row coalesce across its alignments;
//    the group's lane 0 walks it back.
//  - The warp layout (32 lanes of G diagonals an alignment), for few hits
//    or long frames (1,280 hits at 5 kbp: 1,280 warps where the thread
//    layout made 80). The warp first copies its hit's query codes, window
//    codes with the span folded in and raw window bytes to shared memory,
//    so a row reads no device memory and the next row's scores load during
//    this one; one table copy serves the warp's lookups of one query row.
//    E enters each lane by a max-plus scan over the warp (5 shuffle steps
//    a row, as a plain prefix max of E1 leaving a lane plus a
//    position term); F1 and H of diagonal b + 1 come from the next lane,
//    H from its Ht and this lane's scan value, so only the scan's
//    shuffles lie on the row's chain. The plane is alignment-major bytes,
//    hit n's rows at n * S (S = Lq * round_up(B, 4) rounded to 16), so the
//    walk stages it: the warp copies a block of rows (up to 4 KB) into
//    shared memory with independent 16-byte loads, its lane 0 runs
//    the state machine there (runs of diagonal moves in a tight loop), and
//    the block below loads into registers meanwhile (the walk only moves
//    to lower rows). Queries up to WARP_MAX_LQ codes, whose shared memory
//    fits a block at every band (a static_assert below).
// Both hold the plain version's H, and its F and E plus go1 (F1, E1), so
// that every move bit is a compare of exact values: hc needs H + s and E,
// and the edge bits (f_open at b = B - 1, e_open at b = 0) come out of
// NEG arithmetic. Diagonals past the band are not held at a sentinel: the
// diagonal b = B - 1 reads NEG from above, as the plain version's shift
// fills it, and nothing of a diagonal >= B reaches one < B (E flows to
// larger b only).
#include "sw_common.cuh"

#define TAB_INTS (32 * TCOLS)
#define RW_WARPS 4                // warp layout: at most, warps a block
#define WALK_BYTES 4096           // warp layout: a staged walk block
#define RSMEM_MAX 232448          // shared memory a block may opt in to
#define WARP_MAX_LQ 65536         // warp layout: the longest query it takes

// Window code at window position p: MASK_CODE past the window or where
// g0 + p lies outside [lo, hi) (the int32 sum wraps as torch's does).
__device__ __forceinline__ unsigned rcode(const int8_t* __restrict__ wn,
                                          int p, int Wl, int g0, int lo,
                                          int hi) {
  const int j = (int)((unsigned)g0 + (unsigned)p);
  return p < Wl && j >= lo && j < hi ? (unsigned)(__ldg(wn + p) & 31)
                                     : MASK_CODE;
}

// Window codes at positions p .. p + 3, a byte each.
__device__ __forceinline__ unsigned rcode4(const int8_t* __restrict__ wn,
                                           int p, int Wl, int g0, int lo,
                                           int hi) {
  unsigned word = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    word |= rcode(wn, p + u, Wl, g0, lo, hi) << (8 * u);
  return word;
}

// The plain version's row for one cell, pass 1, on F1 = F + go1: F of the
// cell from H and F1 of diagonal b + 1 above (hu, fu1), then Ht = max(H +
// s, F, 0). Sets f_open (F opened from H) and diag (H + s == Ht).
__device__ __forceinline__ int cell1(int& h, int& f1, int hu, int fu1,
                                     int s, int go1, int ge, bool& fo,
                                     bool& diag) {
  const int fe1 = fu1 - ge;
  fo = hu >= fe1;
  f1 = max(hu, fe1);
  const int hs = h + s;
  h = __viaddmax_s32_relu(f1, -go1, hs);
  diag = hs == h;
  return h;
}

// Pass 2, on E1 = E + go1: Hn = max(Ht, E) and the cell's move byte; hl:
// the final H of diagonal b - 1 (e_open is hl - go1 >= E). E1 steps on to
// diagonal b + 1.
__device__ __forceinline__ unsigned cell2(int& h, int& e1, int hl, bool fo,
                                          bool diag, int go1, int ge) {
  const int ht = h, e = e1 - go1;
  h = max(ht, e);
  unsigned c = e == ht ? 2u : 3u;
  c = diag ? 1u : c;
  c = ht >= e ? c : 2u;
  c = h == 0 ? 0u : c;
  const unsigned byte = c | (hl >= e1 ? 4u : 0u) | (fo ? 8u : 0u);
  e1 = __viaddmax_s32(e1, -ge, ht);
  return byte;
}

// The traceback walk's state (sw_xla's state machine: st 0 in H, 1 in E,
// 2 in F, 3 done) from the best cell (ie, be), and its 9 output rows.
struct Walk {
  int i, b, st, qstart, sstart, length, matches, mismatch, gapopen;
  __device__ Walk(int ie, int be)
      : i(ie), b(be), st(ie >= 0 ? 0 : 3), qstart(ie >= 0 ? ie : -1),
        sstart(ie >= 0 ? ie + be : -1), length(0), matches(0), mismatch(0),
        gapopen(0) {}
  // One step at the current cell, its move byte mv and its match bit eq
  // (the query code equal to the window byte), both read at the cell
  // clamped into the band before the step.
  __device__ __forceinline__ void step(unsigned mv, bool eq, int B) {
    if (st == 0) {
      const unsigned c = mv & 3;
      if (c == 0 || i < 0 || b < 0 || b >= B) {
        st = 3;
      } else if (c == 1) {
        matches += eq;
        mismatch += !eq;
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
  __device__ void write(int32_t* __restrict__ out, int N, int n, int ie,
                        int be, int sc) const {
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
};

// ---------------------------------------------------------------- thread

// The thread layout's diagonals a lane.
constexpr int TD = 32;

// A row over one lane's TD = 32 diagonals (the thread layout). W[m]: codes
// of window positions 4m .. 4m + 3 past the row and the lane's first
// diagonal; trow: this row's row of the score table; prow: the lane's
// first plane word of this row (word m at prow[m * N]), nw of them in the
// band. Returns the row's best key H * 32 + (31 - k).
template <int G, bool PART>
__device__ __forceinline__ int thread_row(int (&H)[TD], int (&F)[TD],
                                          const unsigned (&W)[TD / 4 + 1],
                                          const int* __restrict__ trow,
                                          int g, int rem, int go1, int ge,
                                          unsigned* prow, int N, int nw) {
  if (G == 1) {   // E enters at b = 0: one pass, E carried along the row
    int e1 = NEG + ge, hl = NEG, rk = INT_MIN, prev = INT_MIN;
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < TD; ++k) {
      int hu = k < TD - 1 ? H[k + 1] : NEG;
      int fu = k < TD - 1 ? F[k + 1] : NEG + go1;
      if (PART && k + 1 >= rem) {
        hu = NEG;
        fu = NEG + go1;
      }
      const unsigned c = (W[k >> 2] >> (8 * (k & 3))) & 0xff;
      const int s = trow[c];
      bool fo, dg;
      cell1(H[k], F[k], hu, fu, s, go1, ge, fo, dg);
      word |= cell2(H[k], e1, hl, fo, dg, go1, ge) << (8 * (k & 3));
      hl = H[k];
      if ((k & 3) == 3) {
        if (k / 4 < nw) prow[(k / 4) * N] = word;
        word = 0;
      }
      int key = H[k] * 32 + (31 - k);
      if (PART && k >= rem) key = INT_MIN;
      if (k & 1)
        rk = __vimax3_s32(rk, prev, key);
      else
        prev = key;
    }
    return rk;
  }
  // H and F1 of diagonal b + 1 for the lane's last diagonal
  int hup = __shfl_down_sync(FULL, H[0], 1, G);
  int fup = __shfl_down_sync(FULL, F[0], 1, G);
  if (g == G - 1) {
    hup = NEG;
    fup = NEG + go1;
  }
  unsigned fob = 0, dgb = 0;  // f_open and diag, a bit a diagonal
  int acc = NEG;
#pragma unroll
  for (int k = 0; k < TD; ++k) {
    int hu = k < TD - 1 ? H[k + 1] : hup;
    int fu = k < TD - 1 ? F[k + 1] : fup;
    if (PART && k + 1 >= rem) {  // diagonal b + 1 lies past the band
      hu = NEG;
      fu = NEG + go1;
    }
    const unsigned c = (W[k >> 2] >> (8 * (k & 3))) & 0xff;
    const int s = trow[c];
    bool fo, dg;
    const int ht = cell1(H[k], F[k], hu, fu, s, go1, ge, fo, dg);
    fob |= (unsigned)fo << k;
    dgb |= (unsigned)dg << k;
    acc = __viaddmax_s32(acc, -ge, ht);
  }
  // E1 entering the lane: NEG - gap_open + go1 at b = 0 (the plain
  // version's P - cvec there), else a max-plus scan over the lanes before
  int e1 = NEG + ge;
  {
    int x = acc;   // E1 leaving this lane
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const int y = __shfl_up_sync(FULL, x, d, G);
      if (g >= d) x = max(x, y - d * TD * ge);
    }
    x = __shfl_up_sync(FULL, x, 1, G);
    if (g > 0) e1 = x;
  }
  const int e10 = e1;
  int hl = NEG, rk = INT_MIN, prev = INT_MIN;
  unsigned word = 0, word0 = 0;
#pragma unroll
  for (int k = 0; k < TD; ++k) {
    const unsigned byte = cell2(H[k], e1, hl, (fob >> k) & 1,
                                (dgb >> k) & 1, go1, ge);
    hl = H[k];
    word |= byte << (8 * (k & 3));
    if ((k & 3) == 3) {
      if (k == 3)
        word0 = word;   // its e_open bit at k = 0 comes after the shuffle
      else if (k / 4 < nw)
        prow[(k / 4) * N] = word;
      word = 0;
    }
    int key = H[k] * 32 + (31 - k);
    if (PART && k >= rem) key = INT_MIN;
    if (k & 1)
      rk = __vimax3_s32(rk, prev, key);
    else
      prev = key;
  }
  // e_open at the lane's first diagonal: the final H to its left
  int hleft = __shfl_up_sync(FULL, H[TD - 1], 1, G);
  if (g == 0) hleft = NEG;
  word0 = (word0 & ~4u) | (hleft >= e10 ? 4u : 0u);
  if (nw > 0) prow[0] = word0;
  return rk;
}

template <int G, bool PART>
__global__ void __launch_bounds__(128, 1)
    refine_thread(const int8_t* __restrict__ q3,
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
  constexpr int NW = TD / 4;          // plane words a lane a row
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if ((tid & ~31) / G >= N) return;  // whole warps; no barrier follows
  const int g = G > 1 ? (int)(threadIdx.x & (G - 1)) : 0;
  const int n0 = tid / G;
  const bool active = n0 < N;
  const int n = active ? n0 : N - 1;  // a warp's spare lanes redo the last
  const int go1 = gap_open + gap_extend, ge = gap_extend;
  const int WPR = (B + 3) >> 2;       // plane words a row
  const int rem = B - TD * g;         // this lane's diagonals in the band
  const int nw = active ? min(max(WPR - NW * g, 0), NW) : 0;
  const int p0 = TD * g;
  const int frame = min(max(packed[2 * N + n], 0), 5);
  const int8_t* qn = q3 + ((size_t)(n / K) * 6 + frame) * Lq;
  const int8_t* wn = w + (size_t)n * Wl;
  const int g0 = packed[6 * N + n], lo = lo_[n], hi = hi_[n];

  int H[TD], F[TD];   // H and F1 = F + go1 of the lane's diagonals
#pragma unroll
  for (int k = 0; k < TD; ++k) {
    H[k] = 0;
    F[k] = NEG + go1;
  }
  unsigned W[NW + 1];
#pragma unroll
  for (int m = 0; m <= NW; ++m)
    W[m] = rcode4(wn, p0 + 4 * m, Wl, g0, lo, hi);
  unsigned qw = query4(qn, 0, Lq);
  // the code entering W's last byte at the next row
  unsigned nc = rcode(wn, p0 + 4 * NW + 4, Wl, g0, lo, hi);
  unsigned* pl = plane + (size_t)(NW * g) * N + n;
  const size_t row_words = (size_t)WPR * N;
  int best = 0, bi = 0;
  for (int i = 0; i < Lq; ++i) {
    // the next row's codes, loaded while this row computes
    const unsigned nc2 = rcode(wn, i + p0 + 4 * NW + 5, Wl, g0, lo, hi);
    const unsigned qw2 = (i & 3) == 3 ? query4(qn, i + 1, Lq) : qw >> 8;
    const int qc = qw & 0xff;
    const int rk = thread_row<G, PART>(H, F, W, tab + qc * TCOLS, g, rem,
                                       go1, ge, pl + i * row_words, N, nw);
    if ((rk >> 5) > (best >> 5)) {  // a later row wins on H alone
      best = rk;
      bi = i;
    }
#pragma unroll
    for (int m = 0; m < NW; ++m) W[m] = __funnelshift_r(W[m], W[m + 1], 8);
    W[NW] = __funnelshift_r(W[NW], nc, 8);
    nc = nc2;
    qw = qw2;
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
  // the walk, on the plane in device memory: the move word and the two
  // codes of a step are independent loads
  Walk wk(ie, be);
  const int bound = 2 * (Lq + B) + 4;
  for (int t = 0; t < bound && wk.st != 3; ++t) {
    const int ii = min(max(wk.i, 0), Lq - 1), bb = min(max(wk.b, 0), B - 1);
    const unsigned mv =
        plane[(size_t)(ii * WPR + (bb >> 2)) * N + n] >> (8 * (bb & 3));
    wk.step(mv, __ldg(qn + ii) == __ldg(wn + ii + bb), B);
  }
  wk.write(out, N, n, ie, be, sc);
}

// ------------------------------------------------------------------ warp

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Shared memory of one warp in the warp layout: the query codes (raw), the
// window codes with the span folded (Lq + 32 D of them: the last lane
// reads up to there), the raw window bytes (Lq + B), the walk's block.
__host__ __device__ constexpr int warp_bytes(int Lq, int B, int D) {
  return align16(Lq) + align16(Lq + 32 * D) + align16(Lq + B) + WALK_BYTES;
}
// a warp fits a block at every query the layout takes
static_assert(align16(TAB_INTS * 4) + warp_bytes(WARP_MAX_LQ, 128, 4) <=
                  RSMEM_MAX,
              "the warp layout's shared memory at WARP_MAX_LQ");

template <int D>
__global__ void __launch_bounds__(32 * RW_WARPS)
    refine_warp(const int8_t* __restrict__ q3,
                const int32_t* __restrict__ packed,
                const int8_t* __restrict__ w,
                const int32_t* __restrict__ lo_,
                const int32_t* __restrict__ hi_,
                const int32_t* __restrict__ table, int N, int K, int Lq,
                int Wl, int B, int gap_open, int gap_extend,
                uint8_t* plane, int walk, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* tab = reinterpret_cast<int*>(smem);
  for (int e = threadIdx.x; e < TAB_INTS; e += blockDim.x)
    tab[e] = __ldg(table + e);
  __syncthreads();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n = blockIdx.x * (blockDim.x >> 5) + wid;
  if (n >= N) return;  // whole warps; no barrier follows
  uint8_t* qs = smem + align16(TAB_INTS * 4) + wid * warp_bytes(Lq, B, D);
  uint8_t* ws = qs + align16(Lq);
  uint8_t* wr = ws + align16(Lq + 32 * D);
  uint8_t* blk = wr + align16(Lq + B);
  const int go1 = gap_open + gap_extend, ge = gap_extend;
  const int Bp = (B + 3) & ~3;                  // plane bytes a row
  const size_t S = (size_t)align16(Lq * Bp);    // plane bytes a hit
  const int frame = min(max(packed[2 * N + n], 0), 5);
  const int8_t* qn = q3 + ((size_t)(n / K) * 6 + frame) * Lq;
  const int8_t* wn = w + (size_t)n * Wl;
  const int g0 = packed[6 * N + n], lo = lo_[n], hi = hi_[n];
  for (int p = lane; p < Lq; p += 32) qs[p] = (uint8_t)__ldg(qn + p);
  for (int p = lane; p < Lq + 32 * D; p += 32)
    ws[p] = (uint8_t)rcode(wn, p, Wl, g0, lo, hi);
  for (int p = lane; p < Lq + B; p += 32) wr[p] = (uint8_t)__ldg(wn + p);
  __syncwarp();

  const int p0 = D * lane;
  const int nb = min(max(B - p0, 0), D);   // this lane's diagonals in band
  uint8_t* prow = plane + (size_t)n * S + p0;
  int H[D], F[D];   // H and F1 = F + go1 of the lane's diagonals
#pragma unroll
  for (int k = 0; k < D; ++k) {
    H[k] = 0;
    F[k] = NEG + go1;
  }
  // the scores of a row are loaded a row ahead; H and F1 of diagonal b + 1
  // for the lane's last register come from the next lane
  int sv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) sv[k] = tab[(qs[0] & 31) * TCOLS + ws[p0 + k]];
  int hup = __shfl_down_sync(FULL, H[0], 1);
  int fup = __shfl_down_sync(FULL, F[0], 1);
  const int zoff = (lane + 1) * D * ge;      // the scan's position term
  int best = 0, bi = 0;
  for (int i = 0; i < Lq; ++i) {
    // next row's scores (past the last row: smem inside the warp's own
    // arrays, not used)
    int sn[D];
    const int* tnext = tab + (qs[i + 1] & 31) * TCOLS;
#pragma unroll
    for (int k = 0; k < D; ++k) sn[k] = tnext[ws[i + 1 + p0 + k]];
    bool fo[D], dg[D];
    int acc = NEG;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      int hu = k < D - 1 ? H[k + 1] : hup;
      int fu = k < D - 1 ? F[k + 1] : fup;
      if (p0 + k + 1 >= B) {   // diagonal b + 1 lies past the band
        hu = NEG;
        fu = NEG + go1;
      }
      const int ht = cell1(H[k], F[k], hu, fu, sv[k], go1, ge, fo[k], dg[k]);
      acc = __viaddmax_s32(acc, -ge, ht);
    }
    // F1 and Ht of the next lane's first diagonal, off the row's chain
    fup = __shfl_down_sync(FULL, F[0], 1);
    const int htn = __shfl_down_sync(FULL, H[0], 1);
    // E1 entering each lane: a max-plus scan of E1 leaving the lanes
    // before it, as a plain prefix max of E1 leaving plus a position term
    // (a lane below d gets its own value back)
    const int z = acc + zoff;
    int x = __shfl_up_sync(FULL, z, 1);
    if (lane == 0) x = NEG;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) x = max(x, __shfl_up_sync(FULL, x, d));
    int e1 = lane > 0 ? x - (zoff - D * ge) : NEG + ge;
    // the next lane's final H at its first diagonal, from its Ht and the
    // E1 entering it, which this lane's scan value gives
    hup = max(htn, max(x, z) - zoff - go1);
    const int e10 = e1;
    int hl = NEG, rk = INT_MIN;
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      word |= cell2(H[k], e1, hl, fo[k], dg[k], go1, ge) << (8 * k);
      hl = H[k];
      if (k < nb) rk = max(rk, H[k] * 32 + (31 - k));
    }
    // e_open at the lane's first diagonal: the final H to its left
    int hleft = __shfl_up_sync(FULL, H[D - 1], 1);
    if (lane == 0) hleft = NEG;
    word = (word & ~4u) | (hleft >= e10 ? 4u : 0u);
    if (nb > 0) {
      uint8_t* p = prow + (size_t)i * Bp;
      if (D == 1)
        *p = (uint8_t)word;
      else if (D == 2)
        *reinterpret_cast<uint16_t*>(p) = (uint16_t)word;
      else
        *reinterpret_cast<uint32_t*>(p) = word;
    }
    if ((rk >> 5) > (best >> 5)) {  // a later row wins on H alone
      best = rk;
      bi = i;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) sv[k] = sn[k];
  }
  int sc, ie, be;
  {
    int bH[1] = {best >> 5}, bI[1] = {bi}, bb[1] = {p0 + 31 - (best & 31)};
    sw_finalize<1>(bH, bI, bb, B, 32, sc, ie, be);
  }
  __syncwarp();  // the warp's plane stores, visible to its loads below
  if (!walk) {
    if (lane == 0) {
      out[n] = sc;
      out[N + n] = ie;
      out[2 * N + n] = be;
    }
    return;
  }
  // the staged walk (lane 0's state)
  Walk wk(ie, be);
  int t = 0;
  const int bound = 2 * (Lq + B) + 4;
  const int T = (WALK_BYTES / Bp) & ~3;        // rows a block
  const int TB = T * Bp;                       // its bytes: 16-byte multiple
  const uint8_t* hp = plane + (size_t)n * S;   // this hit's plane
  constexpr int NV = WALK_BYTES / 16 / 32;     // 16-byte loads a lane
  int4 r[NV];
  // block k: rows [k T, k T + T), the hit's plane bytes [k TB, k TB + TB)
  // (S is a 16-byte multiple), loaded into registers
  auto fetch = [&](int k) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int off = (v * 32 + lane) * 16;
      if (off < TB && (size_t)k * TB + off < S)
        r[v] = *reinterpret_cast<const int4*>(hp + (size_t)k * TB + off);
    }
  };
  int st = wk.st;
  int k = st == 3 ? 0 : min(ie, Lq - 1) / T;
  if (st != 3) fetch(k);
  while (st != 3) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      reinterpret_cast<int4*>(blk)[v * 32 + lane] = r[v];
    __syncwarp();
    if (k > 0) fetch(k - 1);   // in flight while lane 0 walks this block
    if (lane == 0) {
      const int base = k * T;
      while (t < bound && wk.st != 3) {
        const int ii = min(max(wk.i, 0), Lq - 1);
        const int bb = min(max(wk.b, 0), B - 1);
        if (ii < base) break;   // left the block: the next is k - 1
        const unsigned mv = blk[(ii - base) * Bp + bb];
        if (wk.st == 0 && (mv & 3) == 1 && wk.b == bb) {
          // a run of diagonal moves in H: i >= base >= 0 and b in the
          // band, so each step only counts the match and moves up a row
          int i = wk.i, m = 0, l = 0;
          const int stop = max(base, i - (bound - t) + 1);
          const uint8_t* pm = blk + (i - base) * Bp + bb;
          unsigned c = 1;
          while (c == 1) {
            m += qs[i] == wr[i + bb];
            l += 1;
            i -= 1;
            pm -= Bp;
            c = i >= stop ? *pm & 3 : 0;
          }
          wk.matches += m;
          wk.mismatch += l - m;
          wk.length += l;
          wk.qstart = i + 1;
          wk.sstart = i + 1 + bb;
          wk.i = i;
          t += l;
          if (i < 0) wk.st = 3;
          continue;
        }
        wk.step(mv, qs[ii] == wr[ii + bb], B);
        ++t;
      }
      if (t >= bound) wk.st = 3;
      st = wk.st;
    }
    st = __shfl_sync(FULL, st, 0);
    k -= 1;
    __syncwarp();   // the block is read before the next overwrites it
  }
  if (lane == 0) wk.write(out, N, n, ie, be, sc);
}

// ---------------------------------------------------------------- launch

static int sm_count_of(int& dev) {
  static int sm_count[MAX_DEVICES];
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev >= MAX_DEVICES) return -(int)cudaErrorInvalidDevice;
  if (!sm_count[dev]) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -(int)e;
    sm_count[dev] = sms;
  }
  return sm_count[dev];
}

// One thread-layout launch over N * G lanes: blocks of 128 lanes, fewer
// when N would leave SMs idle.
template <int G, bool PART>
static int thread_instance(int sms, const int8_t* q3, const int32_t* packed,
                           const int8_t* w, const int32_t* lo,
                           const int32_t* hi, const int32_t* table, int N,
                           int K, int Lq, int Wl, int B, int gap_open,
                           int gap_extend, void* plane, int walk,
                           int32_t* out, cudaStream_t stream) {
  const long long lanes = (long long)N * G;
  const long long per_sm = (lanes / sms + 31) / 32;   // warps an SM
  const int threads = per_sm >= 4 ? 128 : per_sm < 1 ? 32 : (int)per_sm * 32;
  const int blocks = (int)((lanes + threads - 1) / threads);
  refine_thread<G, PART><<<blocks, threads, 0, stream>>>(
      q3, packed, w, lo, hi, table, N, K, Lq, Wl, B, gap_open, gap_extend,
      static_cast<unsigned*>(plane), walk, out);
  return (int)cudaGetLastError();
}

template <int D>
static int warp_instance(int dev, int blocks, int warps, int smem,
                         const int8_t* q3, const int32_t* packed,
                         const int8_t* w, const int32_t* lo,
                         const int32_t* hi, const int32_t* table, int N,
                         int K, int Lq, int Wl, int B, int gap_open,
                         int gap_extend, void* plane, int walk, int32_t* out,
                         cudaStream_t stream) {
  // the opt-in shared-memory size, set once a device (a benign race: every
  // thread sets the same value)
  static bool ready[MAX_DEVICES];
  if (!ready[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        refine_warp<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        RSMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  refine_warp<D><<<blocks, 32 * warps, smem, stream>>>(
      q3, packed, w, lo, hi, table, N, K, Lq, Wl, B, gap_open, gap_extend,
      static_cast<uint8_t*>(plane), walk, out);
  return (int)cudaGetLastError();
}

// q3: (R, 6, Lq) int8 frames; packed: (9, R, K) int32 ranked hits (row 2
// the frame, row 6 g0); w: (N, Wl) int8 windows, Wl >= Lq + B; lo, hi:
// (N,) int32 subject span; table: (32, 33) int32 (column 32 outside the
// span); N = R * K; 1 <= B <= 128; gap costs >= 0; H < 2^26 (the best
// cell's key). lanes: the layout's lanes an alignment, G = ceil(B / 32)
// rounded to 1, 2 or 4 (the thread layout; plane: Lq * ceil(B / 4) * N
// words of scratch) or 32 (the warp layout, G diagonals a lane; plane:
// N * S bytes, S = Lq * round_up(B, 4) rounded up to 16; Lq up to
// WARP_MAX_LQ); any other value is refused. walk != 0: out is (9, N)
// int32, the stat rows then the score; walk == 0 (the debug entry): out is (3, N), (score, i_end,
// b_end), and the plane holds the moves.
extern "C" int ghostm_refine(const int8_t* q3, const int32_t* packed,
                             const int8_t* w, const int32_t* lo,
                             const int32_t* hi, const int32_t* table, int N,
                             int K, int Lq, int Wl, int B, int gap_open,
                             int gap_extend, void* plane, int walk,
                             int lanes, int32_t* out, cudaStream_t stream) {
  const int D = (B + 31) / 32;
  if (D < 1 || D > 4 || K < 1 || Lq < 1) return (int)cudaErrorInvalidValue;
  const int G = D == 1 ? 1 : D == 2 ? 2 : 4;
  int dev = 0;
  const int sms = sm_count_of(dev);
  if (sms <= 0) return sms < 0 ? -sms : (int)cudaErrorInvalidDevice;
  if (lanes == 32) {   // the warp layout, G diagonals a lane
    if (Lq > WARP_MAX_LQ) return (int)cudaErrorInvalidValue;
    const int per = warp_bytes(Lq, B, G), tab = align16(TAB_INTS * 4);
    const int fit = (RSMEM_MAX - tab) / per;   // >= 1 (the static_assert)
    // up to RW_WARPS a block, fewer when N would leave SMs idle
    const int warps = max(1, min(min(RW_WARPS, fit), N / (8 * sms)));
    const int blocks = (N + warps - 1) / warps;
    const int smem = tab + warps * per;
#define LAUNCH(DD)                                                          \
  return warp_instance<DD>(dev, blocks, warps, smem, q3, packed, w, lo, hi, \
                           table, N, K, Lq, Wl, B, gap_open, gap_extend,    \
                           plane, walk, out, stream);
    if (G == 1) LAUNCH(1)
    if (G == 2) LAUNCH(2)
    LAUNCH(4)
#undef LAUNCH
  }
  if (lanes != G) return (int)cudaErrorInvalidValue;
  const bool part = B != 32 * G;
#define LAUNCH(GG, PP)                                                      \
  return thread_instance<GG, PP>(sms, q3, packed, w, lo, hi, table, N, K, \
                                 Lq, Wl, B, gap_open, gap_extend, plane,   \
                                 walk, out, stream);
  if (G == 1) {
    if (part) LAUNCH(1, true) else LAUNCH(1, false)
  } else if (G == 2) {
    if (part) LAUNCH(2, true) else LAUNCH(2, false)
  }
  if (part) LAUNCH(4, true) else LAUNCH(4, false)
#undef LAUNCH
}
