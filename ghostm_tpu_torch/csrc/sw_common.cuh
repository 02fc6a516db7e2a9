// The banded Smith-Waterman DP (Gotoh, affine gaps) from codes, shared by
// kernel B3 (sw_fused.cu: BLOSUM62-class matrices, an int8 (32, 32) table)
// and kernels B5 and B6 (sw_scored.cu: the score-fed route, an int32
// (32, 33) table). Per alignment it returns (score, i_end, b_end): max
// score, then min i, then min b; (-1, -1) when the score is <= 0 — equal
// to sw_xla.sw_banded on the score tile the table describes.
//
// Bound on the H100: instruction issue. The DP reads 2 Lq + B code bytes
// an alignment (112 for 1280 cells at Lq 40, band 32) and needs ~10
// integer instructions a cell. Design:
//  - One thread per alignment at B <= 32 (G = 2 or 4 lanes of 32 diagonals
//    each for wider bands). A thread holds its diagonals' H and F in
//    registers and walks a row's diagonals in order: F comes from the
//    register of diagonal b + 1, not yet overwritten, and E is a scalar
//    carried along the row. No shuffle in the DP at B <= 32; wider bands
//    take F across the lane boundary and E by a scan over the G lanes, once
//    a row.
//  - The recurrences are Hopper's DPX instructions (__viaddmax_s32 =
//    max(a + b, c)). E and F are held plus go1, so each takes one.
//  - The best cell is a key H * 32 + (31 - k), maxed over the row by
//    __vimax3_s32 (max H, then min k); once a row a strict '>' on H alone
//    keeps the first row. That gives max score, then min i, then min b
//    with no per-diagonal finalize. The key fits an int32 while H < 2^26.
//  - Codes arrive 4 to a register, one word a 4-row group, with the span
//    [rel_lo, rel_hi) folded in as code 32 (a column of the table): a
//    cell's byte index is static and there is no per-cell span test.
//  - The score table sits in shared memory as int32, one copy per lane:
//    entry x of lane l at word 32 x + l, so a lookup never meets a bank
//    conflict (132 KB: one block an SM, of up to 512 threads; fewer when N
//    would not fill every SM).
// Bands that are not a multiple of 32 carry diagonals past the band; they
// are held at VNEG, so no path through them reaches the band (exact for
// gap costs >= 0: the wrappers refuse negative ones).
#pragma once
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define NEG (-(1 << 30))
#define MASKED_I8 (-128)
#define FULL 0xffffffffu
#define THREADS 512               // at most, a block
#define TCOLS 33                  // window codes 0..31, then MASK_CODE
#define MASK_CODE 32              // a window position outside the span
#define TAB_WORDS (32 * TCOLS * 32)
#define VNEG (-(1 << 24))         // H and F of a diagonal past the band
#define MAX_DEVICES 64
#define SMEM_BYTES (TAB_WORDS * (int)sizeof(int))

// What differs between the instances: the table a caller passes, staged
// once into shared memory as RAW bytes (16-byte aligned) and read there as
// the int32 value of (query code qc, column c).
template <typename T>
struct TableIn;
// B3: the (32, 32) int8 matrix table, MASKED_I8 = masked; the span column
// is masked (NEG).
template <>
struct TableIn<int8_t> {
  static constexpr int RAW = 32 * 32;
  __device__ static int at(const int8_t* raw, int qc, int c) {
    int v = NEG;
    if (c < 32) {
      const int t = raw[qc * 32 + c];
      if (t != MASKED_I8) v = t;
    }
    return v;
  }
};
// B5 and B6: the (32, 33) int32 table as it is (NEG or LOW where masked,
// column MASK_CODE included).
template <>
struct TableIn<int32_t> {
  static constexpr int RAW = 32 * TCOLS * 4;
  __device__ static int at(const int32_t* raw, int qc, int c) {
    return raw[qc * TCOLS + c];
  }
};

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

// Window codes at positions p .. p + 3, a byte each; MASK_CODE outside
// [lo, hi) (hi <= Wl, so nothing past the window is read).
__device__ __forceinline__ unsigned window4(const int8_t* __restrict__ wn,
                                            int p, int lo, int hi) {
  unsigned word = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = p + u;
    const unsigned c =
        j >= lo && j < hi ? (unsigned)(__ldg(wn + j) & 31) : MASK_CODE;
    word |= c << (8 * u);
  }
  return word;
}

// Query codes of rows i .. i + 3 (0 past Lq), a byte each.
__device__ __forceinline__ unsigned query4(const int8_t* __restrict__ qn,
                                           int i, int Lq) {
  unsigned word = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (i + u < Lq) word |= (unsigned)(__ldg(qn + i + u) & 31) << (8 * u);
  return word;
}

// Row R of a 4-row group, over one lane's 32 diagonals. H holds
// the previous row's H and is overwritten by this row's; F holds F + go1
// likewise. W[m] holds the codes of window positions 4m .. 4m + 3 past the
// group's first row and the lane's first diagonal. trow: this row's table
// row for this lane (entry c at byte 128 c). Returns the row's maximum key.
template <int G, bool PART, int R>
__device__ __forceinline__ int sw_row(int (&H)[32], int (&F)[32],
                                      const unsigned (&W)[9],
                                      const char* __restrict__ trow, int g,
                                      int nb, int go1, int ge) {
  // H and F + go1 of diagonal b + 1 for the lane's last diagonal: the next
  // lane's first, or NEG past the band
  int hup = NEG, fup = NEG;
  if (G > 1) {
    hup = __shfl_down_sync(FULL, H[0], 1, G);
    fup = __shfl_down_sync(FULL, F[0], 1, G);
    if (g == G - 1) {
      hup = NEG;
      fup = NEG;
    }
  }
  // F and Ht (H before E) of every diagonal
  int acc = NEG;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const unsigned word = W[(R + k) >> 2];
    const int c = (word >> (8 * ((R + k) & 3))) & 0xff;
    const int s = *reinterpret_cast<const int*>(trow + (c << 7));
    const int hu = k < 31 ? H[(k + 1) & 31] : hup;
    const int fu = k < 31 ? F[(k + 1) & 31] : fup;
    const int fn = __viaddmax_s32(fu, -ge, hu);           // F + go1
    const int ht = __viaddmax_s32_relu(H[k], s, fn - go1);
    F[k] = PART && k >= nb ? VNEG : fn;
    H[k] = ht;
    if (G > 1) acc = __viaddmax_s32(acc, -ge, ht);
  }
  // E + go1 entering the lane: a max-plus scan over the lanes before it
  int E = NEG;
  if (G > 1) {
    int x = acc;   // E + go1 leaving this lane
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const int y = __shfl_up_sync(FULL, x, d, G);
      if (g >= d) x = max(x, y - d * 32 * ge);
    }
    E = __shfl_up_sync(FULL, x, 1, G);
    if (g == 0) E = NEG;
  }
  // H = max(Ht, E) and the row's best key
  int rk = INT_MIN, prev = INT_MIN;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int ht = H[k];
    int hn = __viaddmax_s32(E, -go1, ht);
    E = __viaddmax_s32(E, -ge, ht);
    if (PART && k >= nb) hn = VNEG;
    H[k] = hn;
    const int key = hn * 32 + (31 - k);
    if (k & 1)
      rk = __vimax3_s32(rk, prev, key);
    else
      prev = key;
  }
  return rk;
}

template <typename T, int G, bool PART>
__global__ void __launch_bounds__(THREADS, 1)
    sw_rows_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
                   const int32_t* __restrict__ rel_lo,
                   const int32_t* __restrict__ rel_hi,
                   const T* __restrict__ table, int N, int Lq, int Wl, int B,
                   int go1, int ge, int32_t* __restrict__ score,
                   int32_t* __restrict__ iend, int32_t* __restrict__ bend) {
  extern __shared__ __align__(16) int tab[];
  __shared__ __align__(16) T raw[TableIn<T>::RAW / sizeof(T)];
  // the table once into shared memory, then replicated from there: a
  // thread writes 4 lanes' copies of one entry a step
  for (int e = threadIdx.x; e < TableIn<T>::RAW / 16; e += blockDim.x)
    reinterpret_cast<int4*>(raw)[e] =
        __ldg(reinterpret_cast<const int4*>(table) + e);
  __syncthreads();
#pragma unroll 4
  for (int e = threadIdx.x * 4; e < TAB_WORDS; e += blockDim.x * 4) {
    const int x = e >> 5, qc = x / TCOLS, c = x - qc * TCOLS;
    const int v = TableIn<T>::at(raw, qc, c);
    *reinterpret_cast<int4*>(tab + e) = make_int4(v, v, v, v);
  }
  __syncthreads();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if ((tid & ~31) / G >= N) return;  // whole warps; no barrier follows
  const int g = G > 1 ? (int)(threadIdx.x & (G - 1)) : 0;
  const int n0 = tid / G;
  const int n = n0 < N ? n0 : N - 1;  // a warp's spare lanes redo the last
  const int8_t* qn = q + (size_t)n * Lq;
  const int8_t* wn = w + (size_t)n * Wl;
  const int lo = rel_lo[n], hi = min(rel_hi[n], Wl);
  const int nb = min(max(B - 32 * g, 0), 32);  // this lane's diagonals
  const int p0 = 32 * g;
  const char* tl = reinterpret_cast<const char*>(tab + (threadIdx.x & 31));

  int H[32], F[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const bool past = PART && k >= nb;
    H[k] = past ? VNEG : 0;
    F[k] = past ? VNEG : NEG;
  }
  unsigned W[9];
#pragma unroll
  for (int m = 0; m < 9; ++m) W[m] = window4(wn, p0 + 4 * m, lo, hi);
  unsigned qw = query4(qn, 0, Lq);
  int best = 0, bi = 0;
  for (int i = 0; i < Lq; i += 4) {
    const unsigned wnext = window4(wn, i + p0 + 36, lo, hi);
    const unsigned qnext = query4(qn, i + 4, Lq);
#define ROW(R)                                                            \
  {                                                                       \
    const char* trow = tl + ((((qw >> (8 * R)) & 0xff) * TCOLS) << 7);    \
    const int rk = sw_row<G, PART, R>(H, F, W, trow, g, nb, go1, ge);     \
    if ((rk >> 5) > (best >> 5)) { /* a later row wins on H alone */      \
      best = rk;                                                          \
      bi = i + R;                                                         \
    }                                                                     \
  }
    ROW(0)
    if (i + 1 >= Lq) break;
    ROW(1)
    if (i + 2 >= Lq) break;
    ROW(2)
    if (i + 3 >= Lq) break;
    ROW(3)
#undef ROW
#pragma unroll
    for (int m = 0; m < 8; ++m) W[m] = W[m + 1];
    W[8] = wnext;
    qw = qnext;
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
  if (n0 < N && g == 0) {
    score[n] = sc;
    iend[n] = ie;
    bend[n] = be;
  }
}

// One instance's launch. The opt-in shared-memory size is set once per
// device and instance (a benign race: every thread sets the same value).
template <typename T, int G, bool PART>
static int sw_rows_instance(int dev, int blocks, int threads,
                            const int8_t* q, const int8_t* w,
                            const int32_t* rel_lo, const int32_t* rel_hi,
                            const T* table, int N, int Lq, int Wl, int B,
                            int go1, int ge, int32_t* score, int32_t* iend,
                            int32_t* bend, cudaStream_t stream) {
  static bool ready[MAX_DEVICES];
  if (!ready[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_rows_kernel<T, G, PART>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  sw_rows_kernel<T, G, PART><<<blocks, threads, SMEM_BYTES, stream>>>(
      q, w, rel_lo, rel_hi, table, N, Lq, Wl, B, go1, ge, score, iend, bend);
  return (int)cudaGetLastError();
}

// q: (N, Lq) int8; w: (N, Wl) int8 with Wl >= Lq + B; rel_lo, rel_hi: (N,)
// int32 window-local subject span; table: 16-byte aligned, TableIn<T>'s
// layout; go1 = gap_open + gap_extend, ge = gap_extend, both >= 0; outputs
// (N,) int32. 1 <= B <= 128; H < 2^26 (the key's range).
template <typename T>
static int sw_rows(const int8_t* q, const int8_t* w, const int32_t* rel_lo,
                   const int32_t* rel_hi, const T* table, int N, int Lq,
                   int Wl, int B, int go1, int ge, int32_t* score,
                   int32_t* iend, int32_t* bend, cudaStream_t stream) {
  const int D = (B + 31) / 32;
  if (D < 1 || D > 4) return (int)cudaErrorInvalidValue;
  const int G = D == 1 ? 1 : D == 2 ? 2 : 4;
  const bool part = B != 32 * G;
  // spread a small N over every SM: a block of at least one warp; the SM
  // count is read once per device
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
  const int threads = per_sm >= THREADS / 32 ? THREADS
                      : per_sm < 1            ? 32
                                              : (int)per_sm * 32;
  const int blocks = (int)((lanes + threads - 1) / threads);
#define LAUNCH(GG, PP)                                                     \
  return sw_rows_instance<T, GG, PP>(dev, blocks, threads, q, w, rel_lo,   \
                                     rel_hi, table, N, Lq, Wl, B, go1, ge, \
                                     score, iend, bend, stream);
  if (G == 1) {
    if (part) LAUNCH(1, true) else LAUNCH(1, false)
  } else if (G == 2) {
    if (part) LAUNCH(2, true) else LAUNCH(2, false)
  }
  if (part) LAUNCH(4, true) else LAUNCH(4, false)
#undef LAUNCH
}
