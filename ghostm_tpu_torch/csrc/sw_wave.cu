// Kernel B6: banded Smith-Waterman (Gotoh, affine gaps) on a precomputed
// score tile, as an anti-diagonal wavefront.
//
// Replaces ghostm_tpu/kernels/sw_wave.py::_wave_kernel (entry
// sw_banded_wave), the engine's score-fed align path at frames of 64
// residues and more (250 bp reads, long frames). Same function as B5:
// (N, Lq, B) int8 (MASKED_I8 = masked) or int32 tile -> per alignment
// (score, i_end, b_end): max score, then min i, then min b; (-1, -1) when
// the score is <= 0.
//
// Recurrence (sw_wave.py:106-132): the B diagonals split into pairs, the
// even diagonal 2m and the odd diagonal 2m + 1; at step a both sit at row
// a - m. A step advances the evens from the odds' carried state, then the
// odds from the new evens, so every Gotoh dependency is the same pair or a
// neighbouring one:
//   even: E <- pair m - 1's max(Ho - go1, Eo - ge)  (__shfl_up_sync)
//         F <- max(Ho - go1, Fo - ge)               (same pair)
//   odd:  E <- max(He - go1, Ee - ge)               (same pair)
//         F <- pair m + 1's max(He - go1, Fe - ge)  (__shfl_down_sync)
// No prefix scan: two shuffles a step for two cells a lane.
//
// Layout: a group of GW lanes (8, 16 or 32, the least power of two that
// holds B / 2 pairs, at most 32) per alignment, so a warp runs 32 / GW
// alignments at band 32; lane l holds the P = ceil(B / 2 / GW) pairs
// m = l * P + p. The TPU kernel read pre-skewed slabs from HBM; here the
// group stages the unskewed tile in shared memory TS rows at a time with
// coalesced 16-byte loads, into a ring of ring_rows >= TS + B / 2 - 1 rows,
// and each lane reads its pair's two cells sc[n, a - m, 2m .. 2m + 1] from
// the ring (one 2- or 8-byte shared load). Rows outside [0, Lq) read NEG.
// The best cell per diagonal is kept in registers (bH, bI) and updated on a
// strict '>' in row order, which equals the TPU kernel's packed
// (H << SH | inv-row) max followed by _finalize.
//
// Bound on the H100: integer operations (~12 per cell), plus the B / 2 - 1
// extra steps of the wavefront's ramp; the tile is read from device memory
// once.
#include "sw_common.cuh"

// Copy `bytes` from global to shared memory with the group's lanes: 16
// bytes a load where both addresses and the length allow (every tile of
// the engine's main path), else byte by byte.
__device__ __forceinline__ void stage(unsigned char* __restrict__ dst,
                                      const unsigned char* __restrict__ src,
                                      int bytes, int gl, int GW) {
  const uintptr_t al = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)bytes;
  if ((al & 15) == 0) {
    for (int k = gl; k < (bytes >> 4); k += GW)
      reinterpret_cast<uint4*>(dst)[k] =
          __ldg(reinterpret_cast<const uint4*>(src) + k);
  } else {
    for (int k = gl; k < bytes; k += GW) dst[k] = __ldg(src + k);
  }
}

template <typename T>
__device__ __forceinline__ void read_pair(const unsigned char* cell, int& se,
                                          int& so);
template <>
__device__ __forceinline__ void read_pair<int8_t>(const unsigned char* cell,
                                                  int& se, int& so) {
  const char2 v = *reinterpret_cast<const char2*>(cell);
  se = widen((int8_t)v.x);
  so = widen((int8_t)v.y);
}
template <>
__device__ __forceinline__ void read_pair<int32_t>(const unsigned char* cell,
                                                   int& se, int& so) {
  const int2 v = *reinterpret_cast<const int2*>(cell);
  se = v.x;
  so = v.y;
}

template <typename T, int P>
__global__ void sw_wave_kernel(const T* __restrict__ sc, int N, int Lq, int B,
                               int GW, int TS, int ring_rows, int ring_stride,
                               int go1, int ge, int32_t* __restrict__ score,
                               int32_t* __restrict__ iend,
                               int32_t* __restrict__ bend) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = B >> 1;
  const int gl = threadIdx.x & (GW - 1);
  const int group = threadIdx.x / GW;
  const int per_block = blockDim.x / GW;
  // whole warps exit (there is no block barrier); a warp's other groups
  // past N recompute alignment N - 1 and store nothing, so that every
  // lane of the warp takes part in the shuffles
  const int warp_first =
      blockIdx.x * per_block + (threadIdx.x >> 5) * (32 / GW);
  if (warp_first >= N) return;
  const int n_raw = blockIdx.x * per_block + group;
  const bool live = n_raw < N;
  const int n = live ? n_raw : N - 1;
  const int rowbytes = B * (int)sizeof(T);
  const unsigned char* tile =
      reinterpret_cast<const unsigned char*>(sc) + (size_t)n * Lq * rowbytes;
  unsigned char* ring = smem + (size_t)group * ring_stride;

  int He[P], Ho[P], Eo[P], Fo[P], bHe[P], bIe[P], bHo[P], bIo[P], slot[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int m = gl * P + p;
    He[p] = 0;
    Ho[p] = 0;
    Eo[p] = NEG;
    Fo[p] = NEG;
    bHe[p] = 0;
    bIe[p] = 0;
    bHo[p] = 0;
    bIo[p] = 0;
    slot[p] = (ring_rows - m % ring_rows) % ring_rows;  // slot of row -m
  }
  const int A = Lq + h - 1;
  for (int a0 = 0; a0 < A; a0 += TS) {
    // rows [a0, a0 + TS) go to slots a0 % ring_rows ..: ring_rows is a
    // multiple of TS, so they never wrap; the ring still holds the
    // B / 2 - 1 rows before a0 that this block's steps read
    __syncwarp();
    if (a0 < Lq)
      stage(ring + (size_t)(a0 % ring_rows) * rowbytes,
            tile + (size_t)a0 * rowbytes, min(TS, Lq - a0) * rowbytes, gl,
            GW);
    __syncwarp();
    const int a1 = min(a0 + TS, A);
    for (int a = a0; a < a1; ++a) {
      int se[P], so[P], row[P];
      bool ok[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int m = gl * P + p;
        row[p] = a - m;
        ok[p] = m < h && row[p] >= 0 && row[p] < Lq;
        se[p] = NEG;
        so[p] = NEG;
        if (ok[p])
          read_pair<T>(ring + (size_t)slot[p] * rowbytes +
                           2 * m * (int)sizeof(T),
                       se[p], so[p]);
        slot[p] = slot[p] + 1 == ring_rows ? 0 : slot[p] + 1;
      }
      // even half-step: diagonals 2m at row a - m
      int t[P], Ee[P], Fe[P];
#pragma unroll
      for (int p = 0; p < P; ++p) t[p] = max(Ho[p] - go1, Eo[p] - ge);
      int up = __shfl_up_sync(FULL, t[P - 1], 1, GW);
      if (gl == 0) up = NEG;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        Ee[p] = p == 0 ? up : t[p - 1];
        Fe[p] = max(Ho[p] - go1, Fo[p] - ge);
        He[p] = max(max(He[p] + se[p], 0), max(Ee[p], Fe[p]));
        if (ok[p] && He[p] > bHe[p]) {
          bHe[p] = He[p];
          bIe[p] = row[p];
        }
      }
      // odd half-step: diagonals 2m + 1 at row a - m, from the new evens
      int u[P];
#pragma unroll
      for (int p = 0; p < P; ++p) u[p] = max(He[p] - go1, Fe[p] - ge);
      const int dn = __shfl_down_sync(FULL, u[0], 1, GW);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int m = gl * P + p;
        int f = p + 1 < P ? u[p + 1] : dn;
        if (m + 1 >= h) f = NEG;
        Eo[p] = max(He[p] - go1, Ee[p] - ge);
        Fo[p] = f;
        Ho[p] = max(max(Ho[p] + so[p], 0), max(Eo[p], Fo[p]));
        if (ok[p] && Ho[p] > bHo[p]) {
          bHo[p] = Ho[p];
          bIo[p] = row[p];
        }
      }
    }
  }
  int cH[2 * P], cI[2 * P], cb[2 * P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int m = gl * P + p;
    const int far = 1 << 30;  // pairs past B / 2 take no part
    cH[2 * p] = bHe[p];
    cI[2 * p] = bIe[p];
    cb[2 * p] = m < h ? 2 * m : far;
    cH[2 * p + 1] = bHo[p];
    cI[2 * p + 1] = bIo[p];
    cb[2 * p + 1] = m < h ? 2 * m + 1 : far;
  }
  int best, ci, cbest;
  sw_finalize<2 * P>(cH, cI, cb, B, GW, best, ci, cbest);
  if (live && gl == 0) {
    score[n] = best;
    iend[n] = ci;
    bend[n] = cbest;
  }
}

// sc: (N, Lq, B) contiguous, int8 (is_i8 = 1) or int32;
// B even, 16 <= B <= 128; go1 = gap_open + gap_extend, ge = gap_extend;
// outputs (N,) int32.
extern "C" int ghostm_sw_wave(const void* sc, int is_i8, int N, int Lq,
                              int B, int go1, int ge, int32_t* score,
                              int32_t* iend, int32_t* bend,
                              cudaStream_t stream) {
  if (B % 2 || B < 16 || B > 128) return (int)cudaErrorInvalidValue;
  const int h = B / 2;
  const int GW = h <= 8 ? 8 : h <= 16 ? 16 : 32;
  const int P = (h + GW - 1) / GW;
  const int rowbytes = B * (is_i8 ? 1 : 4);
  const int limit = 48 << 10;  // dynamic shared memory without opt-in
  int TS = 32, ring_rows = 0, ring_stride = 0, warps = 0;
  for (; TS >= 8; TS >>= 1) {
    ring_rows = TS * ((TS + h - 1 + TS - 1) / TS);
    // +64 bytes: the two groups of a warp at band 32 hit other banks
    ring_stride = (ring_rows * rowbytes + 15) / 16 * 16 + 64;
    warps = limit / ((32 / GW) * ring_stride);
    if (warps > 4) warps = 4;
    if (warps > 0) break;
  }
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const int per_block = warps * (32 / GW);
  const int blocks = (N + per_block - 1) / per_block;
  const size_t shm = (size_t)per_block * ring_stride;
#define LAUNCH(TT, PP)                                                      \
  sw_wave_kernel<TT, PP><<<blocks, 32 * warps, shm, stream>>>(              \
      (const TT*)sc, N, Lq, B, GW, TS, ring_rows, ring_stride, go1, ge,     \
      score, iend, bend)
  if (is_i8) {
    if (P == 1) LAUNCH(int8_t, 1); else LAUNCH(int8_t, 2);
  } else {
    if (P == 1) LAUNCH(int32_t, 1); else LAUNCH(int32_t, 2);
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
