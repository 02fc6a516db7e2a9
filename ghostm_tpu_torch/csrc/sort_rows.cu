// Kernel B1: ascending sort of each row of a (Q, M) int32 array.
//
// Replaces ghostm_tpu/kernels/sort.py::_sort_kernel (entry sort_rows), the
// Pallas bitonic row sort that the propose phase's split sort runs on both
// halves of every key row ((6144, 4096) and (6144, 512) with 100 bp reads,
// (2944, 8192) and (2944, 2560) with 250 bp reads; presorted runs of 128).
//
// Bound on the H100: device-memory bytes. Each row is read once and written
// once (8 bytes per key); everything between stays on chip. The previous
// design ran every compare-exchange of the bitonic network as a
// shared-memory pass with a block barrier (50 passes over a 4096-key row,
// half of them 2-way bank-conflicted), so shared-memory traffic and
// barriers, not device memory, set its time.
//
// Design: a bitonic network held in registers. A row of L = 2^LOGL keys is
// spread over L / 32 threads, 32 keys each; blocks hold 128 threads (several
// rows when L < 4096). L is a template parameter (one instance per power of
// two from 128 to 16384), so every stride, layout and loop is a
// compile-time constant and the network unrolls.
//  * Layouts. In layout LO a thread's 32 registers hold the keys whose
//    index bits LO .. LO+4 are the register number; its other index bits
//    come from the thread number. A compare-exchange at stride 2^j with
//    LO <= j < LO + 5 is two register instructions (min, max): no memory,
//    no barrier. Each run of strides is served by one layout: strides
//    below 32 by LO = 0, larger ones by LO >= 5 chosen to cover as many of
//    the stage's next strides as it can. Changing layout is one trip
//    through shared memory (write, barrier, read): 1-3 per stage instead
//    of one pass per stride (a 4096-key row with runs of 128: 11 trips
//    instead of 50 passes). The first stage reads the loaded row straight
//    into the layout of its largest stride.
//  * No bank conflicts. Rows of up to 8192 keys get one padding word per
//    32 keys, so a register's word is its thread's base word plus a
//    constant (an immediate offset: no address arithmetic, few
//    registers); the 16,384-key row, which padding would push past 64 KB,
//    XORs bits 0..4 of the index by bits 5..9, 10..14 and 15..19. In
//    every layout used here the 32 lanes of a warp fall in 32 different
//    banks either way.
//  * No direction logic: before stage k the keys of each 2^k block whose
//    index has bit k set are complemented (~x reverses int32 order), so
//    every compare-exchange puts the minimum at the lower index; the
//    complement is undone at the next stage's start (one XOR per key and
//    stage) and is zero after the last stage.
//  * The presorted-run skip: starting at stage `first` needs each aligned
//    2^(first-1) block sorted ascending at even and descending at odd block
//    index (the JAX package's contract); first = 1 sorts arbitrary rows.
//  * Rows are read and written with 16-byte accesses when M % 4 == 0 and
//    the tensors are 16-byte aligned, else with a scalar edge; keys past M
//    are PAD (sorts after every key) and are never written back.
// Shared memory: the block's rows and their padding (33 KB at L = 8192; the
// unpadded 64 KB at L = 16384 is above the 48 KB default, so the launch
// opts in). The network, its layouts and the row load live in bitonic.cuh,
// which sort_vote.cu's monolithic entry of kernel B2 shares.
//
// Rows longer than one block holds (M > 16384: the chained long-read rows,
// (768, 27600) at 5 kbp and (384, 55248) at 10 kbp with 16-wide seed
// tables; the TPU kernel sorts them in one block of 96 MB of VMEM) take
// two entries, launched by the wrapper:
//  * ghostm_sort_tiles: one block a tile of T = 16384 keys of a row, sorted
//    by the L = 16384 network above (the same functions; T is a multiple of
//    2 x run, so a tile keeps the presorted-run skip). Only a row's last
//    tile is short; it is padded with PAD in shared memory, so device
//    memory moves M keys a row, not the next power of two.
//  * ghostm_merge_pass, ceil(log2(tiles)) times: merges each pair of
//    sorted runs of `width` keys (the last run of a row may be short or
//    have no partner). A block owns SPAN output keys; two threads find
//    where the span starts and ends in both runs by a co-rank (merge-path)
//    search in device memory (vote.cuh's co_rank, the search B2's merge
//    entry runs in shared memory), the block stages both ranges in shared
//    memory, each thread merges SPAN / MT keys from its own co-rank, and
//    the span leaves with coalesced 16-byte stores. Bound: bytes, 8 a key
//    a pass.
#include "vote.cuh"

namespace {

template <int LOGL>
__global__ void __launch_bounds__(Shape<LOGL>::NT)
    sort_rows_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                     int Q, int M, int first, int vec) {
  using S = Shape<LOGL>;
  using W = Words<LOGL>;
  constexpr int L = S::L;
  extern __shared__ int32_t s[];
  const int r = threadIdx.x / S::TR, t = threadIdx.x % S::TR;
  const size_t row0 = (size_t)blockIdx.x * S::ROWS;
  load_rows<LOGL>(x, s, Q, M, row0, vec);
  __syncthreads();
  sort_rows_smem<LOGL>(s, r, t, first);
  if (vec) {
    for (int a = threadIdx.x * 4; a < S::ROWS * L; a += S::NT * 4) {
      const size_t row = row0 + (a >> LOGL);
      const int c = a & (L - 1);
      if (row < (size_t)Q && c < M)
        *reinterpret_cast<int4*>(out + row * M + c) =
            make_int4(s[W::of(a)], s[W::of(a + 1)], s[W::of(a + 2)],
                      s[W::of(a + 3)]);
    }
  } else {
    for (int a = threadIdx.x; a < S::ROWS * L; a += S::NT) {
      const size_t row = row0 + (a >> LOGL);
      const int c = a & (L - 1);
      if (row < (size_t)Q && c < M) out[row * M + c] = s[W::of(a)];
    }
  }
}

template <int LOGL>
int launch(const int32_t* x, int32_t* out, int Q, int M, int first, int vec,
           cudaStream_t stream) {
  using S = Shape<LOGL>;
  const int shm = S::WORDS * (int)sizeof(int32_t);
  if (!row_smem_ok(sort_rows_kernel<LOGL>, shm))
    return (int)cudaErrorInvalidValue;
  const int grid = (Q + S::ROWS - 1) / S::ROWS;
  sort_rows_kernel<LOGL><<<grid, S::NT, shm, stream>>>(x, out, Q, M, first,
                                                       vec);
  return (int)cudaGetLastError();
}

constexpr int TILE_LOG = 14;
constexpr int TILE = 1 << TILE_LOG;

__global__ void __launch_bounds__(Shape<TILE_LOG>::NT)
    sort_tiles_kernel(const int32_t* __restrict__ x,
                      int32_t* __restrict__ out, int M, int tiles, int first,
                      int vec) {
  using S = Shape<TILE_LOG>;   // one row a block: 512 threads
  using W = Words<TILE_LOG>;
  extern __shared__ int32_t s[];
  const int r = threadIdx.x / S::TR, t = threadIdx.x % S::TR;
  const int tile = blockIdx.x % tiles;
  const size_t base = (size_t)(blockIdx.x / tiles) * M + (size_t)tile * TILE;
  const int n = min(TILE, M - tile * TILE);
  load_rows<TILE_LOG>(x + base, s, 1, n, 0, vec);
  __syncthreads();
  sort_rows_smem<TILE_LOG>(s, r, t, first);
  int32_t* o = out + base;
  if (vec) {
    for (int a = threadIdx.x * 4; a < n; a += S::NT * 4)
      *reinterpret_cast<int4*>(o + a) =
          make_int4(s[W::of(a)], s[W::of(a + 1)], s[W::of(a + 2)],
                    s[W::of(a + 3)]);
  } else {
    for (int a = threadIdx.x; a < n; a += S::NT) o[a] = s[W::of(a)];
  }
}

constexpr int SPAN = 4096;   // output keys a merge block
constexpr int MT = 256;      // threads a merge block: 16 keys each

__global__ void __launch_bounds__(MT)
    merge_pass_kernel(const int32_t* __restrict__ in,
                      int32_t* __restrict__ out, int M, int width, int spans,
                      int vec) {
  __shared__ int32_t stage[SPAN];   // the span's a range, then its b range
  __shared__ __align__(16) int32_t merged[SPAN];
  __shared__ int cut[2];
  const size_t row = blockIdx.x / spans;
  const int d0 = (blockIdx.x % spans) * SPAN;   // span start in the row
  const int p0 = d0 / (2 * width) * (2 * width);   // its pair of runs
  const int na = min(width, M - p0);
  const int nb = max(0, min(width, M - p0 - width));
  const int32_t* a = in + row * M + p0;
  const int32_t* b = a + na;
  const int lo = d0 - p0, hi = min(lo + SPAN, na + nb);
  if (threadIdx.x < 2)
    cut[threadIdx.x] = co_rank(a, na, b, nb, threadIdx.x ? hi : lo);
  __syncthreads();
  const int i0 = cut[0], i1 = cut[1];
  const int j0 = lo - i0, j1 = hi - i1;
  const int sa = i1 - i0, n = hi - lo;
  for (int i = threadIdx.x; i < n; i += MT)
    stage[i] = i < sa ? a[i0 + i] : b[j0 + i - sa];
  __syncthreads();
  const int32_t* ga = stage;
  const int32_t* gb = stage + sa;
  const int sb = j1 - j0;
  const int d = threadIdx.x * (SPAN / MT);
  if (d < n) {
    int ia = co_rank(ga, sa, gb, sb, d), ib = d - ia;
    const int e = min(d + SPAN / MT, n);
    for (int p = d; p < e; ++p)
      merged[p] = ib >= sb || (ia < sa && ga[ia] <= gb[ib]) ? ga[ia++]
                                                            : gb[ib++];
  }
  __syncthreads();
  int32_t* o = out + row * M + d0;
  if (vec) {
    for (int i = threadIdx.x * 4; i < n; i += MT * 4)
      *reinterpret_cast<int4*>(o + i) =
          *reinterpret_cast<const int4*>(merged + i);
  } else {
    for (int i = threadIdx.x; i < n; i += MT) o[i] = merged[i];
  }
}

}  // namespace

// x, out: (Q, M) int32, contiguous; L = pow2 >= max(M, 128), L <= 16384;
// first = log2(presorted run) + 1; vec: M % 4 == 0 and x, out 16-byte
// aligned.
extern "C" int ghostm_sort_rows(const int32_t* x, int32_t* out, int Q, int M,
                                int L, int first, int vec,
                                cudaStream_t stream) {
  switch (L) {
    case 1 << 7: return launch<7>(x, out, Q, M, first, vec, stream);
    case 1 << 8: return launch<8>(x, out, Q, M, first, vec, stream);
    case 1 << 9: return launch<9>(x, out, Q, M, first, vec, stream);
    case 1 << 10: return launch<10>(x, out, Q, M, first, vec, stream);
    case 1 << 11: return launch<11>(x, out, Q, M, first, vec, stream);
    case 1 << 12: return launch<12>(x, out, Q, M, first, vec, stream);
    case 1 << 13: return launch<13>(x, out, Q, M, first, vec, stream);
    case 1 << 14: return launch<14>(x, out, Q, M, first, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Long rows, step 1: x, out (Q, M) int32, contiguous, M > 16384; every
// 16384-key tile of a row sorted ascending into out from stage `first`
// (each tile holds whole presorted runs); vec: M % 4 == 0 and x, out
// 16-byte aligned.
extern "C" int ghostm_sort_tiles(const int32_t* x, int32_t* out, int Q,
                                 int M, int first, int vec,
                                 cudaStream_t stream) {
  using S = Shape<TILE_LOG>;
  const int tiles = (M + TILE - 1) / TILE;
  const int shm = S::WORDS * (int)sizeof(int32_t);
  if (!row_smem_ok(sort_tiles_kernel, shm)) return (int)cudaErrorInvalidValue;
  if ((long long)Q * tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  sort_tiles_kernel<<<Q * tiles, S::NT, shm, stream>>>(x, out, M, tiles,
                                                        first, vec);
  return (int)cudaGetLastError();
}

// Long rows, step 2: in, out (Q, M) int32, contiguous; each row of `in`
// holds sorted runs of `width` keys (width a multiple of 16384, the last
// run of a row shorter); out gets each pair of runs merged (a run with no
// partner copied). vec: M % 4 == 0 and in, out 16-byte aligned.
extern "C" int ghostm_merge_pass(const int32_t* in, int32_t* out, int Q,
                                 int M, int width, int vec,
                                 cudaStream_t stream) {
  const int spans = (M + SPAN - 1) / SPAN;
  if (width % SPAN || (long long)Q * spans > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  merge_pass_kernel<<<Q * spans, MT, 0, stream>>>(in, out, M, width, spans,
                                                  vec);
  return (int)cudaGetLastError();
}
