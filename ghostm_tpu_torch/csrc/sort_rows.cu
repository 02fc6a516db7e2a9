// Kernel B1: ascending sort of each row of a (Q, M) int32 array.
//
// Replaces ghostm_tpu/kernels/sort.py::_sort_kernel (entry sort_rows), the
// Pallas bitonic row sort that the propose phase's split sort runs on both
// halves of every key row ((6144, 4096) and (6144, 512) at config-2).
//
// Bound on the H100: device-memory bytes. Each row is read once and written
// once (8 bytes per key); the bitonic passes run in shared memory, where
// 50 passes over a 4096-key row move ~1.6 MB of shared traffic per row.
// Design: one thread block per row, the row padded to a power of two L with
// PAD and held in shared memory (16 KB at L = 4096; above 48 KB the launch
// opts in, up to 64 KB at L = 16384), the network started at
// stage `first` to skip the presorted runs. Simple first version: one
// compare-exchange per thread per pass with __syncthreads() between passes
// (register-resident passes for small strides are later work).
#include "bitonic.cuh"

__global__ void sort_rows_kernel(const int32_t* __restrict__ x,
                                 int32_t* __restrict__ out, int M, int L,
                                 int first) {
  extern __shared__ int32_t s[];
  const int32_t* row = x + (size_t)blockIdx.x * M;
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    s[i] = i < M ? row[i] : GHOSTM_PAD;
  __syncthreads();
  bitonic_block(s, L, first);
  int32_t* o = out + (size_t)blockIdx.x * M;
  for (int i = threadIdx.x; i < M; i += blockDim.x) o[i] = s[i];
}

// x, out: (Q, M) int32, contiguous; L = pow2 >= max(M, 128) with
// L * 4 <= 64 KB; first = log2(presorted run) + 1.
extern "C" int ghostm_sort_rows(const int32_t* x, int32_t* out, int Q, int M,
                                int L, int first, cudaStream_t stream) {
  const int threads = L / 2 < 1024 ? L / 2 : 1024;
  const int shm = L * (int)sizeof(int32_t);
  if (!row_smem_ok(sort_rows_kernel, shm)) return (int)cudaErrorInvalidValue;
  sort_rows_kernel<<<Q, threads, shm, stream>>>(x, out, M, L, first);
  return (int)cudaGetLastError();
}
