// Row-scatter kernel of rechorus_tpu_torch for Hopper (sm_90a), bound to
// Python with ctypes (rechorus_tpu_torch/ops/_build.py).
//
//   rtt_scatter_rows_kernel  rechorus_tpu/ops/pallas_scatter.py::scatter_rows
//                            (_scatter_kernel)
//
// Computes table[rows[i]] = block[i] in place for UNIQUE row ids; a row id
// outside [0, N) is dropped. Rows that are not named are never read or
// written, so nothing of the table is copied. It is the per-step commit of
// the sparse lazy-Adam lanes (rechorus_tpu_torch/ops/lazy_adam.py).
//
// The TPU kernel sends one DMA per row through a DEPTH-8 software
// pipeline, with the ids prefetched into scalar memory, R padded to a
// multiple of the rows per grid step, and the row width held to the
// 128-lane tile. None of that carries over: here every thread loads the id
// of the row its unit belongs to and copies one unit, and threads are laid
// out over the flat [R, units_per_row] block so that both the reads of
// `block` and the writes inside a row are coalesced.
//
// Bounded by bytes: 2 * R_valid * row_bytes (each block row read once, each
// table row written once) + 4 * R for the ids. For the packed [1M, 192] f32
// item table at R = 8192 that is 12.6 MB, about 3.8 us at 3.35 TB/s; the
// Python wrapper around the launch costs several times that.
//
// Rows are treated as bytes, so one kernel serves f32 and bf16 at any
// width: 16-byte units where row_bytes % 16 == 0 and both bases are 16-byte
// aligned, else 4-, 2- or 1-byte units. Offsets are 64-bit: N * row_bytes
// passes 2^31 at a few million packed rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kScatterThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // grid-stride beyond this
}  // namespace

template <typename T>
__global__ void __launch_bounds__(kScatterThreads)
rtt_scatter_rows_kernel(T* __restrict__ table, const int* __restrict__ rows,
                        const T* __restrict__ block, int64_t N, int64_t units_per_row,
                        int64_t total_units) {
  const int64_t stride = (int64_t)gridDim.x * kScatterThreads;
  for (int64_t idx = (int64_t)blockIdx.x * kScatterThreads + threadIdx.x; idx < total_units;
       idx += stride) {
    const int64_t i = idx / units_per_row;
    const int64_t c = idx - i * units_per_row;
    const int64_t r = rows[i];
    if (r >= 0 && r < N) table[(size_t)r * (size_t)units_per_row + (size_t)c] = block[idx];
  }
}

namespace {
template <typename T>
int launch_scatter(void* table, const int* rows, const void* block, int64_t N, int64_t R,
                   int64_t row_bytes, cudaStream_t stream) {
  const int64_t upr = row_bytes / (int64_t)sizeof(T);
  const int64_t total = R * upr;
  int64_t blocks = (total + kScatterThreads - 1) / kScatterThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  rtt_scatter_rows_kernel<T><<<(unsigned)blocks, kScatterThreads, 0, stream>>>(
      (T*)table, rows, (const T*)block, N, upr, total);
  return cudaGetLastError();
}
}  // namespace

extern "C" int rtt_scatter_rows(void* table, const int* rows, const void* block, int64_t N,
                                int64_t R, int64_t row_bytes, cudaStream_t stream) {
  if (N <= 0 || R <= 0 || row_bytes <= 0) return cudaErrorInvalidValue;
  const uintptr_t bases = (uintptr_t)table | (uintptr_t)block;
  const uintptr_t all = bases | (uintptr_t)row_bytes;
  if (all % 16 == 0) return launch_scatter<uint4>(table, rows, block, N, R, row_bytes, stream);
  if (all % 4 == 0) return launch_scatter<uint32_t>(table, rows, block, N, R, row_bytes, stream);
  if (all % 2 == 0) return launch_scatter<uint16_t>(table, rows, block, N, R, row_bytes, stream);
  return launch_scatter<uint8_t>(table, rows, block, N, R, row_bytes, stream);
}
