// Catalog kernels of rechorus_tpu_torch for Hopper (sm_90a), bound to
// Python with ctypes (rechorus_tpu_torch/ops/_build.py).
//
// Each kernel replaces one Pallas TPU kernel of the JAX reference:
//
//   rtt_ge_count_kernel    rechorus_tpu/ops/pallas_kernels.py::ge_count
//                          (_ge_count_kernel)
//   rtt_bucket_max_kernel  rechorus_tpu/ops/pallas_topk.py::fused_bucket_max
//                          (_bucket_max_kernel)
//   rtt_fused_ge_kernel    rechorus_tpu/ops/pallas_topk.py::fused_ge_count
//                          (_ge_count_kernel)
//
// The TPU kernels run their grid in order and carry a count in the output
// block from one catalog step to the next. Here blocks run in parallel and
// in no order: a block loops over its own slice of the catalog, and the
// counts of different blocks meet in int32 atomicAdd, which is exact in
// any order.
//
// All arithmetic is FP32 FMA on the CUDA cores. Counts are `>=` against a
// target score and tie-sensitive, and the exact bucket top-k needs the
// bucket maxima and the rescore to be the same f32 scores, so TF32 tensor
// cores are not used.
//
// Each launcher returns the cudaError_t of cudaGetLastError() after the
// launch (0 = success); empty shapes are the caller's to skip.
// `n_valid < 0` means "no dead rows"; `col_offset` shifts local table rows
// to global item ids for the masks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ------------------------------------------------------------- ge_count --
// Bounded by bytes: it reads the [B, N] f32 score matrix once and does one
// compare per element (at the Grocery eval shape, B=256 x N=8714, that is
// 8.9 MB). The design moves nothing else: each block counts kGeCols
// columns of one row, coalesced, reduces in registers and shared memory,
// and adds one int32 partial into counts[b]. The ragged column edge is
// masked here, so the caller never pads a copy of the scores.
constexpr int kGeCols = 4096;

}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads)
rtt_ge_count_kernel(const float* __restrict__ pred, const float* __restrict__ target,
                    int* __restrict__ counts, int N) {
  const int b = blockIdx.x;
  const float t = target[b];
  const float* row = pred + (int64_t)b * N;
  const int c0 = blockIdx.y * kGeCols;
  const int c1 = min(N, c0 + kGeCols);
  int c = 0;
  for (int j = c0 + threadIdx.x; j < c1; j += kThreads) c += row[j] >= t;
  c = __reduce_add_sync(0xffffffffu, c);
  __shared__ int warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    if (s) atomicAdd(counts + b, s);
  }
}

// ----------------------------------------------- fused score tile (B2, B3) --
// fused_bucket_max and fused_ge_count share one score tile: kTB users x kNB
// consecutive table rows (one "chunk"), s = u . table[row] by FP32 FMA, in
// ascending order over D. Both are bounded by operations: 2*B*N*D FLOP
// against a read of the table (at B=4096, N=1M, D=64: 5.2e11 FLOP over
// 256 MB). The design keeps scores out of device memory entirely: the
// user tile and the chunk are staged through shared memory kDK dims at a
// time, each thread keeps a 4 x 8 block of scores in registers, and only
// the reduction (bucket maxima, or counts) leaves the block.
namespace {

constexpr int kNB = 128;  // table rows per chunk = bucket maxima per block
constexpr int kTB = 64;   // users per block
constexpr int kDK = 32;   // dims staged per shared-memory pass
constexpr int kRows = kTB / 16;  // users per thread: ty + 16 * i
constexpr int kCols = kNB / 16;  // rows per thread:  tx + 16 * j

struct Stage {
  float u[kDK][kTB + 1];  // +1: the transposed stores hit distinct banks
  float t[kDK][kNB + 1];
};

// acc[i][j] = u[b0 + ty + 16 i] . table[r0 + tx + 16 j] (0 past B, N, D).
__device__ __forceinline__ void score_chunk(const float* __restrict__ u,
                                            const float* __restrict__ table, int B, int N,
                                            int D, int b0, int64_t r0, Stage& st,
                                            float (&acc)[kRows][kCols]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kDK) {
    for (int e = threadIdx.x; e < kTB * kDK; e += kThreads) {
      const int r = e / kDK, k = e % kDK;
      const int b = b0 + r, d = k0 + k;
      st.u[k][r] = (b < B && d < D) ? u[(int64_t)b * D + d] : 0.f;
    }
    for (int e = threadIdx.x; e < kNB * kDK; e += kThreads) {
      const int c = e / kDK, k = e % kDK;
      const int64_t row = r0 + c;
      const int d = k0 + k;
      st.t[k][c] = (row < N && d < D) ? table[row * D + d] : 0.f;
    }
    __syncthreads();
    const int kmax = min(kDK, D - k0);
    for (int k = 0; k < kmax; ++k) {
      float a[kRows], bv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = st.u[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bv[j] = st.t[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The id masks of both Pallas kernels: local row < N, global id > 0,
// global id < n_valid.
__device__ __forceinline__ bool row_ok(int64_t lrow, int64_t grow, int N, int n_valid) {
  return lrow < N && grow > 0 && (n_valid < 0 || grow < n_valid);
}

}  // namespace

// Block (j, y) owns catalog block j -- `bucket` chunks of kNB rows -- and
// users [y*kTB, y*kTB + kTB). Bucket l of block j is the strided set
// {j*bucket*kNB + c*kNB + l : c < bucket} (rechorus_tpu/ops/pallas_topk.py:
// 13-22), so the reduction is an elementwise max over the chunks' score
// tiles, kept in registers; the block writes its [kTB, kNB] slice of the
// [B, gridDim.x * kNB] output once. Masked and overhang slots are -inf.
extern "C" __global__ void __launch_bounds__(kThreads)
rtt_bucket_max_kernel(const float* __restrict__ u, const float* __restrict__ table,
                      const float* __restrict__ bias, float* __restrict__ out, int B, int N,
                      int D, int bucket, int n_valid, int col_offset) {
  __shared__ Stage st;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b0 = blockIdx.y * kTB;
  float m[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) m[i][j] = -INFINITY;
  float acc[kRows][kCols];
  for (int c = 0; c < bucket; ++c) {
    const int64_t r0 = ((int64_t)blockIdx.x * bucket + c) * kNB;
    if (r0 >= N) break;  // uniform over the block: the overhang is all -inf
    score_chunk(u, table, B, N, D, b0, r0, st, acc);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int64_t lrow = r0 + tx + 16 * j;
      if (!row_ok(lrow, lrow + col_offset, N, n_valid)) continue;
      const float bj = bias != nullptr ? bias[lrow] : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float s = bias != nullptr ? acc[i][j] + bj : acc[i][j];
        m[i][j] = fmaxf(m[i][j], s);
      }
    }
  }
  const int64_t G = (int64_t)gridDim.x * kNB;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int b = b0 + ty + 16 * i;
    if (b >= B) continue;
    float* o = out + (int64_t)b * G + (int64_t)blockIdx.x * kNB;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[tx + 16 * j] = m[i][j];
  }
}

// Block (j, y) counts, for users [y*kTB, y*kTB + kTB), the rows of chunks
// [j*chunks, j*chunks + chunks) whose score is >= tscore[b] under the id
// masks and != target_col[b]; the 16 threads sharing a user reduce by
// shuffles and one of them adds the partial into counts[b].
extern "C" __global__ void __launch_bounds__(kThreads)
rtt_fused_ge_kernel(const float* __restrict__ u, const float* __restrict__ table,
                    const float* __restrict__ tscore, const int* __restrict__ target_col,
                    const float* __restrict__ bias, int* __restrict__ counts, int B, int N,
                    int D, int chunks, int n_valid, int col_offset) {
  __shared__ Stage st;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b0 = blockIdx.y * kTB;
  float t[kRows];
  int64_t tc[kRows];
  int cnt[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int b = b0 + ty + 16 * i;
    t[i] = b < B ? tscore[b] : INFINITY;
    tc[i] = (b < B && target_col != nullptr) ? (int64_t)target_col[b] : -1;
    cnt[i] = 0;
  }
  float acc[kRows][kCols];
  for (int c = 0; c < chunks; ++c) {
    const int64_t r0 = ((int64_t)blockIdx.x * chunks + c) * kNB;
    if (r0 >= N) break;
    score_chunk(u, table, B, N, D, b0, r0, st, acc);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int64_t lrow = r0 + tx + 16 * j;
      const int64_t grow = lrow + col_offset;
      if (!row_ok(lrow, grow, N, n_valid)) continue;
      const float bj = bias != nullptr ? bias[lrow] : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float s = bias != nullptr ? acc[i][j] + bj : acc[i][j];
        cnt[i] += (s >= t[i]) && grow != tc[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    int v = cnt[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off, 16);
    const int b = b0 + ty + 16 * i;
    if (tx == 0 && b < B && v) atomicAdd(counts + b, v);
  }
}

// ------------------------------------------------------------ launchers --
namespace {
constexpr int kGeChunks = 16;  // fused_ge_count: 16 x 128 = 2048 rows a block
constexpr int kMaxGridY = 65535;

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
}  // namespace

extern "C" int rtt_ge_count(const float* pred, const float* target, int* counts, int B,
                            int N, cudaStream_t stream) {
  if (B <= 0 || N <= 0) return cudaErrorInvalidValue;
  const dim3 grid(B, (unsigned)cdiv(N, kGeCols));
  if (grid.y > kMaxGridY) return cudaErrorInvalidConfiguration;
  rtt_ge_count_kernel<<<grid, kThreads, 0, stream>>>(pred, target, counts, N);
  return cudaGetLastError();
}

extern "C" int rtt_fused_bucket_max(const float* u, const float* table, const float* bias,
                                    float* out, int B, int N, int D, int bucket,
                                    int n_valid, int col_offset, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || D <= 0 || bucket <= 0) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)cdiv(N, (int64_t)bucket * kNB), (unsigned)cdiv(B, kTB));
  if (grid.y > kMaxGridY) return cudaErrorInvalidConfiguration;
  rtt_bucket_max_kernel<<<grid, kThreads, 0, stream>>>(u, table, bias, out, B, N, D, bucket,
                                                       n_valid, col_offset);
  return cudaGetLastError();
}

extern "C" int rtt_fused_ge_count(const float* u, const float* table, const float* tscore,
                                  const int* target_col, const float* bias, int* counts,
                                  int B, int N, int D, int n_valid, int col_offset,
                                  cudaStream_t stream) {
  if (B <= 0 || N <= 0 || D <= 0) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)cdiv(N, (int64_t)kGeChunks * kNB), (unsigned)cdiv(B, kTB));
  if (grid.y > kMaxGridY) return cudaErrorInvalidConfiguration;
  rtt_fused_ge_kernel<<<grid, kThreads, 0, stream>>>(u, table, tscore, target_col, bias,
                                                     counts, B, N, D, kGeChunks, n_valid,
                                                     col_offset);
  return cudaGetLastError();
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
