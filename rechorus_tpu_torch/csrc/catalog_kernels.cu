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
// and one more replaces an XLA primitive of the TPU, not a Pallas kernel:
//
//   rtt_approx_bin_max_kernel  jax.lax.approx_max_k's PartialReduce
//                          (rechorus_tpu/ops/topk.py:338, ops/metrics.py:273)
//
// B3's body also counts for a multi-interest model, over the max of its K
// interest scores, which has no TPU counterpart (the JAX package ranks such
// a model through its forward over candidate chunks); at K > 1 it launches
// under its own name:
//
//   rtt_interest_ge_kernel B3's count over a max of K interest scores
//
// and two replace steps of the exact top-k that XLA ran on the TPU:
//
//   rtt_bucket_select_kernel   its two-level select of the top buckets, a
//                          max, two top-k and a gather
//                          (rechorus_tpu/ops/topk.py:165)
//   rtt_bucket_rescore_kernel  its rescore of the selected buckets, a
//                          gather and an einsum (rechorus_tpu/ops/topk.py:227)
//
// The TPU kernels run their grid in order and carry a count in the output
// block from one catalog step to the next. Here blocks run in parallel and
// in no order: a block loops over its own slice of the catalog, and the
// counts of different blocks meet in int32 atomicAdd, which is exact in
// any order.
//
// All arithmetic is FP32 FMA on the CUDA cores, summed in ascending order
// over D per (user, row). Counts are `>=` against a target score and
// tie-sensitive, and the exact bucket top-k needs the bucket maxima and the
// rescore to be the same f32 scores, so TF32 tensor cores are not used.
//
// Each launcher returns the cudaError_t of cudaGetLastError() after the
// launch (0 = success); empty shapes are the caller's to skip.
// `n_valid < 0` means "no dead rows"; `col_offset` shifts local table rows
// to global item ids for the masks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

// ------------------------------------------------------- approx bin max --
// The first stage of the approximate top-k (Chern et al. 2022, "TPU-KNN",
// arXiv 2206.14286): the reduction axis of length N is split into L
// strided bins, column j into bin j mod L, and each bin keeps its maximum
// and that column's index; an exact top-k over the L maxima follows in the
// caller. Ties go to the lowest column (strict >, columns visited upwards);
// a bin of -inf columns stays -inf with its first column.
// Bounded by bytes: it reads the [B, N] f32 input once and writes [B, L]
// maxima and int32 indices, one compare per element. Thread l of a row
// walks bin l; at each step the threads of a warp read 32 adjacent columns
// (the strided bins make the loads coalesce), and the loads of one thread
// do not depend on its running maximum, so the unrolled loop keeps several
// in flight. Rows are the grid's y axis, looped past the grid's limit.
extern "C" __global__ void __launch_bounds__(kThreads)
rtt_approx_bin_max_kernel(const float* __restrict__ x, float* __restrict__ vals,
                          int* __restrict__ idx, int B, int N, int L) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float* row = x + (int64_t)b * N;
    float best = row[l];
    int arg = l;
#pragma unroll 4
    for (int j = l + L; j < N; j += L) {
      const float v = row[j];
      if (v > best) {
        best = v;
        arg = j;
      }
    }
    vals[(int64_t)b * L + l] = best;
    idx[(int64_t)b * L + l] = arg;
  }
}

// ----------------------------------------------- fused score tile (B2, B3) --
// fused_bucket_max and fused_ge_count share one score tile: kTB users x kNB
// consecutive table rows (one "chunk"), s = u . table[row] by FP32 FMA, in
// ascending order over D. Both are bounded by operations: 2*B*N*D FLOP
// against a read of the table (at B=4096, N=1M, D=64: 5.2e11 FLOP over
// 256 MB), and the FP32 peak needs an FFMA in every dispatch slot of the SM's
// four schedulers. Scores never reach device memory; only the reduction
// (bucket maxima, or counts) leaves the block. What the design does to keep
// the FMA pipe fed:
//
//   * The user tile (128 users) is copied into shared memory once and stays
//     there for the block's whole life; only table chunks stream through.
//   * Tiles lie dim-major in shared memory (line k holds dim k of the 128
//     users or rows), so each thread reads its 8 users and 8 rows of one dim
//     with four 128-bit loads and does 64 FMAs on them: an 8 x 8 register
//     tile, 4 loads per 64 FMAs. A warp is 8 threads along the rows by 4
//     along the users, so every load of a warp touches one 128-byte line
//     segment without a bank conflict.
//   * The transposition happens in the copy: 4-byte cp.async, 8 consecutive
//     dims of 4 consecutive rows per warp request (four full 32-byte
//     sectors), into lines padded to kLd = 132 floats so the 32 writes fall
//     into 32 banks. Being 4 bytes wide it takes any D and any alignment.
//   * Chunk c+1 is copied while chunk c is computed, in a ring of two
//     stages with one __syncthreads per stage; a 64-dim chunk is 4096 FMAs
//     a thread, far longer than a copy from L2 or device memory takes.
//   * User tiles are the fast grid axis: the blocks that run together share
//     a few catalog blocks, so a table row comes from device memory once
//     and from L2 for every other user tile.
//   * D == 64 is a template instance with a constant trip count; any other
//     D takes the same code with run-time bounds. D above one stage (kDS
//     dims) is summed over several stages per chunk; when the user tile at
//     that D no longer fits beside the ring, its slab travels with the
//     table's in every stage instead.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, [4096] x [1M, 64]: 11.5-12.2
// ms against the 7.9 ms bound (the kernels before this design: 31-33 ms).
// Throwaway variants that switch one cost off at a time (timed in turns with
// tools/compare_catalog_kernels.py) put the gap at about 1.8 ms in the FFMA
// stream itself (a quarter of the FFMAs fetch two registers from one
// register bank: the compiler's allocation), 1.2 ms in the 4-byte copies,
// 0.8 ms in the shared loads and 0.7 ms in the barrier per chunk. Tried and
// dropped: a row-major tile filled by 16-byte copies (32 more operand
// registers: 13.0 / 14.6 ms), copies started one by one between the FMAs, a
// third stage, other unroll depths, and two half-blocks behind named
// barriers (all within 2% of this).
namespace {

constexpr int kNB = 128;     // table rows per chunk = bucket maxima per block
constexpr int kTB = 128;     // users per block
constexpr int kDS = 64;      // dims per ring stage
constexpr int kLd = kNB + 4; // floats per dim-major line; +4: conflict-free transposing writes
constexpr int kStages = 2;   // the ring: one stage is computed on while the other is refilled
constexpr int kUnroll = 16;  // dims per unrolled pass of the D == 64 instance
constexpr int kTileFloats = kDS * kLd;
// dynamic shared memory budget: the 227 KB a block may use on sm_90, less
// the counting kernel's 1 KB of static shared memory
constexpr int kMaxSmemBytes = 232448 - 1024;
static_assert(kNB == kTB, "fill_tile and the thread layout assume square tiles");

__device__ __forceinline__ void cp_async4(float* smem_dst, const float* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}
// The same, but when !valid nothing is read and the 4 bytes become 0.
__device__ __forceinline__ void cp_async4_or_zero(float* smem_dst, const float* src, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
// 16 bytes, both addresses 16-byte aligned; through L2 only.
__device__ __forceinline__ void cp_async16(float* smem_dst, const float* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// This thread's 8 users and 8 rows within the 128 x 128 score tile.
struct Lane {
  int row0, usr0;  // rows row0 + {0..3} and row0 + 32 + {0..3}; users usr0 + {0..3}, + 16 + {0..3}
  bool row_leader;  // first of the 8 lanes that share this thread's users
  __device__ Lane() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    row0 = (warp & 1) * 64 + (lane & 7) * 4;
    usr0 = (warp >> 1) * 32 + (lane >> 3) * 4;
    row_leader = (lane & 7) == 0;
  }
  __device__ __forceinline__ int row(int j) const { return row0 + (j >> 2) * 32 + (j & 3); }
  __device__ __forceinline__ int user(int i) const { return usr0 + (i >> 2) * 16 + (i & 3); }
};

// Start the copy of dims [d0, d0 + kw) of rows [r0, r0 + 128) of the
// row-major [n_rows, D] matrix `src` into the dim-major tile `dst`
// (dst[k * kLd + r]); rows past n_rows become 0. Warp w copies dims
// 8w .. 8w+7, four rows per request; a thread's 32 copies differ by
// constants (kD != 0) or a multiple of the row stride, one instruction
// each, and only a tile that overhangs n_rows pays for a test per copy.
template <int kD>
__device__ __forceinline__ void fill_tile(float* dst, const float* __restrict__ src, int64_t r0,
                                          int64_t n_rows, int D_arg, int d0, int kw) {
  const int D = kD ? kD : D_arg;
  const int lane = threadIdx.x & 31;
  const int k = (threadIdx.x >> 5) * 8 + (lane & 7);
  if (k >= kw) return;
  const int r = lane >> 3;
  float* d = dst + k * kLd + r;
  const float* s = src + (r0 + r) * D + d0 + k;
  if (r0 + kNB <= n_rows) {  // uniform over the block
#pragma unroll
    for (int it = 0; it < kNB / 4; ++it) cp_async4(d + 4 * it, s + (int64_t)(4 * it) * D);
  } else {
    const int rows_left = (int)(n_rows - r0) - r;  // n_rows - r0 is in [1, kNB)
#pragma unroll 8
    for (int it = 0; it < kNB / 4; ++it) {
      const bool ok = 4 * it < rows_left;
      cp_async4_or_zero(d + 4 * it, ok ? s + (int64_t)(4 * it) * D : src, ok);
    }
  }
}

// acc[i][j] += users' dim k * rows' dim k, for one dim-major line of each.
__device__ __forceinline__ void fma_line(const float* __restrict__ us,
                                         const float* __restrict__ ts, float (&acc)[8][8]) {
  const float4 a0 = *reinterpret_cast<const float4*>(us);
  const float4 a1 = *reinterpret_cast<const float4*>(us + 16);
  const float4 b0 = *reinterpret_cast<const float4*>(ts);
  const float4 b1 = *reinterpret_cast<const float4*>(ts + 32);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// Scores of users [b0, b0 + 128) against chunks [chunk0, chunk0 + chunks)
// (those that start below N). After the last dim of each chunk
// `epilogue(r0, acc, biases)` gets acc[i][j] = u[b0 + user(i)] . table[r0 + row(j)]
// (anything past B or N: masked by the caller) and the chunk's 128 biases
// in shared memory (copied with the chunk's last slab; null without a
// bias). `smem` holds the resident user tile (D lines, already being
// copied) followed by the ring; a stage is the table's slab, the users'
// slab when !resident, and the bias line.
template <int kD, class Epilogue>
__device__ __forceinline__ void score_chunks(const float* __restrict__ u,
                                             const float* __restrict__ table,
                                             const float* __restrict__ bias, int B, int N,
                                             int D_arg, int b0, int64_t chunk0, int chunks,
                                             float* smem, bool resident, const Lane& ln,
                                             Epilogue& epilogue) {
  const int D = kD ? kD : D_arg;
  const int slabs = (D + kDS - 1) / kDS;
  const int64_t chunks_left = (N - chunk0 * kNB + kNB - 1) / kNB;
  if (chunks_left < chunks) chunks = chunks_left < 0 ? 0 : (int)chunks_left;
  const int steps = chunks * slabs;
  float* ring = smem + (resident ? D * kLd : 0);
  const int bias_at = resident ? kTileFloats : 2 * kTileFloats;
  const int stage_floats = bias_at + kNB;

  // Start the copies of step t into its stage, as one group.
  auto start_copies = [&](int t) {
    if (t < steps) {
      const int c = t / slabs, d0 = (t - c * slabs) * kDS;
      const int kw = min(kDS, D - d0);
      float* st = ring + (t & 1) * stage_floats;
      const int64_t r0 = (chunk0 + c) * kNB;
      fill_tile<kD>(st, table, r0, N, D, d0, kw);
      if (!resident) fill_tile<kD>(st + kTileFloats, u, b0, B, D, d0, kw);
      if (bias != nullptr && d0 + kDS >= D && threadIdx.x >= kThreads - kNB) {
        const int r = threadIdx.x - (kThreads - kNB);
        const bool ok = r0 + r < N;
        cp_async4_or_zero(st + bias_at + r, ok ? bias + r0 + r : bias, ok);
      }
    }
    cp_async_commit();
  };

  __syncthreads();  // every thread is done reading the ring of an earlier call
  start_copies(0);
  float acc[8][8];
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<0>();  // this thread's copies of step t (and of the user tile) landed
    __syncthreads();     // everyone's did, and everyone left the other stage (step t-1's)
    start_copies(t + 1);  // refill that stage while this one is computed on
    const int c = t / slabs, slab = t - c * slabs;
    if (slab == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float* st = ring + (t & 1) * stage_floats;
    const float* ts = st + ln.row0;
    const float* us = (resident ? smem + slab * kTileFloats : st + kTileFloats) + ln.usr0;
    if constexpr (kD != 0 && kD <= kDS) {
#pragma unroll kUnroll
      for (int k = 0; k < kD; ++k) fma_line(us + k * kLd, ts + k * kLd, acc);
    } else {
      const int kw = min(kDS, D - slab * kDS);
#pragma unroll 4
      for (int k = 0; k < kw; ++k) fma_line(us + k * kLd, ts + k * kLd, acc);
    }
    if (slab == slabs - 1)
      epilogue((chunk0 + c) * kNB, acc, bias != nullptr ? st + bias_at + ln.row0 : nullptr);
  }
}

// Start the copy of the resident user tile: D dim-major lines at `smem`.
__device__ __forceinline__ void load_user_tile(float* smem, const float* __restrict__ u, int B,
                                               int D, int b0) {
  for (int d0 = 0; d0 < D; d0 += kDS)
    fill_tile<0>(smem + d0 * kLd, u, b0, B, D, d0, min(kDS, D - d0));
  cp_async_commit();
}

// The id masks of both Pallas kernels: local row < N, global id > 0,
// global id < n_valid.
__device__ __forceinline__ bool row_ok(int64_t lrow, int64_t grow, int N, int n_valid) {
  return lrow < N && grow > 0 && (n_valid < 0 || grow < n_valid);
}

// What both epilogues read once per chunk and row, not per user: which of
// this thread's 8 rows pass the id masks (all of them, without a test per
// row, in a chunk that lies inside the live catalog), and their biases.
struct ChunkRows {
  bool ok[8];
  float bias[8];
  __device__ __forceinline__ ChunkRows(int64_t r0, const float* sbias, const Lane& ln, int N,
                                       int n_valid, int col_offset) {
    const int64_t g0 = r0 + col_offset;
    const bool all_ok = r0 + kNB <= N && g0 > 0 && (n_valid < 0 || g0 + kNB <= n_valid);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      ok[j] = all_ok || row_ok(r0 + ln.row(j), g0 + ln.row(j), N, n_valid);
    float4 b0 = make_float4(0.f, 0.f, 0.f, 0.f), b1 = b0;
    if (sbias != nullptr) {
      b0 = *reinterpret_cast<const float4*>(sbias);
      b1 = *reinterpret_cast<const float4*>(sbias + 32);
    }
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) bias[j] = b[j];
  }
};

// Per chunk: m[i][j] = max(m[i][j], score + bias) over the rows that pass
// the id masks.
struct BucketMax {
  int N, n_valid, col_offset;
  const Lane& ln;
  float (&m)[8][8];
  __device__ __forceinline__ void operator()(int64_t r0, const float (&acc)[8][8],
                                             const float* sbias) {
    const ChunkRows rows(r0, sbias, ln, N, n_valid, col_offset);
    if (sbias != nullptr) reduce<true>(rows, acc); else reduce<false>(rows, acc);
  }
  template <bool kBias>
  __device__ __forceinline__ void reduce(const ChunkRows& rows, const float (&acc)[8][8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!rows.ok[j]) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        m[i][j] = fmaxf(m[i][j], kBias ? acc[i][j] + rows.bias[j] : acc[i][j]);
    }
  }
};

}  // namespace

// Block (x, y) owns users [x*kTB, x*kTB + kTB) and catalog blocks y, y +
// gridDim.y, ... -- each `bucket` chunks of kNB rows. Bucket l of block j is
// the strided set {j*bucket*kNB + c*kNB + l : c < bucket} (rechorus_tpu/ops/
// pallas_topk.py:13-22), so the reduction is an elementwise max over the
// chunks' score tiles, kept in registers beside the 64 accumulators (one
// block of 256 threads an SM, up to 255 registers a thread); the block
// writes its [kTB, kNB] slice of the [B, n_blocks * kNB] output once per
// catalog block, 128 bits a store. Masked and overhang slots are -inf.
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
rtt_bucket_max_kernel(const float* __restrict__ u, const float* __restrict__ table,
                      const float* __restrict__ bias, float* __restrict__ out, int B, int N,
                      int D, int bucket, int n_valid, int col_offset, int64_t n_blocks,
                      bool resident) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Lane ln;
  const int b0 = blockIdx.x * kTB;
  if (resident) load_user_tile(smem, u, B, D, b0);
  const int64_t G = n_blocks * kNB;
  const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int64_t jb = blockIdx.y; jb < n_blocks; jb += gridDim.y) {
    float m[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) m[i][j] = -INFINITY;
    BucketMax epilogue{N, n_valid, col_offset, ln, m};
    score_chunks<kD>(u, table, bias, B, N, D, b0, jb * bucket, bucket, smem, resident, ln,
                     epilogue);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = b0 + ln.user(i);
      if (b >= B) continue;
      float* o = out + (int64_t)b * G + jb * kNB + ln.row0;
      if (vec_out) {
        *reinterpret_cast<float4*>(o) = make_float4(m[i][0], m[i][1], m[i][2], m[i][3]);
        *reinterpret_cast<float4*>(o + 32) = make_float4(m[i][4], m[i][5], m[i][6], m[i][7]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) o[(j >> 2) * 32 + (j & 3)] = m[i][j];
      }
    }
  }
}

// ------------------------------------------------- rank count (B3, D9) --
// B3 counts, for each user, the catalog rows whose score is >= the target's
// score. A multi-interest model (ComiRec) scores item j for user b as
// max_k u[b, k] . table[j] (+ bias[j]), and #{j : max_k s_kj >= t} is no
// function of the K counts, so the max is taken in the epilogue, before the
// compare: the user tile holds 128 / K users' K interest rows, laid out so
// that one thread's 8 rows (Lane::user) are the K interests of 8 / K users
// and the max is taken in registers. With K in {1, 2, 4} the rows are
// user-major (row b * K + k), and i = g*K .. g*K + K-1 are the aligned rows
// usr0 + {0..3} or usr0 + 16 + {0..3}; with K = 8 the caller lays each 16
// users' 128 rows out so that user (usr0 >> 5) * 4 + ((usr0 >> 2) & 3) of
// the block owns a thread's rows (ops/cuda_topk.py, `interest_rows`). The
// bias is per row, so max_k (s_k + bias) = max_k s_k + bias exactly
// (rounding is monotone). At K = 1 there is no max: B3's count.
namespace {

// The index among the block's 128 / K users of the user whose K interest
// rows are this thread's rows g*K .. g*K + K-1 (of 8 / K such users).
template <int kK>
__device__ __forceinline__ int interest_slot(const Lane& ln, int g) {
  return kK == 8 ? (ln.usr0 >> 5) * 4 + ((ln.usr0 >> 2) & 3) : ln.user(g * kK) / kK;
}

// Per chunk: cnt[g] += #{j: max_k score + bias >= t[g]} over the rows that
// pass the id masks and are not user g's target. Targets are rare (128 ids
// a block over the whole catalog), so the id compare runs only in a thread
// one of whose users has its target inside this chunk.
template <int kK>
struct InterestGeCount {
  static constexpr int kG = 8 / kK;  // users a thread
  int N, n_valid, col_offset;
  const Lane& ln;
  const float* st;  // the block's users' target scores (+inf past B) and their
  const int* stc;   // targets' LOCAL rows (-1: none), in shared memory
  int (&cnt)[kG];
  __device__ __forceinline__ void operator()(int64_t r0, const float (&acc)[8][8],
                                             const float* sbias) {
    const ChunkRows rows(r0, sbias, ln, N, n_valid, col_offset);
    const int r0i = (int)r0;  // a chunk starts below N
    float t[kG];
    int tc[kG];
    bool any = false;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      // the target's row within this chunk, if in [0, kNB)
      t[g] = st[interest_slot<kK>(ln, g)];
      tc[g] = stc[interest_slot<kK>(ln, g)] - r0i;
      any |= (unsigned)tc[g] < (unsigned)kNB;
    }
    if (sbias != nullptr) {
      if (any) count<true, true>(rows, acc, t, tc); else count<true, false>(rows, acc, t, tc);
    } else {
      if (any) count<false, true>(rows, acc, t, tc); else count<false, false>(rows, acc, t, tc);
    }
  }
  template <bool kBias, bool kTarget>
  __device__ __forceinline__ void count(const ChunkRows& rows, const float (&acc)[8][8],
                                        const float (&t)[kG], const int (&tc)[kG]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!rows.ok[j]) continue;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float m = acc[g * kK][j];
#pragma unroll
        for (int k = 1; k < kK; ++k) m = fmaxf(m, acc[g * kK + k][j]);
        const float s = kBias ? m + rows.bias[j] : m;
        cnt[g] += (s >= t[g]) && !(kTarget && ln.row(j) == tc[g]);
      }
    }
  }
};

// Block (x, y) counts, for users [x*(kTB/kK), (x+1)*(kTB/kK)), whose K
// interest rows are rows [x*kTB, x*kTB + kTB) of u, the rows of catalog
// blocks y, y + gridDim.y, ... (`chunks` chunks each) whose (max-over-K)
// score is >= tscore[b] under the id masks and != target_col[b]. A thread
// keeps 8 / K counts; the 8 lanes that share its users reduce by shuffles
// and one of them adds the partial into counts[b] (the tile's two row
// halves add one partial each). Target scores and rows wait in shared
// memory between chunks, which keeps a thread of the D == 64 instance
// within 128 registers: two blocks an SM.
template <int kD, int kK>
__device__ __forceinline__ void ge_count_body(const float* __restrict__ u,
                                              const float* __restrict__ table,
                                              const float* __restrict__ tscore,
                                              const int* __restrict__ target_col,
                                              const float* __restrict__ bias,
                                              int* __restrict__ counts, int B, int rows, int N,
                                              int D, int chunks, int n_valid, int col_offset,
                                              int64_t n_blocks, bool resident) {
  constexpr int kUB = kTB / kK;  // users a block
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Lane ln;
  const int b0 = blockIdx.x * kTB;  // the block's first row of u
  const int ub0 = blockIdx.x * kUB;  // and its first user
  if (resident) load_user_tile(smem, u, rows, D, b0);
  __shared__ __align__(16) float s_t[kUB];
  __shared__ __align__(16) int s_tc[kUB];
  if (threadIdx.x < kUB) {
    const int b = ub0 + threadIdx.x;
    s_t[threadIdx.x] = b < B ? tscore[b] : INFINITY;
    const int64_t local =
        (b < B && target_col != nullptr) ? (int64_t)target_col[b] - col_offset : -1;
    s_tc[threadIdx.x] = (local >= 0 && local < N) ? (int)local : -1;
  }  // score_chunks starts with a __syncthreads
  int cnt[InterestGeCount<kK>::kG] = {};
  InterestGeCount<kK> epilogue{N, n_valid, col_offset, ln, s_t, s_tc, cnt};
  for (int64_t jb = blockIdx.y; jb < n_blocks; jb += gridDim.y)
    score_chunks<kD>(u, table, bias, rows, N, D, b0, jb * chunks, chunks, smem, resident, ln,
                     epilogue);
#pragma unroll
  for (int g = 0; g < InterestGeCount<kK>::kG; ++g) {
    int v = cnt[g];
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int b = ub0 + interest_slot<kK>(ln, g);
    if (ln.row_leader && b < B && v) atomicAdd(counts + b, v);
  }
}

}  // namespace

// One body, two entry names: the benchmark reads B3 and D9 by their
// kernels' names in the trace, so K = 1 launches as rtt_fused_ge_kernel
// and K in {2, 4, 8} as rtt_interest_ge_kernel.
#define RTT_GE_COUNT_PARAMS                                                                    \
  const float *__restrict__ u, const float *__restrict__ table,                                \
      const float *__restrict__ tscore, const int *__restrict__ target_col,                    \
      const float *__restrict__ bias, int *__restrict__ counts, int B, int rows, int N, int D, \
      int chunks, int n_valid, int col_offset, int64_t n_blocks, bool resident
#define RTT_GE_COUNT_ARGS \
  u, table, tscore, target_col, bias, counts, B, rows, N, D, chunks, n_valid, col_offset, n_blocks, resident

template <int kD>
__global__ void __launch_bounds__(kThreads, kD == 64 ? 2 : 1)
rtt_fused_ge_kernel(RTT_GE_COUNT_PARAMS) {
  ge_count_body<kD, 1>(RTT_GE_COUNT_ARGS);
}

template <int kD, int kK>
__global__ void __launch_bounds__(kThreads, kD == 64 ? 2 : 1)
rtt_interest_ge_kernel(RTT_GE_COUNT_PARAMS) {
  ge_count_body<kD, kK>(RTT_GE_COUNT_ARGS);
}
#undef RTT_GE_COUNT_PARAMS
#undef RTT_GE_COUNT_ARGS

// ---------------------------------------------- grouped bucket rescore (D6) --
// Step 3 of the exact hierarchical top-k (ops/topk.py::tiled_catalog_topk):
// each of a user's kk selected buckets scored again item by item, from the
// grouped copy [Gp, bucket, D] in which a bucket's rows are one contiguous
// slice (ops/topk.py::group_table_for_rescore). The JAX package gathers the
// slices into a [B, kk, bucket, D] array and rescores it with an einsum
// (rechorus_tpu/ops/topk.py:227); no Pallas kernel.
//
// Bounded by bytes: at the serve shape (4096 users x 132 buckets of 16 rows
// of D = 64) it reads 2.21 GB of slices, one FMA a float, and writes 104
// MB of scores and ids. What the design does about it:
//
//   * A block takes `slots` consecutive slices of the flattened [B, kk]
//     selection (8 at bucket 16: 128 rows, one a thread) and copies them
//     whole into shared memory, 16-byte cp.async where D and the bases
//     allow (a warp request is 512 contiguous bytes), else 4-byte. Nothing
//     of [B, kk, bucket, D] reaches device memory.
//   * No ring: six such blocks fit on an SM (35 KB of shared memory each),
//     so while one scores, the others' copies are in flight, ~190 KB an SM
//     where 3.35 TB/s at ~1 us of latency needs ~25 KB.
//   * A thread scores its row in B2's order: one accumulator, fmaf over d
//     from 0 up, then + bias. So every score equals bit for bit the one B2
//     took its bucket maximum over. Rows lie Dp floats apart in shared
//     memory, Dp = 4 mod 32 for 16-byte loads and odd for 4-byte ones, so
//     the rows that one load instruction's phase reads fall in distinct
//     banks.
//   * K <= 8 interest rows of a multi-interest user are K accumulators
//     over the same loaded row, the score their fmaxf + bias (rounding is
//     monotone: the max over k of B2's per-row scores). The user's rows
//     come from device memory through L1; a slice's threads read the same
//     address.
//   * A slot scores -inf past N (the last bucket's overhang), at a global
//     id <= 0 or >= n_valid, and in a pad slot (bucket maximum -inf); its
//     id is the local row, N - 1 where it lies out of range.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W at the serve shape: 0.78-0.79
// ms against the 0.69 ms bound (the gather and cuBLAS's batched GEMV it
// replaced: 3.9 ms). A persistent grid of as many blocks as the card holds,
// each walking the groups, took the same time to 0.2%; at K = 4 the user's
// rows read through L1 take it to 1.20 ms.
namespace {
constexpr int kRescoreThreads = 128;           // rows scored at once, one a thread
constexpr int kRescoreSmemBytes = 48 * 1024;   // a block's slices: six blocks an SM at D = 64
constexpr int kMaxInterests = 8;
}  // namespace

template <int kD, int kVec>
__global__ void __launch_bounds__(kRescoreThreads, 6)
rtt_bucket_rescore_kernel(const float* __restrict__ u, const float* __restrict__ grouped,
                          const int64_t* __restrict__ gb, const float* __restrict__ gv,
                          const float* __restrict__ bias, float* __restrict__ cs,
                          int64_t* __restrict__ cand, int n_slices, int kk, int K, int D_arg,
                          int bucket, int Gp, int N, int n_valid, int col_offset, int slots,
                          int Dp) {
  const int D = kD ? kD : D_arg;
  extern __shared__ float4 smem4[];
  float* rows_sm = reinterpret_cast<float*>(smem4);
  int64_t* src = reinterpret_cast<int64_t*>(rows_sm + ((slots * bucket * Dp + 3) & ~3));
  const int s0 = blockIdx.x * slots;
  const int rows = min(slots, n_slices - s0) * bucket;
  // each row's place in the grouped copy: row c of slice gb[s], clamped
  for (int r = threadIdx.x; r < rows; r += kRescoreThreads) {
    const int q = r / bucket;
    const int64_t g = gb[s0 + q];
    const int64_t gc = g < 0 ? 0 : (g < Gp ? g : Gp - 1);
    src[r] = (gc * bucket + (r - q * bucket)) * D;
  }
  __syncthreads();
  const int units = D / kVec;                          // copies a row
  const int lanes = min(units, kRescoreThreads);       // threads a row
  const int r_step = kRescoreThreads / lanes;
  if ((int)threadIdx.x < lanes * r_step) {
    for (int r = threadIdx.x / lanes; r < rows; r += r_step)
      for (int c = threadIdx.x % lanes; c < units; c += lanes) {
        float* dst = rows_sm + r * Dp + c * kVec;
        const float* from = grouped + src[r] + c * kVec;
        if (kVec == 4) cp_async16(dst, from); else cp_async4(dst, from);
      }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int r = threadIdx.x; r < rows; r += kRescoreThreads) {
    const int q = r / bucket, c = r - q * bucket, s = s0 + q;
    const int64_t g = gb[s];
    const int64_t item = (g / kNB) * bucket * kNB + g % kNB + (int64_t)c * kNB;
    const bool live = gv[s] != -INFINITY && item < N;
    const int row = live ? (int)item : N - 1;
    const int64_t gid = (int64_t)row + col_offset;
    float score = -INFINITY;
    if (live && gid > 0 && (n_valid < 0 || gid < n_valid)) {
      const float* x = rows_sm + r * Dp;
      const float* ub = u + (int64_t)(s / kk) * K * D;
      float acc[kMaxInterests];
#pragma unroll
      for (int k = 0; k < kMaxInterests; ++k) acc[k] = 0.f;
      if (kVec == 4) {
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          const float4 t = *reinterpret_cast<const float4*>(x + d);
#pragma unroll
          for (int k = 0; k < kMaxInterests; ++k) {
            if (k >= K) break;
            const float4 a = __ldg(reinterpret_cast<const float4*>(ub + k * D + d));
            acc[k] = fmaf(a.x, t.x, acc[k]);
            acc[k] = fmaf(a.y, t.y, acc[k]);
            acc[k] = fmaf(a.z, t.z, acc[k]);
            acc[k] = fmaf(a.w, t.w, acc[k]);
          }
        }
      } else {
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const float t = x[d];
#pragma unroll
          for (int k = 0; k < kMaxInterests; ++k) {
            if (k >= K) break;
            acc[k] = fmaf(__ldg(ub + k * D + d), t, acc[k]);
          }
        }
      }
      float m = acc[0];
#pragma unroll
      for (int k = 1; k < kMaxInterests; ++k)
        if (k < K) m = fmaxf(m, acc[k]);
      score = bias != nullptr ? m + bias[row] : m;
    }
    cs[(int64_t)s0 * bucket + r] = score;
    cand[(int64_t)s0 * bucket + r] = row;
  }
}

// ------------------------------------------------- exact bucket select (D11) --
// Step 2 of the exact hierarchical top-k: each row's kk largest bucket
// maxima of B2's [B, G] output, by the contiguous two-level select of
// rechorus_tpu/ops/topk.py::two_level_bucket_select (a max over super-
// buckets of F columns, a top-kk of those, a gather of the winners' F
// members and a top-kk of them; XLA ran it, no Pallas kernel). Exact: every
// column at or above the kk-th largest value v* lies in a super whose
// maximum is >= v*, and at most kk supers hold one.
//
// Bounded by bytes: at the serve shape (4096 x 62,592, F 16, kk 132) it
// reads the 1.03 GB of bucket maxima once (0.31 ms at 3.35 TB/s) and
// writes 6.5 MB. What the design does about it:
//
//   * One block a row. It reads the row once with 16-byte loads, F / 4
//     neighbouring threads a super, kSelectLoads loads a thread in flight
//     before any is used, and keeps only the ceil(G / F) super maxima, in
//     shared memory (15.6 KB at the serve shape), so several blocks an SM
//     stream while others select.
//   * Values become 32-bit keys whose unsigned order is the float order
//     (-inf above nothing but an absent slot, key 0), so a maximum is an
//     integer max and the kk-th largest is a radix select: four passes of
//     an 8-bit histogram in shared memory, 4 keys a thread a step, a
//     thread's run of equal digits added at once.
//   * The kk supers above that key, then the first of its ties in index
//     order, are taken by a block-wide scan of 4 keys a thread, so the
//     result is the same on every run; their kk * F members (2,112 at the
//     serve shape) are read again, through L2 mostly, and selected the same
//     way.
//   * A row writes kk values, each bm at its id bit for bit, and int64 ids
//     in [0, G): first those above the kk-th value, then its ties, each in
//     the order of the supers taken. A row with fewer than kk finite
//     maxima fills with -inf buckets.
// The keys take up to 224 KB of shared memory: a 10M-item catalog's
// 39,064 super maxima take 157 KB, and such rows run one block an SM. The
// launcher refuses a shape past that or not read in 16-byte loads
// (ops/cuda_topk.py::bucket_select_fits).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W at the serve shape: 0.442-
// 0.447 ms against the 0.31 ms bound, 32 registers, no spill (the two
// top-k passes it replaced: 2.70; torch.topk over the rows: 3.22). The
// read alone takes 0.329, as long as torch's max over the same rows; a
// first version that took one key a thread a step in the select, with a
// ballot scan, took 0.48-0.50: its select did not hide behind the reads.
namespace {
constexpr int kSelectThreads = 256;        // = the histogram's bins: one a thread in the scan
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kSelectLoads = 4;            // 16-byte loads a thread in flight
constexpr int kSelectBlocks = 8;           // blocks an SM: 32 registers a thread, 2,048 threads
// keys and supers: up to the 227 KB a block may use on sm_90, less the
// static scratch (the serve shape takes 15.6 KB, and 8 blocks an SM)
constexpr int kSelectSmemBytes = 224 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

__device__ __forceinline__ unsigned key_max(float4 v) {
  return max(max(order_key(v.x), order_key(v.y)), max(order_key(v.z), order_key(v.w)));
}

// Scratch of the block-wide steps, in static shared memory.
struct SelectScratch {
  int hist[kSelectThreads];
  int warp_sums[kSelectWarps];
  int digit, remaining;
};

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// The k-th largest of keys[0, n) (1 <= k <= n; n a multiple of 4, read 4
// keys a thread at a time), and in *need how many of the keys equal to it
// are among the k largest. Every thread returns both.
__device__ unsigned block_kth_key(const unsigned* keys, int n, int k, SelectScratch& sc,
                                  int* need) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint4* keys4 = reinterpret_cast<const uint4*>(keys);
  unsigned prefix = 0, mask = 0;
  int remaining = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    sc.hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < n / 4; i += kSelectThreads) {
      const uint4 q = keys4[i];
      const unsigned kv[4] = {q.x, q.y, q.z, q.w};
      unsigned run = 256u;  // a run of equal digits is added at once
      int count = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((kv[j] & mask) != prefix) continue;
        const unsigned digit = (kv[j] >> shift) & 255u;
        if (digit != run) {
          if (count) atomicAdd(sc.hist + run, count);
          run = digit;
          count = 0;
        }
        ++count;
      }
      if (count) atomicAdd(sc.hist + run, count);
    }
    __syncthreads();
    // thread t holds digit 255 - t: an inclusive scan over threads is the
    // count of keys (under the prefix) whose digit is at or above its own
    const int d = kSelectThreads - 1 - tid;
    const int h = sc.hist[d];
    int incl = h;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) sc.warp_sums[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += sc.warp_sums[w];
    if (incl - h < remaining && remaining <= incl) {
      sc.digit = d;
      sc.remaining = remaining - (incl - h);
    }
    __syncthreads();
    prefix |= (unsigned)sc.digit << shift;
    mask |= 255u << shift;
    remaining = sc.remaining;
  }
  *need = remaining;
  return prefix;
}

// take(slot, i, key) for each i of keys[0, n) (n a multiple of 4) whose
// key is above kth, at slots [0, k - need) in index order, and for the
// first `need` keys equal to kth, at slots [k - need, k). One scan over
// the block a step of 4 keys a thread, the count above kth in the low 16
// bits and the count equal to it in the high 16.
template <class Take>
__device__ void block_take_top(const unsigned* keys, int n, unsigned kth, int need, int k,
                               SelectScratch& sc, const Take& take) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint4* keys4 = reinterpret_cast<const uint4*>(keys);
  int base_gt = 0, base_eq = 0;
  for (int i0 = 0; i0 < n; i0 += 4 * kSelectThreads) {
    const int i = i0 + 4 * tid;
    const uint4 q = i < n ? keys4[i / 4] : make_uint4(0u, 0u, 0u, 0u);
    const unsigned kv[4] = {q.x, q.y, q.z, q.w};
    int v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) v += (kv[j] > kth) + ((kv[j] == kth) << 16);
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += x;
    }
    if (lane == 31) sc.warp_sums[warp] = incl;
    __syncthreads();
    int before = incl - v, total = 0;
#pragma unroll
    for (int w = 0; w < kSelectWarps; ++w) {
      const int s = sc.warp_sums[w];
      if (w < warp) before += s;
      total += s;
    }
    int og = base_gt + (before & 0xffff), oe = base_eq + (before >> 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kv[j] > kth) {
        take(og++, i + j, kv[j]);
      } else if (kv[j] == kth) {
        if (oe < need) take(k - need + oe, i + j, kv[j]);
        ++oe;
      }
    }
    base_gt += total & 0xffff;
    base_eq += total >> 16;
    __syncthreads();
    if (base_gt == k - need && base_eq >= need) break;
  }
}
}  // namespace

// bm [B, G] (one block a row, 16-byte aligned, G % 4 == 0); gv [B, kk],
// gb [B, kk]; F % 4 == 0 and F / 4 divides 32.
__global__ void __launch_bounds__(kSelectThreads, kSelectBlocks)
rtt_bucket_select_kernel(const float* __restrict__ bm, float* __restrict__ gv,
                         int64_t* __restrict__ gb, int G, int F, int kk) {
  extern __shared__ uint4 select_smem[];
  __shared__ SelectScratch sc;
  const int tid = threadIdx.x;
  const int S = (G + F - 1) / F, C = kk * F;
  unsigned* keys = reinterpret_cast<unsigned*>(select_smem);  // max(S, C) keys, padded to 4
  int* supers = reinterpret_cast<int*>(keys + round4(max(S, C)));  // kk super ids
  const float* row = bm + (int64_t)blockIdx.x * G;
  const float4* row4 = reinterpret_cast<const float4*>(row);
  const int n4 = G / 4;
  const int L = F / 4, lg = __ffs(L) - 1;  // threads a super, a power of two

  // 1. the super maxima, as keys (key 0 in the pad)
  for (int q0 = 0; q0 < n4; q0 += kSelectThreads * kSelectLoads) {
    unsigned m[kSelectLoads];
#pragma unroll
    for (int j = 0; j < kSelectLoads; ++j) {
      const int q = q0 + j * kSelectThreads + tid;
      m[j] = q < n4 ? key_max(__ldg(row4 + q)) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kSelectLoads; ++j) {
      for (int off = 1; off < L; off <<= 1) m[j] = max(m[j], __shfl_xor_sync(kFull, m[j], off));
      const int q = q0 + j * kSelectThreads + tid;
      if (q < n4 && (q & (L - 1)) == 0) keys[q >> lg] = m[j];
    }
  }
  if (tid < round4(S) - S) keys[S + tid] = 0u;
  __syncthreads();

  // 2. the kk supers of the largest maxima
  int need;
  const unsigned kth_super = block_kth_key(keys, round4(S), kk, sc, &need);
  block_take_top(keys, round4(S), kth_super, need, kk, sc,
                 [&](int slot, int s, unsigned) { supers[slot] = s; });
  __syncthreads();

  // 3. their members, candidate c = member c % F of supers[c / F] (key 0
  // past G and in the pad), and the kk largest of those
  for (int i = tid; i < kk * L; i += kSelectThreads) {
    const int q = (supers[i >> lg] << lg) + (i & (L - 1));
    uint4 k4 = make_uint4(0u, 0u, 0u, 0u);
    if (q < n4) {
      const float4 v = __ldg(row4 + q);
      k4 = make_uint4(order_key(v.x), order_key(v.y), order_key(v.z), order_key(v.w));
    }
    select_smem[i] = k4;
  }
  if (tid < round4(C) - C) keys[C + tid] = 0u;
  __syncthreads();
  const unsigned kth = block_kth_key(keys, round4(C), kk, sc, &need);
  float* v_out = gv + (int64_t)blockIdx.x * kk;
  int64_t* id_out = gb + (int64_t)blockIdx.x * kk;
  block_take_top(keys, round4(C), kth, need, kk, sc, [&](int slot, int c, unsigned key) {
    v_out[slot] = key_value(key);
    id_out[slot] = (int64_t)supers[c / F] * F + c % F;
  });
}

// ------------------------------------------------------------ launchers --
namespace {
constexpr int kGeChunks = 16;  // fused_ge_count: 16 x 128 = 2048 rows a catalog block
constexpr int kMaxGridY = 65535;

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Shared memory of one block of the fused kernels at width D, and whether
// the user tile stays resident beside the ring (it does up to D = 308).
struct FusedSmem {
  bool resident;
  int bytes;
  explicit FusedSmem(int D) {
    const int64_t bias_lines = (int64_t)kStages * kNB * sizeof(float);
    const int64_t ring = (int64_t)kStages * kTileFloats * sizeof(float);
    const int64_t with_tile = (int64_t)D * kLd * sizeof(float) + ring + bias_lines;
    resident = with_tile <= kMaxSmemBytes;
    bytes = (int)(resident ? with_tile : 2 * ring + bias_lines);
  }
};

// Raise the kernel's dynamic shared memory limit (per device, so on every
// launch) and launch it on (user tiles, catalog blocks).
template <class Kernel, class... Args>
int launch_fused(Kernel kernel, int B, int64_t n_blocks, int smem_bytes, cudaStream_t stream,
                 Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)cdiv(B, kTB), (unsigned)(n_blocks < kMaxGridY ? n_blocks : kMaxGridY));
  kernel<<<grid, kThreads, smem_bytes, stream>>>(args...);
  return cudaGetLastError();
}
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
  const int64_t n_blocks = cdiv(N, (int64_t)bucket * kNB);
  const FusedSmem sm(D);
  auto kernel = D == 64 ? rtt_bucket_max_kernel<64> : rtt_bucket_max_kernel<0>;
  return launch_fused(kernel, B, n_blocks, sm.bytes, stream, u, table, bias, out, B, N, D,
                      bucket, n_valid, col_offset, n_blocks, sm.resident);
}

// u holds `rows` interest rows of B users, K a user (K in {1, 2, 4, 8}),
// laid out as the count reads them: rows == B * K for K <= 4, rows == 128 *
// ceil(B / 16) for K == 8. K == 1 is B3: one row a user.
extern "C" int rtt_fused_ge_count(const float* u, const float* table, const float* tscore,
                                  const int* target_col, const float* bias, int* counts, int B,
                                  int K, int rows, int N, int D, int n_valid, int col_offset,
                                  cudaStream_t stream) {
  if (B <= 0 || N <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (rows != (K == 8 ? (int)cdiv(B, kTB / 8) * kTB : B * K)) return cudaErrorInvalidValue;
  const int64_t n_blocks = cdiv(N, (int64_t)kGeChunks * kNB);
  const FusedSmem sm(D);
  decltype(&rtt_fused_ge_kernel<64>) kernel;
  switch (K) {
    case 1: kernel = D == 64 ? rtt_fused_ge_kernel<64> : rtt_fused_ge_kernel<0>; break;
    case 2: kernel = D == 64 ? rtt_interest_ge_kernel<64, 2> : rtt_interest_ge_kernel<0, 2>; break;
    case 4: kernel = D == 64 ? rtt_interest_ge_kernel<64, 4> : rtt_interest_ge_kernel<0, 4>; break;
    case 8: kernel = D == 64 ? rtt_interest_ge_kernel<64, 8> : rtt_interest_ge_kernel<0, 8>; break;
    default: return cudaErrorInvalidValue;
  }
  return launch_fused(kernel, rows, n_blocks, sm.bytes, stream, u, table, tscore, target_col,
                      bias, counts, B, rows, N, D, kGeChunks, n_valid, col_offset, n_blocks,
                      sm.resident);
}

// u holds K rows a user (K <= 8); grouped is [Gp, bucket, D]; gb, gv are
// the [B, kk] selected buckets and their maxima; cs, cand the [B, kk *
// bucket] scores and local ids. B * kk * bucket must fit in an int.
extern "C" int rtt_bucket_rescore(const float* u, const float* grouped, const int64_t* gb,
                                  const float* gv, const float* bias, float* cs, int64_t* cand,
                                  int B, int K, int kk, int Gp, int bucket, int D, int N,
                                  int n_valid, int col_offset, cudaStream_t stream) {
  if (B <= 0 || kk <= 0 || K <= 0 || K > kMaxInterests || Gp <= 0 || bucket <= 0 || D <= 0 ||
      N <= 0 || (int64_t)B * kk * bucket > 0x7fffffff)
    return cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(u) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(grouped) & 15) == 0;
  const int Dp = vec ? D + (36 - D % 32) % 32 : (D | 1);  // 4 mod 32, or odd
  const int64_t slice_bytes = (int64_t)bucket * (Dp * sizeof(float) + sizeof(int64_t)) + 16;
  const int slots = (int)std::max<int64_t>(
      1, std::min<int64_t>(kRescoreThreads / bucket, kRescoreSmemBytes / slice_bytes));
  const int64_t rows = (int64_t)slots * bucket;
  const int64_t smem = ((rows * Dp + 3) & ~3) * (int64_t)sizeof(float) + rows * sizeof(int64_t);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = !vec ? rtt_bucket_rescore_kernel<0, 1>
                     : D == 64 ? rtt_bucket_rescore_kernel<64, 4> : rtt_bucket_rescore_kernel<0, 4>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int n_slices = B * kk;
  kernel<<<(unsigned)cdiv(n_slices, slots), kRescoreThreads, smem, stream>>>(
      u, grouped, gb, gv, bias, cs, cand, n_slices, kk, K, D, bucket, Gp, N, n_valid, col_offset,
      slots, Dp);
  return cudaGetLastError();
}

// bm [B, G] float32 bucket maxima; gv [B, kk] float32, gb [B, kk] int64
// out. Takes 16-byte aligned bm with G % 4 == 0, F % 4 == 0 with F / 4
// dividing 32, kk <= ceil(G / F), and keys that fit kSelectSmemBytes:
// 4 * (max(ceil(G / F), kk * F), rounded up to 4, + kk) bytes.
extern "C" int rtt_bucket_select(const float* bm, float* gv, int64_t* gb, int B, int G, int F,
                                 int kk, cudaStream_t stream) {
  if (B <= 0 || G <= 0 || F <= 0 || kk <= 0 || G % 4 != 0 || F % 4 != 0 || 32 % (F / 4) != 0 ||
      (reinterpret_cast<uintptr_t>(bm) & 15) != 0)
    return cudaErrorInvalidValue;
  const int64_t S = cdiv(G, F);
  const int64_t smem = 4 * ((std::max<int64_t>(S, (int64_t)kk * F) + 3) / 4 * 4 + kk);
  if (kk > S || smem > kSelectSmemBytes) return cudaErrorInvalidValue;
  // per device, so on every launch (as launch_fused)
  const cudaError_t err = cudaFuncSetAttribute(
      rtt_bucket_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  rtt_bucket_select_kernel<<<(unsigned)B, kSelectThreads, (int)smem, stream>>>(bm, gv, gb, G, F,
                                                                              kk);
  return cudaGetLastError();
}

extern "C" int rtt_approx_bin_max(const float* x, float* vals, int* idx, int B, int N, int L,
                                  cudaStream_t stream) {
  if (B <= 0 || N <= 0 || L <= 0 || L > N) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)cdiv(L, kThreads), (unsigned)(B < kMaxGridY ? B : kMaxGridY));
  rtt_approx_bin_max_kernel<<<grid, kThreads, 0, stream>>>(x, vals, idx, B, N, L);
  return cudaGetLastError();
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
