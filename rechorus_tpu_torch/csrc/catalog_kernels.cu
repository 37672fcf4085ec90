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

// Per chunk: cnt[i] += #{j: score + bias >= t[i]} over the rows that pass
// the id masks and are not user i's target. Targets are rare (128 ids a
// block over the whole catalog), so the id compare runs only in a thread
// one of whose users has its target inside this chunk.
struct GeCount {
  int N, n_valid, col_offset;
  const Lane& ln;
  const float* st;  // this thread's users' target scores (+inf past B) and, behind them at
  const int* stc;   // kTB, their targets' LOCAL rows (-1: none), in shared memory
  int (&cnt)[8];
  __device__ __forceinline__ void operator()(int64_t r0, const float (&acc)[8][8],
                                             const float* sbias) {
    const ChunkRows rows(r0, sbias, ln, N, n_valid, col_offset);
    const int r0i = (int)r0;  // a chunk starts below N
    const float4 t0 = *reinterpret_cast<const float4*>(st);
    const float4 t1 = *reinterpret_cast<const float4*>(st + 16);
    const int4 c0 = *reinterpret_cast<const int4*>(stc);
    const int4 c1 = *reinterpret_cast<const int4*>(stc + 16);
    const float t[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
    int tc[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    bool any = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      tc[i] -= r0i;  // the target's row within this chunk, if in [0, kNB)
      any |= (unsigned)tc[i] < (unsigned)kNB;
    }
    if (sbias != nullptr) {
      if (any) count<true, true>(rows, acc, t, tc); else count<true, false>(rows, acc, t, tc);
    } else {
      if (any) count<false, true>(rows, acc, t, tc); else count<false, false>(rows, acc, t, tc);
    }
  }
  template <bool kBias, bool kTarget>
  __device__ __forceinline__ void count(const ChunkRows& rows, const float (&acc)[8][8],
                                        const float (&t)[8], const int (&tc)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!rows.ok[j]) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float s = kBias ? acc[i][j] + rows.bias[j] : acc[i][j];
        cnt[i] += (s >= t[i]) && !(kTarget && ln.row(j) == tc[i]);
      }
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

// Block (x, y) counts, for users [x*kTB, x*kTB + kTB), the rows of catalog
// blocks y, y + gridDim.y, ... (`chunks` chunks each) whose score is >=
// tscore[b] under the id masks and != target_col[b]. A thread keeps 8
// counts; the 8 lanes that share its users reduce by shuffles and one of
// them adds the partial into counts[b] (the tile's two row halves add one
// partial each). Target scores and rows wait in shared memory between
// chunks, which keeps a thread of the D == 64 instance within 128
// registers without a spill: two blocks an SM.
template <int kD>
__global__ void __launch_bounds__(kThreads, kD == 64 ? 2 : 1)
rtt_fused_ge_kernel(const float* __restrict__ u, const float* __restrict__ table,
                    const float* __restrict__ tscore, const int* __restrict__ target_col,
                    const float* __restrict__ bias, int* __restrict__ counts, int B, int N,
                    int D, int chunks, int n_valid, int col_offset, int64_t n_blocks,
                    bool resident) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Lane ln;
  const int b0 = blockIdx.x * kTB;
  if (resident) load_user_tile(smem, u, B, D, b0);
  __shared__ __align__(16) float s_t[kTB];
  __shared__ __align__(16) int s_tc[kTB];
  if (threadIdx.x < kTB) {
    const int b = b0 + threadIdx.x;
    s_t[threadIdx.x] = b < B ? tscore[b] : INFINITY;
    const int64_t local =
        (b < B && target_col != nullptr) ? (int64_t)target_col[b] - col_offset : -1;
    s_tc[threadIdx.x] = (local >= 0 && local < N) ? (int)local : -1;
  }  // score_chunks starts with a __syncthreads
  int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  GeCount epilogue{N, n_valid, col_offset, ln, s_t + ln.usr0, s_tc + ln.usr0, cnt};
  for (int64_t jb = blockIdx.y; jb < n_blocks; jb += gridDim.y)
    score_chunks<kD>(u, table, bias, B, N, D, b0, jb * chunks, chunks, smem, resident, ln,
                     epilogue);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int v = cnt[i];
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int b = b0 + ln.user(i);
    if (ln.row_leader && b < B && v) atomicAdd(counts + b, v);
  }
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

extern "C" int rtt_fused_ge_count(const float* u, const float* table, const float* tscore,
                                  const int* target_col, const float* bias, int* counts,
                                  int B, int N, int D, int n_valid, int col_offset,
                                  cudaStream_t stream) {
  if (B <= 0 || N <= 0 || D <= 0) return cudaErrorInvalidValue;
  const int64_t n_blocks = cdiv(N, (int64_t)kGeChunks * kNB);
  const FusedSmem sm(D);
  auto kernel = D == 64 ? rtt_fused_ge_kernel<64> : rtt_fused_ge_kernel<0>;
  return launch_fused(kernel, B, n_blocks, sm.bytes, stream, u, table, tscore, target_col, bias,
                      counts, B, N, D, kGeChunks, n_valid, col_offset, n_blocks, sm.resident);
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
