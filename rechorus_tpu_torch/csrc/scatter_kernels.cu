// Row-commit and optimizer kernels of rechorus_tpu_torch for Hopper
// (sm_90a), bound to Python through csrc/py_launchers.cpp
// (rechorus_tpu_torch/ops/_build.py). The two row commits replace
//
//   rechorus_tpu/ops/pallas_scatter.py::scatter_rows (_scatter_kernel)
//
// and are instances of one template, `walk_rows`, with two epilogues:
//
//   rtt_scatter_rows_kernel  the byte copy: table[rows[i]] = block[i]
//                            (ops/cuda_scatter.py::scatter_rows)
//   rtt_adam_commit_kernel   the lazy-Adam row commit of the sparse lanes:
//                            the Adam update of each touched row, computed
//                            in registers and written to the table by id
//                            (ops/lazy_adam.py::adam_commit)
//
// Both take UNIQUE write ids and drop an id outside [0, N): rows that are
// not named are never read or written, so nothing of the table is copied.
//
// The TPU kernel sends one DMA per row through a DEPTH-8 software
// pipeline, with the ids prefetched into scalar memory, R padded to a
// multiple of the rows per grid step, and the row width held to the
// 128-lane tile. None of that carries over: threads are laid out over the
// flat [R, units_per_row] space, each loads the id of its unit's row and
// handles one unit, so the reads of the row blocks and the accesses inside
// a table row are coalesced. Offsets are 64-bit: N * row_bytes passes 2^31
// at a few million packed rows.
//
// Byte copy. Rows are bytes, so one kernel serves f32 and bf16 at any
// width: 16-byte units where row_bytes % 16 == 0 and both bases are 16-byte
// aligned, else 4-, 2- or 1-byte units. Bounded by bytes: 2 * R_valid *
// row_bytes + 4 * R; for the packed [1M, 192] f32 table at R = 8192 that is
// 12.6 MB, about 3.8 us at 3.35 TB/s.
//
// Adam commit. One launch per table per step takes the place of the Adam
// row math (about 14 elementwise kernels), the concatenation, the id cast
// and one to three byte copies, each of which was a pass of an [R, D] or
// [R, 3D] f32 block through device memory. Two layouts:
//   packed   table [N, 3D] f32 = [p | mu | nu]; the slot's rows come from
//            `gathered` [R, 3D] (the forward pass's gather) and its
//            gradient from g [R, D]; the new [p | mu | nu] row is written
//            at scatter[i];
//   rows     p [N, D] f32 or bf16, mu and nu [N, D] f32; the parameter row
//            comes from vals [R, D] f32, mu and nu are gathered at rows[i]
//            by the kernel, the new rows are written at scatter[i].
// A loser slot (write id out of range) neither reads nor writes. Winners
// read their moments at rows[i] == scatter[i], so with unique winners no
// two threads touch one row. Bounded by bytes: a winner reads 4D floats and
// writes 3D (bf16 p: 2D floats + D halves), plus 8 bytes of id per slot
// (16 in the rows layout). For BPRMF's 1M-item table at R = 8192, D = 64:
// 14.7 MB, about 4.4 us at 3.35 TB/s; 2.2 us for the user table at
// R = 4096. 16-byte units (4 floats) where D % 4 == 0 and the bases are
// aligned (8 bytes for a bf16 p), else one float a thread.
//
// Bit-equal to the eager PyTorch sequence it replaces (lazy_adam._adam_math
// on CUDA tensors). Each operation there is a separately rounded f32
// kernel, so the update below uses __fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn and __fsqrt_rn, which the compiler never contracts into an FMA
// (the build keeps -fmad=true for the other kernels). The Python scalars
// arrive as float32, rounded from double as PyTorch rounds a scalar operand.
// PyTorch's CUDA division by a Python float multiplies by the reciprocal,
// taken in double and rounded to float32 (checked bitwise on the card for
// scalars that float32 does and does not hold exactly), so `m / bc1` and
// `v / bc2` are products with 1 / bc1 and 1 / bc2 as the wrapper computes
// them. A bf16 parameter is rounded by __float2bfloat16_rn, as
// `.to(torch.bfloat16)` rounds on the card.
//
// Dense Adam (rtt_adam_dense_kernel, ops/lazy_adam.py::adam_dense). It
// replaces no TPU kernel: the JAX package's dense Adam is optax's, which
// XLA fuses. On the card DenseOptimizer.update ran it as about ten eager
// elementwise kernels a tensor, each a pass of a full [N, D] f32 tensor
// through device memory, four of them into new temporaries. One launch a
// tensor reads p, g, m and v once and writes p, m and v once: 28 bytes a
// parameter, so bounded by bytes (652.8M parameters of a 10M-item BPRMF:
// 18.3 GB, 5.46 ms at 3.35 TB/s). A flat grid-stride walk whose grid
// covers the tensor, one unit a thread; 16-byte units (4 floats) where the
// length is a multiple of 4 and all four bases are 16-byte aligned, else
// one float a thread (LayerNorm vectors, [3]-wide tables, odd lengths).
//
// Bit-equal to the eager sequence it replaces (lazy_adam.adam_dense_plain
// on CUDA tensors), up to the sign of a zero. Its rounding differs from
// the commit's above: PyTorch's CUDA kernels for `add(x, alpha=a)` and
// `addcmul(x, y, value=a)` compute x + a * y and x + a * (y * z) in one
// kernel, which nvcc contracts into a fused multiply-add, so those steps
// are __fmaf_rn here; every other step is one separately rounded eager
// kernel. Hence a lane of its own and not `adam_lane`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // grid-stride beyond this

unsigned grid_for(int64_t total_units) {
  int64_t blocks = (total_units + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

__device__ __forceinline__ int64_t ldg_id(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

// The row walk both epilogues share: thread `idx` handles unit idx % upr
// of slot idx / upr.
template <class Epilogue>
__device__ __forceinline__ void walk_rows(const Epilogue& epi, int64_t upr, int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x; idx < total; idx += stride) {
    const int64_t i = idx / upr;
    epi(i, idx - i * upr, idx);
  }
}

// ---------------------------------------------------------------- byte copy
template <typename T>
struct CopyRow {
  T* table;
  const int* rows;
  const T* block;
  int64_t N, upr;

  __device__ __forceinline__ void operator()(int64_t i, int64_t c, int64_t idx) const {
    const int64_t r = __ldg(rows + i);
    if (r >= 0 && r < N) table[r * upr + c] = __ldg(block + idx);
  }
};

// --------------------------------------------------------------- Adam commit
struct AdamScalars {
  float b1, c1, b2, c2, lr, eps, decay, inv_bc1, inv_bc2;
  int has_decay;
};

// _adam_math for one lane, operation by operation:
//   g  = g + decay * p                      (only when decay != 0)
//   m2 = b1 * m + (1 - b1) * g
//   v2 = b2 * v + ((1 - b2) * g) * g
//   p2 = p - lr * (m2 * inv_bc1) / (sqrt(v2 * inv_bc2) + eps)
__device__ __forceinline__ void adam_lane(const AdamScalars& s, float p, float g, float m,
                                          float v, float& p2, float& m2, float& v2) {
  if (s.has_decay) g = __fadd_rn(g, __fmul_rn(s.decay, p));
  m2 = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.c1, g));
  v2 = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.c2, g), g));
  const float num = __fmul_rn(s.lr, __fmul_rn(m2, s.inv_bc1));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v2, s.inv_bc2)), s.eps);
  p2 = __fsub_rn(p, __fdiv_rn(num, den));
}

// V floats a unit: 4 (16-byte accesses) or 1. `ldg` is for inputs the
// kernel never writes; the moments of the rows layout live in the table
// the kernel writes, so they take a plain load.
template <int V>
__device__ __forceinline__ void ldg(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

template <int V>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(x[0]);
  }
}

template <int V>
__device__ __forceinline__ void adam_unit(const AdamScalars& s, const float (&p)[V],
                                          const float (&g)[V], const float (&m)[V],
                                          const float (&v)[V], float (&p2)[V], float (&m2)[V],
                                          float (&v2)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) adam_lane(s, p[k], g[k], m[k], v[k], p2[k], m2[k], v2[k]);
}

template <int V>
struct AdamPacked {
  float* table;           // [N, 3D]
  const float* gathered;  // [R, 3D]
  const float* g;         // [R, D]
  const int64_t* scatter;
  int64_t N, D, upr;
  AdamScalars s;

  __device__ __forceinline__ void operator()(int64_t i, int64_t c, int64_t) const {
    const int64_t w = ldg_id(scatter + i);
    if (w < 0 || w >= N) return;
    const int64_t off = c * V;
    const float* src = gathered + i * 3 * D + off;
    float p[V], gr[V], m[V], v[V], p2[V], m2[V], v2[V];
    ldg<V>(p, src);
    ldg<V>(m, src + D);
    ldg<V>(v, src + 2 * D);
    ldg<V>(gr, g + i * D + off);
    adam_unit<V>(s, p, gr, m, v, p2, m2, v2);
    float* dst = table + w * 3 * D + off;
    store<V>(dst, p2);
    store<V>(dst + D, m2);
    store<V>(dst + 2 * D, v2);
  }
};

template <int V, typename PT>
struct AdamRows {
  PT* p;              // [N, D]
  float* m;           // [N, D]
  float* v;           // [N, D]
  const float* vals;  // [R, D]
  const float* g;     // [R, D]
  const int64_t* rows;
  const int64_t* scatter;
  int64_t N, D, upr;
  AdamScalars s;

  __device__ __forceinline__ void operator()(int64_t i, int64_t c, int64_t) const {
    const int64_t w = ldg_id(scatter + i);
    if (w < 0 || w >= N) return;
    const int64_t r = ldg_id(rows + i);
    if (r < 0 || r >= N) return;
    const int64_t off = c * V;
    float pr[V], gr[V], mr[V], vr[V], p2[V], m2[V], v2[V];
    ldg<V>(pr, vals + i * D + off);
    ldg<V>(gr, g + i * D + off);
    load<V>(mr, m + r * D + off);
    load<V>(vr, v + r * D + off);
    adam_unit<V>(s, pr, gr, mr, vr, p2, m2, v2);
    store<V>(p + w * D + off, p2);
    store<V>(m + w * D + off, m2);
    store<V>(v + w * D + off, v2);
  }
};

// ---------------------------------------------------------------- dense Adam
// l2 is added to the gradient (Adam's l2) and wd to the step (AdamW's
// decoupled term), 0 for none: with a finite p, fma(0, p, x) is x, up to
// the sign of a zero. scale multiplies the step's lr (a per-group lr) only
// when has_scale is set, since p - (step * lr) * scale rounds otherwise
// than fma(-lr, step, p).
struct DenseAdamScalars {
  float b1, c1, b2, c2, lr, eps, inv_bc1, inv_bc2, l2, wd, scale;
  int has_scale;
};

// DenseOptimizer.update's Adam for one element, eager op by eager op:
//   g = g.add(p, alpha=l2)                      fma(l2, p, g)
//   m.mul_(b1).add_(g, alpha=1 - b1)            fma(c1, g, m * b1)
//   v.mul_(b2).addcmul_(g, g, value=1 - b2)     fma(c2, g * g, v * b2)
//   step = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
//   step.add_(p, alpha=wd)                      fma(wd, p, step)
//   p.sub_(step, alpha=lr)                      fma(-lr, step, p)
//   or p.sub_(step * lr * scale)                p - (step * lr) * scale
__device__ __forceinline__ void dense_adam_lane(const DenseAdamScalars& s, float& p, float g,
                                                float& m, float& v) {
  g = __fmaf_rn(s.l2, p, g);
  m = __fmaf_rn(s.c1, g, __fmul_rn(m, s.b1));
  v = __fmaf_rn(s.c2, __fmul_rn(g, g), __fmul_rn(v, s.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_bc2)), s.eps);
  float step = __fdiv_rn(__fmul_rn(m, s.inv_bc1), den);
  step = __fmaf_rn(s.wd, p, step);
  p = s.has_scale ? __fsub_rn(p, __fmul_rn(__fmul_rn(step, s.lr), s.scale))
                  : __fmaf_rn(-s.lr, step, p);
}
}  // namespace

template <typename T>
__global__ void __launch_bounds__(kThreads)
rtt_scatter_rows_kernel(CopyRow<T> epi, int64_t total) {
  walk_rows(epi, epi.upr, total);
}

template <class Epilogue>
__global__ void __launch_bounds__(kThreads)
rtt_adam_commit_kernel(Epilogue epi, int64_t total) {
  walk_rows(epi, epi.upr, total);
}

// V floats a unit over `units` units; g is only read.
template <int V>
__global__ void __launch_bounds__(kThreads)
rtt_adam_dense_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
                      float* __restrict__ v, int64_t units, DenseAdamScalars s) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t u = (int64_t)blockIdx.x * kThreads + threadIdx.x; u < units; u += stride) {
    const int64_t off = u * V;
    float pr[V], gr[V], mr[V], vr[V];
    load<V>(pr, p + off);
    ldg<V>(gr, g + off);
    load<V>(mr, m + off);
    load<V>(vr, v + off);
#pragma unroll
    for (int k = 0; k < V; ++k) dense_adam_lane(s, pr[k], gr[k], mr[k], vr[k]);
    store<V>(p + off, pr);
    store<V>(m + off, mr);
    store<V>(v + off, vr);
  }
}

namespace {
template <typename T>
int launch_scatter(void* table, const int* rows, const void* block, int64_t N, int64_t R,
                   int64_t row_bytes, cudaStream_t stream) {
  const int64_t upr = row_bytes / (int64_t)sizeof(T);
  const CopyRow<T> epi{(T*)table, rows, (const T*)block, N, upr};
  rtt_scatter_rows_kernel<T><<<grid_for(R * upr), kThreads, 0, stream>>>(epi, R * upr);
  return cudaGetLastError();
}

template <class Epilogue>
int launch_adam(const Epilogue& epi, int64_t R, cudaStream_t stream) {
  const int64_t total = R * epi.upr;
  rtt_adam_commit_kernel<Epilogue><<<grid_for(total), kThreads, 0, stream>>>(epi, total);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) { return (uintptr_t)p % bytes == 0; }

// The dense walk's grid: a unit a thread. On an H100 at [10M, 64] this
// takes 5.87 ms; a grid of only as many blocks as the card holds at once,
// each looping over its share, took 6.25.
template <int V>
int launch_dense(float* p, const float* g, float* m, float* v, int64_t units,
                 const DenseAdamScalars& s, cudaStream_t stream) {
  constexpr int64_t kMaxGrid = 2147483647;  // the grid's x limit; the walk strides past it
  const int64_t blocks = (units + kThreads - 1) / kThreads;
  rtt_adam_dense_kernel<V><<<(unsigned)(blocks < kMaxGrid ? blocks : kMaxGrid), kThreads, 0,
                             stream>>>(p, g, m, v, units, s);
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

extern "C" int rtt_adam_commit_packed(float* table, const float* gathered, const float* g,
                                      const int64_t* scatter, int64_t N, int64_t R, int64_t D,
                                      float b1, float c1, float b2, float c2, float lr, float eps,
                                      float decay, int has_decay, float inv_bc1, float inv_bc2,
                                      cudaStream_t stream) {
  if (N <= 0 || R <= 0 || D <= 0) return cudaErrorInvalidValue;
  const AdamScalars s{b1, c1, b2, c2, lr, eps, decay, inv_bc1, inv_bc2, has_decay};
  if (D % 4 == 0 && aligned(table, 16) && aligned(gathered, 16) && aligned(g, 16))
    return launch_adam(AdamPacked<4>{table, gathered, g, scatter, N, D, D / 4, s}, R, stream);
  return launch_adam(AdamPacked<1>{table, gathered, g, scatter, N, D, D, s}, R, stream);
}

extern "C" int rtt_adam_commit_rows(void* p, int p_is_bf16, float* m, float* v, const float* vals,
                                    const float* g, const int64_t* rows, const int64_t* scatter,
                                    int64_t N, int64_t R, int64_t D, float b1, float c1, float b2,
                                    float c2, float lr, float eps, float decay, int has_decay,
                                    float inv_bc1, float inv_bc2, cudaStream_t stream) {
  if (N <= 0 || R <= 0 || D <= 0) return cudaErrorInvalidValue;
  const AdamScalars s{b1, c1, b2, c2, lr, eps, decay, inv_bc1, inv_bc2, has_decay};
  const bool vec = D % 4 == 0 && aligned(p, p_is_bf16 ? 8 : 16) && aligned(m, 16) &&
                   aligned(v, 16) && aligned(vals, 16) && aligned(g, 16);
  if (p_is_bf16) {
    using B = __nv_bfloat16;
    if (vec)
      return launch_adam(AdamRows<4, B>{(B*)p, m, v, vals, g, rows, scatter, N, D, D / 4, s},
                         R, stream);
    return launch_adam(AdamRows<1, B>{(B*)p, m, v, vals, g, rows, scatter, N, D, D, s}, R, stream);
  }
  if (vec)
    return launch_adam(AdamRows<4, float>{(float*)p, m, v, vals, g, rows, scatter, N, D, D / 4, s},
                       R, stream);
  return launch_adam(AdamRows<1, float>{(float*)p, m, v, vals, g, rows, scatter, N, D, D, s}, R,
                     stream);
}

extern "C" int rtt_adam_dense(float* p, const float* g, float* m, float* v, int64_t n, float b1,
                              float c1, float b2, float c2, float lr, float eps, float inv_bc1,
                              float inv_bc2, float l2, float wd, float scale, int has_scale,
                              cudaStream_t stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const DenseAdamScalars s{b1, c1, b2, c2, lr, eps, inv_bc1, inv_bc2, l2, wd, scale, has_scale};
  if (n % 4 == 0 && aligned(p, 16) && aligned(g, 16) && aligned(m, 16) && aligned(v, 16))
    return launch_dense<4>(p, g, m, v, n / 4, s, stream);
  return launch_dense<1>(p, g, m, v, n, s, stream);
}
