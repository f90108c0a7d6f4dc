// Online softmax over the rows of x [R, V]: the paper's Algorithm 3, and its
// normalizer alone.
//
// Replaces: src/repro/kernels/online_softmax.py, online_softmax_pallas (the
//   pallas_calls at line 66, _normalizer_kernel:31, and 77,
//   _normalize_kernel:48) and online_normalizer_pallas (line 99); and the
//   reduced-precision forms that the reference ran in XLA
//   (src/repro/kernels/dispatch.py:514 bf16, :520 exp2; their arithmetic is
//   src/repro/core/softmax_forms.py:_online_md, :63).
// Bound on the H100: bytes.  The normalizer reads each element once.  The
//   softmax reads it and writes y: 2 accesses per element where the row fits
//   on chip, 3 where it streams (Algorithm 3's two sweeps; safe softmax
//   takes 4).  Per element the work is a max, two exps and an add, far below
//   the FLOP rate, so the kernels are written to keep HBM busy: 16-byte
//   loads and stores, several in flight per thread.
//
// Two designs, chosen by the wrapper's planner from V and the dtype (a pure
// function, kernels/online_softmax.py:plan; no probe, no option):
//   * row-resident (rows_kernel), for rows of at most RESIDENT_ROW_BYTES
//     (224 KB, about what one CTA's shared memory holds): a row group holds
//     one row, one warp a row (8 rows a CTA) for rows of at most 8 KB, else
//     one CTA of 64..512 threads (about 16 vectors a thread) a row.  The
//     softmax copies the row once into shared memory with 16-byte cp.async
//     copies, computes (m, d), then writes y from the copy on chip: x is
//     read once and y written once.  The normalizer reads its row straight
//     from HBM;
//   * streaming, for longer rows: a grid of (R rows, S slices of 8192
//     16-byte vectors, 128 KB) of 512 threads; sweep one (md_slice_kernel) writes
//     each slice's (m, d), the normalizer ⊕-merges the S partials with one
//     warp a row (md_merge_kernel), and the softmax's sweep two
//     (normalize_kernel) merges them in each block (S values from L2), then
//     re-reads its slice and writes y.
// In both, a thread runs its own online recurrence (Alg. 3 lines 4-5) in
//   fp32 over batches of 4 vectors it loads together, so 4 16-byte loads
//   are in flight per thread; its (m, d) is one leaf of a ⊕-tree: the
//   warp's 32 lanes (5 shuffle levels), the CTA's warps (log2 of their
//   count), and, streaming, the row's slices (one warp: ceil(S / 32) - 1
//   lane steps, then ceil(log2 min(S, 32)) levels).  y = exp(x - m) * (1/d),
//   the reciprocal taken once per row in IEEE fp32: one more rounding than
//   an IEEE divide, inside every form's bound (the card's checks hold each
//   entry within it).
// Alignment: rows start wherever x does (V need not be a multiple of 4 or
//   8, and x may start off a 16-byte boundary).  A row splits into a scalar
//   head up to the first 16-byte boundary, a body of whole 16-byte vectors
//   and a scalar tail; threads 0..7 of the row group load the head and the
//   tail as scalars.  Nothing past the row is read.  The wrapper allocates y
//   at x's offset modulo 16 bytes, so the same split serves both.
// Forms (template policies): exact (expf, d in fp32; no fast math), exp2
//   (exp2f of the product z * log2e rounded to fp32) and bf16 (expf; a
//   leaf's fp32 sum rounded once to bf16, and every merge's rescale,
//   product and sum rounded to bf16).
// Dead entries (-inf) contribute exactly 0, and the rescale of a -inf
//   running max is pinned to 1: a row whose leading entries or whole extent
//   are -inf gives (m, d) = (max, d) or (-inf, 0) and y = 0 there, as
//   core.online_softmax does (not the Pallas kernel's NaN).
#include "common.cuh"

namespace {

constexpr int kLoads = 4;              // 16-byte loads a thread batches
constexpr int kStreamThreads = 512;    // streaming blocks
constexpr int kMaxRowThreads = 512;    // row-resident CTAs
constexpr int kWarpThreads = 256;      // CTAs of the one-warp-a-row design
constexpr float kLog2e = 1.4426950408889634f;

enum : int { kFormExact = 0, kFormBF16 = 1, kFormExp2 = 2 };
enum : int { kDesignWarp = 0, kDesignBlock = 1, kDesignStream = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct FormExact {
  __device__ __forceinline__ static float exp(float z) { return expf(z); }
  __device__ __forceinline__ static float leaf(float d) { return d; }
  __device__ __forceinline__ static void combine(float& m, float& d, float om,
                                                 float od) {
    md_combine(m, d, om, od);
  }
};

struct FormExp2 {
  // the product rounded to fp32 first, as softmax_forms._exp2_fn
  __device__ __forceinline__ static float exp(float z) {
    return exp2f(__fmul_rn(z, kLog2e));
  }
  __device__ __forceinline__ static float leaf(float d) { return d; }
  __device__ __forceinline__ static void combine(float& m, float& d, float om,
                                                 float od) {
    const float mn = fmaxf(m, om);
    const float a = m == mn ? 1.f : exp(m - mn);
    const float b = om == mn ? 1.f : exp(om - mn);
    d = __fadd_rn(__fmul_rn(d, a), __fmul_rn(od, b));
    m = mn;
  }
};

struct FormBF16 {
  __device__ __forceinline__ static float exp(float z) { return expf(z); }
  // a leaf's fp32 sum enters the tree rounded to bf16
  __device__ __forceinline__ static float leaf(float d) {
    return bf16_round(d);
  }
  // d is bf16-valued: each side's rescale cast, product, and the sum round
  __device__ __forceinline__ static void combine(float& m, float& d, float om,
                                                 float od) {
    const float mn = fmaxf(m, om);
    const float a = m == mn ? 1.f : expf(m - mn);
    const float b = om == mn ? 1.f : expf(om - mn);
    d = bf16_round(bf16_round(d * bf16_round(a)) +
                   bf16_round(od * bf16_round(b)));
    m = mn;
  }
};

// ---- 16-byte vectors -------------------------------------------------------
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw,
                                         float (&v)[kVec<T>]) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  } else {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);          // low bf16
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[kVec<T>]) {
  unpack16<T>(*reinterpret_cast<const uint4*>(p), v);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&v)[kVec<T>]) {
  uint4 raw;
  if constexpr (sizeof(T) == 4) {
    raw = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                     __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&b);
    }
    raw = make_uint4(w[0], w[1], w[2], w[3]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

// A row of V entries starting at `row`: `head` scalars up to the first
// 16-byte boundary, `nv` whole vectors from row + head, then `tail` scalars.
struct Split {
  int head, nv, tail;
};

template <typename T>
__device__ __forceinline__ Split split_row(const T* row, int V) {
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15) /
                  static_cast<int>(sizeof(T));
  const int head = min(off == 0 ? 0 : kVec<T> - off, V);
  const int nv = (V - head) / kVec<T>;
  return {head, nv, V - head - nv * kVec<T>};
}

// The head and tail scalars this thread owns (thread t < 8 of its group
// holds head entry t and tail entry t, when they exist), as -inf otherwise.
template <typename T>
__device__ __forceinline__ void load_edges(const T* row, const Split& sp,
                                           int t, float& hv, float& tv) {
  hv = t < sp.head ? to_f32(row[t]) : REPRO_NEG_INF;
  tv = t < sp.tail ? to_f32(row[sp.head + sp.nv * kVec<T> + t])
                   : REPRO_NEG_INF;
}

// One step of the thread's online recurrence (Alg. 3 lines 4-5) over the
// n values v, in fp32: every form's leaf is an fp32 sum.
template <typename Form, int N>
__device__ __forceinline__ void md_step(float& m, float& d,
                                        const float (&v)[N]) {
  float bm = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) bm = fmaxf(bm, v[i]);
  const float mn = fmaxf(m, bm);
  if (mn == REPRO_NEG_INF) return;    // nothing live yet: (-inf, 0) stays
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s += Form::exp(v[i] - mn);   // -inf gives 0
  d = d * (m == mn ? 1.f : Form::exp(m - mn)) + s;
  m = mn;
}

// The thread's (m, d) over body vectors j, j + step, ... below hi, kLoads
// vectors loaded together per step.
template <typename T, typename Form>
__device__ __forceinline__ void thread_md(const T* body, int j, int hi,
                                          int step, float& m, float& d) {
  for (; j < hi; j += kLoads * step) {
    float v[kLoads * kVec<T>];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      float w[kVec<T>];
      if (j + u * step < hi) {
        load16(body + static_cast<size_t>(j + u * step) * kVec<T>, w);
      } else {
#pragma unroll
        for (int e = 0; e < kVec<T>; ++e) w[e] = REPRO_NEG_INF;
      }
#pragma unroll
      for (int e = 0; e < kVec<T>; ++e) v[u * kVec<T> + e] = w[e];
    }
    md_step<Form>(m, d, v);
  }
}

template <typename Form>
__device__ __forceinline__ void warp_md(float& m, float& d) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    Form::combine(m, d, __shfl_xor_sync(0xffffffffu, m, off),
                  __shfl_xor_sync(0xffffffffu, d, off));
}

// y = exp(x - m) * inv over n values in place; a dead row (m = -inf) has
// only -inf entries, which give 0 against m = 0.
template <typename Form, int N>
__device__ __forceinline__ void normalize(float (&v)[N], float m, float inv) {
  const float mm = m == REPRO_NEG_INF ? 0.f : m;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = Form::exp(v[i] - mm) * inv;
}

__device__ __forceinline__ float inv_d(float d) {
  return 1.f / (d == 0.f ? 1.f : d);   // IEEE reciprocal, once per row
}

// The softmax of the head and tail scalars this thread owns.
template <typename T, typename Form>
__device__ __forceinline__ void write_edges(T* yrow, const Split& sp, int t,
                                            float hv, float tv, float m,
                                            float inv) {
  float e[2] = {hv, tv};
  normalize<Form>(e, m, inv);
  if (t < sp.head) yrow[t] = from_f32<T>(e[0]);
  if (t < sp.tail) yrow[sp.head + sp.nv * kVec<T> + t] = from_f32<T>(e[1]);
}

// ---- row-resident design -------------------------------------------------
// kGroup threads a row (32: one warp a row, blockDim / 32 rows a CTA; 0: the
// whole CTA a row).  kSoftmax: copy the row's body into shared memory
// (`slot` bytes a row), then write y from it; else read it from HBM and
// write (m, d) only.
template <typename T, typename Form, bool kSoftmax, int kGroup>
__global__ void __launch_bounds__(kMaxRowThreads)
    rows_kernel(const T* __restrict__ x, int R, int V, int slot,
                T* __restrict__ y, float* __restrict__ m_out,
                float* __restrict__ d_out) {
  extern __shared__ __align__(16) unsigned char rows_smem[];
  __shared__ float sm[32], sd[32];
  const int G = kGroup ? kGroup : blockDim.x;
  const int g = threadIdx.x / G, t = threadIdx.x % G;
  const size_t r = static_cast<size_t>(blockIdx.x) * (blockDim.x / G) + g;
  if (r >= static_cast<size_t>(R)) return;   // whole warps (kGroup 32) only
  const T* row = x + r * V;
  const Split sp = split_row(row, V);
  const T* body = row + sp.head;
  T* copy = reinterpret_cast<T*>(rows_smem + static_cast<size_t>(g) * slot);
  if constexpr (kSoftmax) {
    for (int j = t; j < sp.nv; j += G)
      cp_async16(smem_addr(copy + j * kVec<T>), body + j * kVec<T>);
    cp_async_commit();
  }
  float hv, tv;
  load_edges(row, sp, t, hv, tv);
  float m = REPRO_NEG_INF, d = 0.f;
  const float e[2] = {hv, tv};
  md_step<Form>(m, d, e);
  if constexpr (kSoftmax) {
    cp_async_wait_all();
    if (kGroup) __syncwarp(); else __syncthreads();
    thread_md<T, Form>(copy, t, sp.nv, G, m, d);
  } else {
    thread_md<T, Form>(body, t, sp.nv, G, m, d);
  }
  d = Form::leaf(d);
  if (kGroup) warp_md<Form>(m, d); else block_md<Form>(m, d, sm, sd);
  if (t == 0) {
    m_out[r] = m;
    d_out[r] = d;
  }
  if constexpr (kSoftmax) {
    const float inv = inv_d(d);
    T* yrow = y + r * V;
    T* ybody = yrow + sp.head;
    for (int j = t; j < sp.nv; j += G) {
      float v[kVec<T>];
      load16(copy + j * kVec<T>, v);
      normalize<Form>(v, m, inv);
      store16(ybody + j * kVec<T>, v);
    }
    write_edges<T, Form>(yrow, sp, t, hv, tv, m, inv);
  }
}

// ---- streaming design ----------------------------------------------------
// Sweep one: grid (R, S); block (r, s) scans body vectors [s * sv, (s + 1) *
// sv) of row r (slice 0 also the head and tail) and writes its (m, d) to
// part_m / part_d [R, S].
template <typename T, typename Form>
__global__ void __launch_bounds__(kStreamThreads)
    md_slice_kernel(const T* __restrict__ x, int V, int sv,
                    float* __restrict__ part_m, float* __restrict__ part_d) {
  __shared__ float sm[32], sd[32];
  const size_t r = blockIdx.x;
  const int s = blockIdx.y, S = gridDim.y, t = threadIdx.x;
  const T* row = x + r * V;
  const Split sp = split_row(row, V);
  float m = REPRO_NEG_INF, d = 0.f;
  if (s == 0) {
    float e[2];
    load_edges(row, sp, t, e[0], e[1]);
    md_step<Form>(m, d, e);
  }
  const int lo = s * sv;
  thread_md<T, Form>(row + sp.head, lo + t, min(sp.nv, lo + sv), blockDim.x,
                     m, d);
  d = Form::leaf(d);
  block_md<Form>(m, d, sm, sd);
  if (t == 0) {
    part_m[r * S + s] = m;
    part_d[r * S + s] = d;
  }
}

// The row's (m, d) from its S partials, by one warp (every lane gets it).
template <typename Form>
__device__ __forceinline__ void merge_slices(const float* __restrict__ pm,
                                             const float* __restrict__ pd,
                                             int S, float& m, float& d) {
  const int lane = threadIdx.x & 31;
  m = REPRO_NEG_INF;
  d = 0.f;
  for (int s = lane; s < S; s += 32) Form::combine(m, d, pm[s], pd[s]);
  warp_md<Form>(m, d);
}

// The normalizer's merge: one warp a row.
template <typename Form>
__global__ void __launch_bounds__(256)
    md_merge_kernel(int R, int S, const float* __restrict__ part_m,
                    const float* __restrict__ part_d, float* __restrict__ m_out,
                    float* __restrict__ d_out) {
  const size_t r = static_cast<size_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (r >= static_cast<size_t>(R)) return;
  float m, d;
  merge_slices<Form>(part_m + r * S, part_d + r * S, S, m, d);
  if ((threadIdx.x & 31) == 0) {
    m_out[r] = m;
    d_out[r] = d;
  }
}

// kLoads raw 16-byte vectors j, j + step, ... below hi (others untouched).
template <typename T>
__device__ __forceinline__ void load_raw(uint4 (&raw)[kLoads], const T* body,
                                         int j, int hi, int step) {
#pragma unroll
  for (int u = 0; u < kLoads; ++u)
    if (j + u * step < hi)
      raw[u] = *reinterpret_cast<const uint4*>(
          body + static_cast<size_t>(j + u * step) * kVec<T>);
}

// Sweep two (Alg. 3 lines 7-9): grid (R, S) as sweep one.  Each thread
// issues its first kLoads loads of x, then warp 0 merges the row's S
// partials (block s = 0 writes the row's m and d); the block then strides
// over its slice with the next kLoads loads in flight while it writes y =
// exp(x - m) * (1/d) for the current ones.
template <typename T, typename Form>
__global__ void __launch_bounds__(kStreamThreads)
    normalize_kernel(const T* __restrict__ x, int V, int sv,
                     const float* __restrict__ part_m,
                     const float* __restrict__ part_d,
                     float* __restrict__ m_out, float* __restrict__ d_out,
                     T* __restrict__ y) {
  __shared__ float smd[2];
  const size_t r = blockIdx.x;
  const int s = blockIdx.y, S = gridDim.y, t = threadIdx.x;
  const T* row = x + r * V;
  T* yrow = y + r * V;
  const Split sp = split_row(row, V);
  const T* body = row + sp.head;
  T* ybody = yrow + sp.head;
  const int hi = min(sp.nv, (s + 1) * sv), step = blockDim.x;
  int j = s * sv + t;
  uint4 cur[kLoads], nxt[kLoads];
  load_raw(cur, body, j, hi, step);
  if (t < 32) {
    float m, d;
    merge_slices<Form>(part_m + r * S, part_d + r * S, S, m, d);
    if (t == 0) {
      smd[0] = m;
      smd[1] = d;
      if (s == 0) {
        m_out[r] = m;
        d_out[r] = d;
      }
    }
  }
  __syncthreads();
  const float m = smd[0], inv = inv_d(smd[1]);
  for (; j < hi; j += kLoads * step) {
    load_raw(nxt, body, j + kLoads * step, hi, step);
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (j + u * step < hi) {
        float v[kVec<T>];
        unpack16<T>(cur[u], v);
        normalize<Form>(v, m, inv);
        store16(ybody + static_cast<size_t>(j + u * step) * kVec<T>, v);
      }
      cur[u] = nxt[u];
    }
  }
  if (s == 0) {
    float hv, tv;
    load_edges(row, sp, t, hv, tv);
    write_edges<T, Form>(yrow, sp, t, hv, tv, m, inv);
  }
}

// ---- launchers -------------------------------------------------------------
// Dynamic shared memory beyond the default (48 KB less the kernel's static
// arrays) must be allowed per kernel; `allowed` keeps the most this kernel
// was allowed so far (0: none asked yet).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// The plan's design: `threads` per CTA, `sv` vectors a slice (streaming).
struct Plan {
  int design, threads, sv;
};

template <typename T, typename Form, bool kSoftmax>
cudaError_t launch_rows(const Plan& p, const void* x, int R, int V, void* y,
                        float* m, float* d, cudaStream_t st) {
  const int slot = (V + kVec<T> - 1) / kVec<T> * 16;   // bytes a row copy
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (p.design == kDesignWarp) {
    const int rows = p.threads / 32;
    const size_t smem = kSoftmax ? static_cast<size_t>(rows) * slot : 0;
    auto kernel = rows_kernel<T, Form, kSoftmax, 32>;
    static size_t allowed = 0;
    cudaError_t err = allow_smem(kernel, smem, allowed);
    if (err != cudaSuccess) return err;
    kernel<<<(R + rows - 1) / rows, p.threads, smem, st>>>(xt, R, V, slot, yt,
                                                           m, d);
  } else {
    const size_t smem = kSoftmax ? slot : 0;
    auto kernel = rows_kernel<T, Form, kSoftmax, 0>;
    static size_t allowed = 0;
    cudaError_t err = allow_smem(kernel, smem, allowed);
    if (err != cudaSuccess) return err;
    kernel<<<R, p.threads, smem, st>>>(xt, R, V, slot, yt, m, d);
  }
  return cudaGetLastError();
}

// Sweep one of the streaming design; with S == 1 it writes m, d directly.
template <typename T, typename Form>
cudaError_t launch_slices(const Plan& p, const void* x, int R, int V, int S,
                          float* pm, float* pd, cudaStream_t st) {
  md_slice_kernel<T, Form><<<dim3(R, S), kStreamThreads, 0, st>>>(
      static_cast<const T*>(x), V, p.sv, pm, pd);
  return cudaGetLastError();
}

int n_slices(int V, int vec, int sv) {
  return ((V + vec - 1) / vec + sv - 1) / sv;
}

template <typename T, typename Form>
cudaError_t normalizer(const Plan& p, const void* x, int R, int V, float* m,
                       float* d, float* part_m, float* part_d,
                       cudaStream_t st) {
  if (p.design != kDesignStream)
    return launch_rows<T, Form, false>(p, x, R, V, nullptr, m, d, st);
  const int S = n_slices(V, kVec<T>, p.sv);
  cudaError_t err = launch_slices<T, Form>(p, x, R, V, S, S == 1 ? m : part_m,
                                           S == 1 ? d : part_d, st);
  if (err != cudaSuccess || S == 1) return err;
  md_merge_kernel<Form><<<(R + 7) / 8, 256, 0, st>>>(R, S, part_m, part_d, m,
                                                     d);
  return cudaGetLastError();
}

template <typename T, typename Form>
cudaError_t softmax(const Plan& p, const void* x, int R, int V, void* y,
                    float* m, float* d, float* part_m, float* part_d,
                    cudaStream_t st) {
  if (p.design != kDesignStream)
    return launch_rows<T, Form, true>(p, x, R, V, y, m, d, st);
  const int S = n_slices(V, kVec<T>, p.sv);
  cudaError_t err = launch_slices<T, Form>(p, x, R, V, S, part_m, part_d, st);
  if (err != cudaSuccess) return err;
  normalize_kernel<T, Form><<<dim3(R, S), kStreamThreads, 0, st>>>(
      static_cast<const T*>(x), V, p.sv, part_m, part_d, m, d,
      static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T>
cudaError_t softmax_form(int form, const Plan& p, const void* x, int R, int V,
                         void* y, float* m, float* d, float* part_m,
                         float* part_d, cudaStream_t st) {
  switch (form) {
    case kFormExact:
      return softmax<T, FormExact>(p, x, R, V, y, m, d, part_m, part_d, st);
    case kFormBF16:
      return softmax<T, FormBF16>(p, x, R, V, y, m, d, part_m, part_d, st);
    case kFormExp2:
      return softmax<T, FormExp2>(p, x, R, V, y, m, d, part_m, part_d, st);
    default:
      return cudaErrorInvalidValue;
  }
}

bool valid_plan(const Plan& p, int R, int V) {
  if (R < 1 || V < 1 || p.design < kDesignWarp || p.design > kDesignStream)
    return false;
  if (p.design == kDesignWarp) return p.threads == kWarpThreads;
  if (p.design == kDesignBlock)
    return p.threads >= 32 && p.threads <= kMaxRowThreads &&
           p.threads % 32 == 0;
  return p.threads == kStreamThreads && p.sv > 0;
}

}  // namespace

// x [R, V] contiguous (dtype code), any R >= 1 (rows on grid.x); m, d [R]
// float32; part_m / part_d hold R * S floats each for the streaming design
// (S = ceil(ceil(V / vec) / sv), vec = 16 bytes of x's dtype; unused
// otherwise).  design 0 one warp a row (threads 256), 1 one CTA a row
// (threads 32..512), 2 streaming (threads 512, sv vectors a slice), as
// kernels/online_softmax.py:plan chooses.  Exact form.
extern "C" int online_normalizer_launch(const void* x, int dtype, int R, int V,
                                        int design, int threads, int sv,
                                        void* m, void* d, void* part_m,
                                        void* part_d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p{design, threads, sv};
  if (!valid_plan(p, R, V)) return static_cast<int>(cudaErrorInvalidValue);
  float *fm = static_cast<float*>(m), *fd = static_cast<float*>(d);
  float *pm = static_cast<float*>(part_m), *pd = static_cast<float*>(part_d);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = normalizer<float, FormExact>(p, x, R, V, fm, fd, pm, pd, st);
  } else if (dtype == kDtypeBF16) {
    err = normalizer<__nv_bfloat16, FormExact>(p, x, R, V, fm, fd, pm, pd,
                                               st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// As above, plus y [R, V] in x's dtype, at x's address modulo 16 bytes;
// form 0 exact, 1 bf16, 2 exp2 (d of the bf16 form holds a bf16 value).
extern "C" int online_softmax_launch(const void* x, int dtype, int form, int R,
                                     int V, int design, int threads, int sv,
                                     void* y, void* m, void* d, void* part_m,
                                     void* part_d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p{design, threads, sv};
  if (!valid_plan(p, R, V)) return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(y)) &
       15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  float *fm = static_cast<float*>(m), *fd = static_cast<float*>(d);
  float *pm = static_cast<float*>(part_m), *pd = static_cast<float*>(part_d);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = softmax_form<float>(form, p, x, R, V, y, fm, fd, pm, pd, st);
  } else if (dtype == kDtypeBF16) {
    err = softmax_form<__nv_bfloat16>(form, p, x, R, V, y, fm, fd, pm, pd,
                                      st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
