// Online softmax over the rows of x [R, V]: the paper's Algorithm 3, in two
// sweeps, and its normalizer alone.
//
// Replaces: src/repro/kernels/online_softmax.py, online_softmax_pallas (the
//   pallas_calls at line 66, _normalizer_kernel:31, and 77,
//   _normalize_kernel:48) and online_normalizer_pallas (line 99); and the
//   reduced-precision forms that the reference ran in XLA
//   (src/repro/kernels/dispatch.py:514 bf16, :520 exp2; their arithmetic is
//   src/repro/core/softmax_forms.py:_online_md, :63).
// Bound on the H100: bytes.  The normalizer reads each element once; the
//   normalize sweep reads it once more and writes y once: 3 accesses per
//   element where safe softmax takes 4.  Per element the work is a max, an
//   exp and an add, far below the FLOP rate.
// Design: the TPU kernel carried (m, d) across V-tiles of a grid that runs in
//   order; here blocks run in parallel, so the normalizer splits in two:
//   * phase one, a grid of (S slices of 32 leaves, R rows): a leaf is 128
//     consecutive entries (the reference forms' leaf); each warp takes the
//     slice's leaves w, w+8, ..., reads a leaf as 4 coalesced loads a lane,
//     and updates its (m, d) as _online_md's scan step does: m_new = max(m,
//     leaf max), the leaf's sum of exp(x - m_new) in fp32 over the warp,
//     then d = d * exp(m - m_new) + sum.  The block ⊕-merges its 8 warps
//     (block_md) and writes the slice's (m, d) to scratch, or to the
//     outputs when the row is one slice;
//   * phase two (S > 1), one warp per row: ⊕-merges the S partials.
//   The normalize kernel is elementwise: y = exp(x - m) / d in x's dtype.
//   Fixed slices of 4096 entries keep R*S blocks in flight for 8 rows as for
//   4000 (the slices fill the 132 SMs where rows alone would not); V needs
//   no multiple of anything (the tail lanes read -inf).
// Forms (template policies of both sweeps): exact (expf, d in fp32; no fast
//   math), exp2 (exp2f of the product z * log2e rounded to fp32) and bf16
//   (expf; each leaf's fp32 sum rounded to bf16, and every merge's rescale,
//   product and sum rounded to bf16, so each term sees at most
//   2 + 3 * (3 + 3 + ceil(log2 S)) bf16 roundings: 4 leaves a warp, 8 warps,
//   S slices).
// Dead entries (-inf) contribute exactly 0, and the rescale of a -inf
//   running max is pinned to 1: a row whose first slice or whole extent is
//   -inf gives (m, d) = (max, d) or (-inf, 0) and y = 0 there, as
//   core.online_softmax does (not the Pallas kernel's NaN).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLeaf = 128;                 // entries of one leaf
constexpr int kSliceLeaves = 32;           // leaves of one phase-one block
constexpr int kPerThread = 4;              // normalize: entries per thread
constexpr float kLog2e = 1.4426950408889634f;

enum : int { kFormExact = 0, kFormBF16 = 1, kFormExp2 = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct FormExact {
  __device__ __forceinline__ static float exp(float z) { return expf(z); }
  __device__ __forceinline__ static void step(float& d, float alpha,
                                              float sum) {
    d = d * alpha + sum;
  }
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
  __device__ __forceinline__ static void step(float& d, float alpha,
                                              float sum) {
    d = __fadd_rn(__fmul_rn(d, alpha), sum);
  }
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
  // d is bf16-valued: the rescale cast, the product and the sum each round
  __device__ __forceinline__ static void step(float& d, float alpha,
                                              float sum) {
    d = bf16_round(bf16_round(d * bf16_round(alpha)) + bf16_round(sum));
  }
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Phase one: grid (S, R); writes part_m / part_d [R, S].
template <typename T, typename Form>
__global__ void __launch_bounds__(kThreads)
    md_partial_kernel(const T* __restrict__ x, int V,
                      float* __restrict__ part_m, float* __restrict__ part_d) {
  __shared__ float sm[32], sd[32];
  const int s = blockIdx.x, r = blockIdx.y, S = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = (V + kLeaf - 1) / kLeaf;
  const int hi = min(nb, (s + 1) * kSliceLeaves);
  const T* row = x + static_cast<size_t>(r) * V;

  float m = REPRO_NEG_INF, d = 0.f;   // the warp's (m, d), same in every lane
  for (int j = s * kSliceLeaves + warp; j < hi; j += kWarps) {
    float v[kLeaf / 32];
#pragma unroll
    for (int k = 0; k < kLeaf / 32; ++k) {
      const int i = j * kLeaf + k * 32 + lane;
      v[k] = i < V ? to_f32(row[i]) : REPRO_NEG_INF;
    }
    float lm = v[0];
#pragma unroll
    for (int k = 1; k < kLeaf / 32; ++k) lm = fmaxf(lm, v[k]);
    const float mn = fmaxf(m, warp_max(lm));       // Alg. 3 line 4
    float p = 0.f;
#pragma unroll
    for (int k = 0; k < kLeaf / 32; ++k)
      p += v[k] == REPRO_NEG_INF ? 0.f : Form::exp(v[k] - mn);
    Form::step(d, m == mn ? 1.f : Form::exp(m - mn), warp_sum(p));  // line 5
    m = mn;
  }
  if (lane != 0) {                    // one copy of each warp's (m, d)
    m = REPRO_NEG_INF;
    d = 0.f;
  }
  block_md<Form>(m, d, sm, sd);
  if (threadIdx.x == 0) {
    part_m[static_cast<size_t>(r) * S + s] = m;
    part_d[static_cast<size_t>(r) * S + s] = d;
  }
}

// Phase two: one warp per row ⊕-merges the row's S partials.
template <typename Form>
__global__ void __launch_bounds__(kThreads)
    md_merge_kernel(int R, int S, const float* __restrict__ part_m,
                    const float* __restrict__ part_d, float* __restrict__ m_out,
                    float* __restrict__ d_out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  float m = REPRO_NEG_INF, d = 0.f;
  for (int s = lane; s < S; s += 32) {
    const size_t at = static_cast<size_t>(r) * S + s;
    Form::combine(m, d, part_m[at], part_d[at]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Form::combine(m, d, __shfl_xor_sync(0xffffffffu, m, off),
                  __shfl_xor_sync(0xffffffffu, d, off));
  }
  if (lane == 0) {
    m_out[r] = m;
    d_out[r] = d;
  }
}

// Alg. 3 lines 7-9: grid (ceil(V / 1024), R); y = exp(x - m) / d, 0 where x
// is -inf, and d = 0 (a row with no finite entry) divides by 1.
template <typename T, typename Form>
__global__ void __launch_bounds__(kThreads)
    normalize_kernel(const T* __restrict__ x, int V,
                     const float* __restrict__ m, const float* __restrict__ d,
                     T* __restrict__ y) {
  const int r = blockIdx.y;
  const float mr = m[r];
  const float dr = d[r];
  const float den = dr == 0.f ? 1.f : dr;
  const size_t base = static_cast<size_t>(r) * V;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = (blockIdx.x * kPerThread + k) * kThreads + threadIdx.x;
    if (i < V) {
      const float xv = to_f32(x[base + i]);
      const float e = xv == REPRO_NEG_INF ? 0.f : Form::exp(xv - mr);
      y[base + i] = from_f32<T>(e / den);
    }
  }
}

int n_slices(int V) {
  const int nb = (V + kLeaf - 1) / kLeaf;
  return (nb + kSliceLeaves - 1) / kSliceLeaves;
}

template <typename T, typename Form>
cudaError_t normalizer(const void* x, int R, int V, float* m, float* d,
                       float* part_m, float* part_d, cudaStream_t stream) {
  const int S = n_slices(V);
  float* pm = S == 1 ? m : part_m;
  float* pd = S == 1 ? d : part_d;
  md_partial_kernel<T, Form><<<dim3(S, R), kThreads, 0, stream>>>(
      static_cast<const T*>(x), V, pm, pd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  md_merge_kernel<Form><<<(R + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      R, S, part_m, part_d, m, d);
  return cudaGetLastError();
}

template <typename T, typename Form>
cudaError_t softmax(const void* x, int R, int V, void* y, float* m, float* d,
                    float* part_m, float* part_d, cudaStream_t stream) {
  cudaError_t err = normalizer<T, Form>(x, R, V, m, d, part_m, part_d, stream);
  if (err != cudaSuccess) return err;
  const int per_block = kPerThread * kThreads;
  normalize_kernel<T, Form>
      <<<dim3((V + per_block - 1) / per_block, R), kThreads, 0, stream>>>(
          static_cast<const T*>(x), V, m, d, static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T>
cudaError_t softmax_form(int form, const void* x, int R, int V, void* y,
                         float* m, float* d, float* part_m, float* part_d,
                         cudaStream_t st) {
  switch (form) {
    case kFormExact:
      return softmax<T, FormExact>(x, R, V, y, m, d, part_m, part_d, st);
    case kFormBF16:
      return softmax<T, FormBF16>(x, R, V, y, m, d, part_m, part_d, st);
    case kFormExp2:
      return softmax<T, FormExp2>(x, R, V, y, m, d, part_m, part_d, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [R, V] contiguous (dtype code), R <= 65535; m, d [R] float32 (d of the
// bf16 form holds a bf16 value); part_m / part_d hold R * S floats each, S =
// ceil(V / 4096) (unused when S == 1).  Exact form.
extern "C" int online_normalizer_launch(const void* x, int dtype, int R, int V,
                                        void* m, void* d, void* part_m,
                                        void* part_d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *fm = static_cast<float*>(m), *fd = static_cast<float*>(d);
  float *pm = static_cast<float*>(part_m), *pd = static_cast<float*>(part_d);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = normalizer<float, FormExact>(x, R, V, fm, fd, pm, pd, st);
  } else if (dtype == kDtypeBF16) {
    err = normalizer<__nv_bfloat16, FormExact>(x, R, V, fm, fd, pm, pd, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// As above, plus y [R, V] in x's dtype; form 0 exact, 1 bf16, 2 exp2.
extern "C" int online_softmax_launch(const void* x, int dtype, int form, int R,
                                     int V, void* y, void* m, void* d,
                                     void* part_m, void* part_d,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *fm = static_cast<float*>(m), *fd = static_cast<float*>(d);
  float *pm = static_cast<float*>(part_m), *pd = static_cast<float*>(part_d);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = softmax_form<float>(form, x, R, V, y, fm, fd, pm, pd, st);
  } else if (dtype == kDtypeBF16) {
    err = softmax_form<__nv_bfloat16>(form, x, R, V, y, fm, fd, pm, pd, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
