// Fused softmax + top-k over the rows of x [R, V]: the paper's Algorithm 4.
//
// Replaces: src/repro/kernels/softmax_topk.py, softmax_topk_pallas (the
//   pallas_call at line 100; body _make_kernel:44, _select_topk:26).
// Bound on the H100: bytes.  Each logit is read once and only O(k) values
//   per row are written, so the floor is R*V*sizeof(x) over 3.35 TB/s; the
//   per-element work (a max, an exp, a compare) is far below the FLOP rate.
// Design: on the serving path R is the decode batch (4..8) and V = 49152, so
//   one CTA per row would leave most of the 132 SMs idle.  Because ⊕ is
//   associative the pass splits in two:
//   * phase one, a grid of (R rows, S slices): each thread streams its
//     strided share of one V-slice, keeping its own (m, d) and a sorted
//     register list of its best KMAX (value, index) pairs; the block merges
//     (m, d) by warp shuffles and shared memory, and picks the slice's top k
//     in k rounds of a block-wide arg-max.  The partial (m, d, u[k], p[k])
//     goes to scratch the wrapper allocates;
//   * phase two, one CTA per row: ⊕-merges the S partials and selects the
//     row's top k from the S*k candidates, writing vals = exp(u - m) / d,
//     the int32 indices and lse = m + log d.
//   Every comparison orders by (value descending, index ascending), so exact
//   ties resolve to the lowest index as lax.top_k's do.  -inf logits (a
//   padded vocabulary) leave d unchanged.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads1 = 256;
constexpr int kThreads2 = 128;

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide arg-max by (value desc, index asc); every thread gets the winner.
__device__ void block_best(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  warp_best(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? sv[lane] : REPRO_NEG_INF;
    i = lane < nwarps ? si[lane] : INT_MAX;
    warp_best(v, i);
    if (lane == 0) {
      sv[0] = v;
      si[0] = i;
    }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();  // sv/si may be reused by the next call
}

// Phase one: grid (R, S), rows on grid.x so any R < 2^31 fits.  part_md
// [R, S, 2], part_u / part_p [R, S, k].
template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads1)
    topk_partial_kernel(const T* __restrict__ x, int V, int k, int slice,
                        float* __restrict__ part_md, float* __restrict__ part_u,
                        int* __restrict__ part_p) {
  __shared__ float sv[32], sm[32], sd[32];
  __shared__ int si[32];
  const size_t r = blockIdx.x;
  const int s = blockIdx.y, S = gridDim.y;
  const int lo = s * slice;
  const int hi = min(V, lo + slice);
  const T* row = x + r * V;

  float m = REPRO_NEG_INF, d = 0.f;
  float u[KMAX];
  int p[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    u[j] = REPRO_NEG_INF;
    p[j] = INT_MAX;
  }
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const float xv = to_f32(row[i]);
    // (m, d) update, Alg. 3 lines 4-5; a -inf logit contributes nothing
    if (xv > m) {
      d = d * rescale(m, xv) + 1.f;
      m = xv;
    } else if (xv != REPRO_NEG_INF) {
      d += expf(xv - m);
    }
    // running top-KMAX, Alg. 4 lines 8-15: insertion into the sorted list
    if (better(xv, i, u[KMAX - 1], p[KMAX - 1])) {
      bool placed = false;
#pragma unroll
      for (int j = KMAX - 1; j > 0; --j) {
        if (!placed) {
          if (better(xv, i, u[j - 1], p[j - 1])) {
            u[j] = u[j - 1];
            p[j] = p[j - 1];
          } else {
            u[j] = xv;
            p[j] = i;
            placed = true;
          }
        }
      }
      if (!placed) {
        u[0] = xv;
        p[0] = i;
      }
    }
  }

  block_md(m, d, sm, sd);
  const size_t part = r * S + s;
  if (threadIdx.x == 0) {
    part_md[2 * part] = m;
    part_md[2 * part + 1] = d;
  }
  // the slice's top k: k rounds of a block arg-max over the list heads; the
  // winning thread pops its head (indices are unique to one thread)
  for (int t = 0; t < k; ++t) {
    float bv = u[0];
    int bi = p[0];
    block_best(bv, bi, sv, si);
    if (threadIdx.x == 0) {
      part_u[part * k + t] = bv;
      part_p[part * k + t] = bi;
    }
    if (p[0] == bi) {
#pragma unroll
      for (int j = 0; j < KMAX - 1; ++j) {
        u[j] = u[j + 1];
        p[j] = p[j + 1];
      }
      u[KMAX - 1] = REPRO_NEG_INF;
      p[KMAX - 1] = INT_MAX;
    }
  }
}

// Phase two: one CTA per row (grid.x); dynamic shared memory holds the S*k
// candidates.
template <typename T>
__global__ void __launch_bounds__(kThreads2)
    topk_merge_kernel(int S, int k, const float* __restrict__ part_md,
                      const float* __restrict__ part_u,
                      const int* __restrict__ part_p, T* __restrict__ vals,
                      int* __restrict__ idx, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float sv[32], sm[32], sd[32];
  __shared__ int si[32];
  const size_t r = blockIdx.x;
  const int n = S * k;
  float* cu = reinterpret_cast<float*>(smem_raw);
  int* cp = reinterpret_cast<int*>(cu + n);

  float m = REPRO_NEG_INF, d = 0.f;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const size_t part = r * S + s;
    md_combine(m, d, part_md[2 * part], part_md[2 * part + 1]);
  }
  block_md(m, d, sm, sd);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    cu[j] = part_u[r * n + j];
    cp[j] = part_p[r * n + j];
  }
  __syncthreads();
  for (int t = 0; t < k; ++t) {
    float bv = REPRO_NEG_INF;
    int bi = INT_MAX, bpos = -1;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      if (cp[j] >= 0 && (bpos < 0 || better(cu[j], cp[j], bv, bi))) {
        bv = cu[j];
        bi = cp[j];
        bpos = j;
      }
    }
    const float mine_v = bv;
    const int mine_i = bi;
    block_best(bv, bi, sv, si);
    if (bpos >= 0 && mine_v == bv && mine_i == bi) cp[bpos] = -1;  // taken
    if (threadIdx.x == 0) {
      vals[r * k + t] = from_f32<T>(expf(bv - m) / d);
      idx[r * k + t] = bi;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) lse[r] = m + logf(d);
}

template <typename T, int KMAX>
cudaError_t launch(const void* x, int R, int V, int k, int slice, void* vals,
                   void* idx, void* lse, void* part_f, void* part_i,
                   cudaStream_t stream) {
  const int S = (V + slice - 1) / slice;
  float* part_md = static_cast<float*>(part_f);
  float* part_u = part_md + static_cast<size_t>(R) * S * 2;
  int* part_p = static_cast<int*>(part_i);
  topk_partial_kernel<T, KMAX><<<dim3(R, S), kThreads1, 0, stream>>>(
      static_cast<const T*>(x), V, k, slice, part_md, part_u, part_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(S) * k * (sizeof(float) + sizeof(int));
  topk_merge_kernel<T><<<R, kThreads2, smem, stream>>>(
      S, k, part_md, part_u, part_p, static_cast<T*>(vals),
      static_cast<int*>(idx), static_cast<float*>(lse));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* x, int R, int V, int k, int slice, void* vals,
                     void* idx, void* lse, void* part_f, void* part_i,
                     cudaStream_t stream) {
  if (k <= 8)
    return launch<T, 8>(x, R, V, k, slice, vals, idx, lse, part_f, part_i,
                        stream);
  if (k <= 16)
    return launch<T, 16>(x, R, V, k, slice, vals, idx, lse, part_f, part_i,
                         stream);
  return launch<T, 32>(x, R, V, k, slice, vals, idx, lse, part_f, part_i,
                       stream);
}

}  // namespace

// x [R, V] contiguous (dtype code), any R >= 1, 1 <= k <= 32; vals [R, k] (x's dtype),
// idx [R, k] int32, lse [R] float32; part_f holds R*S*(2+k) floats and
// part_i R*S*k ints, S = ceil(V / slice).  Returns cudaGetLastError().
extern "C" int softmax_topk_launch(const void* x, int dtype, int R, int V,
                                   int k, int slice, void* vals, void* idx,
                                   void* lse, void* part_f, void* part_i,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = launch_k<float>(x, R, V, k, slice, vals, idx, lse, part_f, part_i,
                          st);
  } else if (dtype == kDtypeBF16) {
    err = launch_k<__nv_bfloat16>(x, R, V, k, slice, vals, idx, lse, part_f,
                                  part_i, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
