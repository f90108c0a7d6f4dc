// Flash attention backward from the forward's saved log-sum-exp: P is rebuilt
// tile by tile as exp(s - lse), the paper's (m, d) in log form, so the
// [Tq, Tk] score matrix is never stored.  Two kernels, as in the reference:
//
//   dq    one CTA per (16 query rows, query head, batch row): streams the key
//         tiles up to the diagonal and accumulates
//         dq = sum_k ds * k,  ds = p * (dp - delta) * scale,  dp = dO . v;
//   dk/dv one CTA per (16 keys, KV head, batch row): loops over the G query
//         heads of its group and the query tiles from the diagonal on and
//         accumulates dv = sum_q p * dO and dk = sum_q ds * q.
//
// Replaces: src/repro/kernels/flash_attention_bwd.py,
//   flash_attention_bwd_pallas (line 114; the pallas_calls at :134, dq, and
//   :154, dk/dv), bf16/fp32.
// Bound on the H100: operations at the training shape (T = 512, D = 64):
//   five products of 2 * D flops per (row, key) pair below the diagonal
//   against one read of q, k, v, out, dO; on CUDA cores the kernels are far
//   from either roof.
// Design: the reference emitted dk/dv per query head ([B, Hq, T, D]) and
//   summed the G heads of a group afterwards (ops.py:196-197); here the dk/dv
//   CTA owns its keys for the whole group, so dk and dv are written once,
//   already reduced, straight into [B, Tk, Hkv, D]: no per-head buffer, no
//   atomics, and the result does not depend on scheduling (a restarted run
//   reproduces an uninterrupted one bit for bit).  q, dO and dq are
//   [B, Tq, Hq, D]; k and v are read in the model layout through their
//   strides; lse and delta = rowsum(dO * O) are [B, Hq, Tq] float32.  Rows
//   past Tq and keys past Tk are masked and never read, so T need not
//   divide by the tile.  Everything accumulates in fp32 on CUDA cores.
#include "attention.cuh"

namespace {

constexpr int kRows = 16;     // rows a CTA owns: queries (dq), keys (dk/dv)
constexpr int kTile = 16;     // rows streamed per step: keys (dq), queries
constexpr int kThreads = 128;
constexpr int kRowThreads = kThreads / kRows;  // 8 threads per owned row

__host__ __device__ constexpr int bwd_smem_words(int D) {
  // two owned [kRows, D + 1] operands, two streamed [kTile, D + 1] ones,
  // two [kRows, kTile] score tiles, two [kRows or kTile] row statistics
  return 2 * kRows * (D + 1) + 2 * kTile * (D + 1) + 2 * kRows * kTile +
         2 * kTile;
}

// Rows [r0, r0 + n) of an operand whose row r starts at base + r * stride
// (its D values contiguous) into shared memory [n, D + 1] as fp32 times
// `mul`; rows at or past `limit` load as 0 without being read.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          size_t base, size_t stride, int r0,
                                          int n, int limit, float mul,
                                          float* dst) {
  for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (r0 + r < limit)
      x = to_f32(src[base + static_cast<size_t>(r0 + r) * stride + c]) * mul;
    dst[r * (D + 1) + c] = x;
  }
}

// lse and delta of rows [r0, r0 + n) of one (batch row, query head), whose
// row r lives at base + r; rows at or past Tq load as 0.
__device__ __forceinline__ void load_stats(const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           size_t base, int r0, int n, int Tq,
                                           float* ls, float* dl) {
  if (threadIdx.x < n) {
    const int r = r0 + threadIdx.x;
    ls[threadIdx.x] = r < Tq ? lse[base + r] : 0.f;
    dl[threadIdx.x] = r < Tq ? delta[base + r] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int Tq,
                  int Tk, int Hq, int Hkv, long long sb, long long ss,
                  long long sh, float scale, int causal) {
  constexpr int kLanes = D / kRowThreads;
  extern __shared__ __align__(16) float smem[];
  const int i0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads, lane = tid % kRowThreads;
  float* qs = smem;                     // [kRows, D + 1], pre-scaled
  float* dos = qs + kRows * (D + 1);    // [kRows, D + 1]
  float* ks = dos + kRows * (D + 1);    // [kTile, D + 1]
  float* vs = ks + kTile * (D + 1);     // [kTile, D + 1]
  float* dss = vs + kTile * (D + 1);    // [kRows, kTile] ds
  float* ls = dss + kRows * kTile;      // [kRows] lse
  float* dl = ls + kRows;               // [kRows] delta

  const size_t qbase = (static_cast<size_t>(b) * Tq * Hq + h) * D;
  const size_t qstride = static_cast<size_t>(Hq) * D;
  const size_t kbase = b * sb + hk * sh;
  load_rows<T, D>(q, qbase, qstride, i0, kRows, Tq, scale, qs);
  load_rows<T, D>(dout, qbase, qstride, i0, kRows, Tq, 1.f, dos);
  load_stats(lse, delta, (static_cast<size_t>(b) * Hq + h) * Tq, i0, kRows,
             Tq, ls, dl);
  const int last_row = min(i0 + kRows, Tq) - 1;
  int nb = (Tk + kTile - 1) / kTile;
  if (causal) nb = min(nb, last_row / kTile + 1);

  float acc[kLanes];
#pragma unroll
  for (int c = 0; c < kLanes; ++c) acc[c] = 0.f;
  for (int j = 0; j < nb; ++j) {
    __syncthreads();  // previous tile consumed (q, dO and stats written)
    load_rows<T, D>(k, kbase, ss, j * kTile, kTile, Tk, 1.f, ks);
    load_rows<T, D>(v, kbase, ss, j * kTile, kTile, Tk, 1.f, vs);
    __syncthreads();
    for (int e = tid; e < kRows * kTile; e += kThreads) {
      const int r = e / kTile, t = e % kTile;
      const int q_pos = i0 + r, k_pos = j * kTile + t;
      float ds = 0.f;
      if (q_pos < Tq && k_pos < Tk && (!causal || k_pos <= q_pos)) {
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) {
          s += qs[r * (D + 1) + c] * ks[t * (D + 1) + c];
          dp += dos[r * (D + 1) + c] * vs[t * (D + 1) + c];
        }
        ds = expf(s - ls[r]) * (dp - dl[r]) * scale;
      }
      dss[e] = ds;
    }
    __syncthreads();
    for (int t = 0; t < kTile; ++t) {
      const float x = dss[row * kTile + t];
#pragma unroll
      for (int c = 0; c < kLanes; ++c)
        acc[c] += x * ks[t * (D + 1) + lane + c * kRowThreads];
    }
  }
  if (i0 + row < Tq) {
    T* o = dq + qbase + static_cast<size_t>(i0 + row) * qstride;
#pragma unroll
    for (int c = 0; c < kLanes; ++c)
      o[lane + c * kRowThreads] = from_f32<T>(acc[c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int Tq, int Tk, int Hq, int Hkv,
                   long long sb, long long ss, long long sh, float scale,
                   int causal) {
  constexpr int kLanes = D / kRowThreads;
  extern __shared__ __align__(16) float smem[];
  const int j0 = blockIdx.x * kRows, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads, lane = tid % kRowThreads;
  float* ks = smem;                     // [kRows, D + 1]
  float* vs = ks + kRows * (D + 1);     // [kRows, D + 1]
  float* qs = vs + kRows * (D + 1);     // [kTile, D + 1]
  float* dos = qs + kTile * (D + 1);    // [kTile, D + 1]
  float* ps = dos + kTile * (D + 1);    // [kTile, kRows] p
  float* dss = ps + kTile * kRows;      // [kTile, kRows] ds
  float* ls = dss + kTile * kRows;      // [kTile] lse
  float* dl = ls + kTile;               // [kTile] delta

  const size_t kbase = b * sb + hk * sh;
  load_rows<T, D>(k, kbase, ss, j0, kRows, Tk, 1.f, ks);
  load_rows<T, D>(v, kbase, ss, j0, kRows, Tk, 1.f, vs);
  // causal: the first query tile holding a row at or past key j0
  const int i_first = causal ? j0 / kTile : 0;
  const int nq = (Tq + kTile - 1) / kTile;
  const size_t qstride = static_cast<size_t>(Hq) * D;

  float dka[kLanes], dva[kLanes];
#pragma unroll
  for (int c = 0; c < kLanes; ++c) dka[c] = dva[c] = 0.f;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qbase = (static_cast<size_t>(b) * Tq * Hq + h) * D;
    for (int i = i_first; i < nq; ++i) {
      __syncthreads();  // previous tile consumed (k, v written at first)
      load_rows<T, D>(q, qbase, qstride, i * kTile, kTile, Tq, 1.f, qs);
      load_rows<T, D>(dout, qbase, qstride, i * kTile, kTile, Tq, 1.f, dos);
      load_stats(lse, delta, (static_cast<size_t>(b) * Hq + h) * Tq,
                 i * kTile, kTile, Tq, ls, dl);
      __syncthreads();
      for (int e = tid; e < kTile * kRows; e += kThreads) {
        const int r = e / kRows, t = e % kRows;
        const int q_pos = i * kTile + r, k_pos = j0 + t;
        float p = 0.f, ds = 0.f;
        if (q_pos < Tq && k_pos < Tk && (!causal || k_pos <= q_pos)) {
          float s = 0.f, dp = 0.f;
#pragma unroll 16
          for (int c = 0; c < D; ++c) {
            s += qs[r * (D + 1) + c] * ks[t * (D + 1) + c];
            dp += dos[r * (D + 1) + c] * vs[t * (D + 1) + c];
          }
          p = expf(s * scale - ls[r]);
          ds = p * (dp - dl[r]) * scale;
        }
        ps[e] = p;
        dss[e] = ds;
      }
      __syncthreads();
      for (int r = 0; r < kTile; ++r) {
        const float pv = ps[r * kRows + row], dsv = dss[r * kRows + row];
#pragma unroll
        for (int c = 0; c < kLanes; ++c) {
          dva[c] += pv * dos[r * (D + 1) + lane + c * kRowThreads];
          dka[c] += dsv * qs[r * (D + 1) + lane + c * kRowThreads];
        }
      }
    }
  }
  if (j0 + row < Tk) {
    const size_t o =
        ((static_cast<size_t>(b) * Tk + j0 + row) * Hkv + hk) * D + lane;
#pragma unroll
    for (int c = 0; c < kLanes; ++c) {
      dk[o + c * kRowThreads] = from_f32<T>(dka[c]);
      dv[o + c * kRowThreads] = from_f32<T>(dva[c]);
    }
  }
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int Tq, int Tk, int Hq, int Hkv,
                      long long sb, long long ss, long long sh, float scale,
                      int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_words(64);
  const dim3 grid((Tq + kRows - 1) / kRows, Hq, B);
  bwd_dq_kernel<T, 64><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Tq, Tk, Hq, Hkv, sb, ss, sh, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int Tq,
                       int Tk, int Hq, int Hkv, long long sb, long long ss,
                       long long sh, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_words(64);
  const dim3 grid((Tk + kRows - 1) / kRows, Hkv, B);
  bwd_dkv_kernel<T, 64><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, Hq, Hkv, sb, ss, sh,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, dout and dq [B, Tq, Hq, D] contiguous; k, v [B, Tk, Hkv, D] with element
// strides (sb, ss, sh, 1), the same for both; lse, delta [B, Hq, Tq] float32.
// D == 64 (smollm-360m's head_dim).  Returns cudaGetLastError().
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int B, int Tq,
    int Tk, int Hq, int Hkv, int D, long long sb, long long ss, long long sh,
    float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = launch_dq<float>(q, k, v, dout, ls, dl, dq, B, Tq, Tk, Hq, Hkv, sb,
                           ss, sh, scale, causal, st);
  } else if (dtype == kDtypeBF16) {
    err = launch_dq<__nv_bfloat16>(q, k, v, dout, ls, dl, dq, B, Tq, Tk, Hq,
                                   Hkv, sb, ss, sh, scale, causal, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// As above; dk and dv [B, Tk, Hkv, D] contiguous, in k's dtype.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int Tq, int Tk, int Hq, int Hkv, int D, long long sb, long long ss,
    long long sh, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = launch_dkv<float>(q, k, v, dout, ls, dl, dk, dv, B, Tq, Tk, Hq, Hkv,
                            sb, ss, sh, scale, causal, st);
  } else if (dtype == kDtypeBF16) {
    err = launch_dkv<__nv_bfloat16>(q, k, v, dout, ls, dl, dk, dv, B, Tq, Tk,
                                    Hq, Hkv, sb, ss, sh, scale, causal, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
