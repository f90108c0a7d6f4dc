// Paged cached-prefill flash attention: a chunk of queries at absolute
// offset q_offset attends causally to the KV pages its block table names.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_paged_pallas
//   (the pallas_call at line 432; body _make_paged_kernel:274), bf16/fp32
//   form.
// Bound on the H100: bytes at the serving path's chunk widths (2..64 query
//   rows): each live K/V position is read once per query tile for 4*D flops
//   per row, and a 64-row chunk stays under the ~295 flops/byte the tensor
//   cores need before they, not memory, bind.
// Design: one CTA per (query tile of BQ = 16 rows, query head, batch row),
//   128 threads, 8 per query row.  Rows past Tq are masked, so Tq need not
//   divide by BQ.  The CTA walks the logical blocks up to the last live one,
//   min(ceil(vlen / BS) - 1, (q_offset + last row) / BS) as last_live_block
//   does in the reference, loading one K and one V page (contiguous BS x D in
//   the [P, Hkv, BS, D] pool, KV head h / G) into shared memory per step, so
//   dead table entries are never dereferenced and dead blocks cost nothing.
//   Scores are masked in absolute coordinates (k_pos <= q_offset + i) and at
//   vlen before the online (m, d, acc) update; each thread carries its row's
//   (m, d) and D / 8 accumulator lanes.  The output is acc / max(d, 1e-30)
//   and lse = m + log d, or -inf for a row with no valid key (d == 0).
#include "common.cuh"

namespace {

constexpr int kBQ = 16;
constexpr int kThreads = 128;
constexpr int kRowThreads = kThreads / kBQ;  // 8

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    prefill_paged_kernel(const T* __restrict__ q,
                         const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const int* __restrict__ q_offset,
                         const int* __restrict__ vlen,
                         const int* __restrict__ tables, T* __restrict__ out,
                         float* __restrict__ lse, int Tq, int Hq, int Hkv,
                         int BS, int M, float scale, int causal) {
  constexpr int kLanes = D / kRowThreads;  // accumulator lanes per thread
  extern __shared__ __align__(16) float smem[];
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, hk = h / G;
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads, lane = tid % kRowThreads;
  float* qs = smem;                      // [BQ, D + 1], pre-scaled
  float* ks = qs + kBQ * (D + 1);        // [BS, D + 1]
  float* vs = ks + BS * (D + 1);         // [BS, D]
  float* ss = vs + BS * D;               // [BQ, BS] scores

  // q and out keep the model layout [B, Tq, Hq, D]
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    float v = 0.f;
    if (i0 + r < Tq)
      v = to_f32(q[((static_cast<size_t>(b) * Tq + i0 + r) * Hq + h) * D + c]) *
          scale;
    qs[r * (D + 1) + c] = v;
  }
  const int L = vlen[b], qo = q_offset[b];
  const int last_row = min(i0 + kBQ, Tq) - 1;
  int nb = (L + BS - 1) / BS;
  if (causal) nb = min(nb, (qo + last_row) / BS + 1);
  nb = min(nb, M);

  float m = REPRO_NEG_INF, d = 0.f;
  float acc[kLanes];
#pragma unroll
  for (int c = 0; c < kLanes; ++c) acc[c] = 0.f;

  for (int j = 0; j < nb; ++j) {
    const size_t page =
        (static_cast<size_t>(tables[static_cast<size_t>(b) * M + j]) * Hkv +
         hk) * BS * D;
    __syncthreads();  // previous page consumed (and qs written, at j == 0)
    for (int e = tid; e < BS * D; e += kThreads) {
      const int t = e / D, c = e % D;
      ks[t * (D + 1) + c] = to_f32(k_pool[page + e]);
      vs[e] = to_f32(v_pool[page + e]);
    }
    __syncthreads();
    for (int e = tid; e < kBQ * BS; e += kThreads) {
      const int r = e / BS, t = e % BS;
      const int k_pos = j * BS + t, q_pos = qo + i0 + r;
      float s = REPRO_NEG_INF;
      if (i0 + r < Tq && k_pos < L && (!causal || k_pos <= q_pos)) {
        s = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c)
          s += qs[r * (D + 1) + c] * ks[t * (D + 1) + c];
      }
      ss[e] = s;
    }
    __syncthreads();
    // one ⊕ step of Algorithm 3 for this thread's row
    float mb = REPRO_NEG_INF;
    for (int t = 0; t < BS; ++t) mb = fmaxf(mb, ss[row * BS + t]);
    const float mn = fmaxf(m, mb);
    const float alpha = rescale(m, mn);
    float ds = 0.f;
#pragma unroll
    for (int c = 0; c < kLanes; ++c) acc[c] *= alpha;
    for (int t = 0; t < BS; ++t) {
      const float s = ss[row * BS + t];
      const float p = s == REPRO_NEG_INF ? 0.f : expf(s - mn);
      ds += p;
#pragma unroll
      for (int c = 0; c < kLanes; ++c)
        acc[c] += p * vs[t * D + lane + c * kRowThreads];
    }
    d = d * alpha + ds;
    m = mn;
  }

  const int i = i0 + row;
  if (i < Tq) {
    const float inv = 1.f / fmaxf(d, 1e-30f);
    T* o = out + ((static_cast<size_t>(b) * Tq + i) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < kLanes; ++c)
      o[lane + c * kRowThreads] = from_f32<T>(acc[c] * inv);
    if (lane == 0)
      lse[(static_cast<size_t>(b) * Hq + h) * Tq + i] =
          d > 0.f ? m + logf(fmaxf(d, 1e-30f)) : REPRO_NEG_INF;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* q_offset, const int* vlen, const int* tables,
                   void* out, float* lse, int B, int Tq, int Hq, int Hkv,
                   int BS, int M, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * (D + 1) + BS * (D + 1) + BS * D + kBQ * BS);
  const dim3 grid((Tq + kBQ - 1) / kBQ, Hq, B);
  prefill_paged_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), q_offset, vlen, tables,
      static_cast<T*>(out), lse, Tq, Hq, Hkv, BS, M, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k_pool,
                     const void* v_pool, const int* q_offset, const int* vlen,
                     const int* tables, void* out, float* lse, int B, int Tq,
                     int Hq, int Hkv, int BS, int M, float scale, int causal,
                     cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k_pool, v_pool, q_offset, vlen, tables, out, lse,
                         B, Tq, Hq, Hkv, BS, M, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q and out [B, Tq, Hq, D] contiguous; pools [P, Hkv, BS, D] contiguous;
// q_offset, vlen [B] int32; tables [B, M] int32; lse [B, Hq, Tq] float32.
// D == 64 (smollm-360m's head_dim).  Returns cudaGetLastError().
extern "C" int flash_attention_paged_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* q_offset, const void* vlen, const void* tables, void* out,
    void* lse, int dtype, int B, int Tq, int Hq, int Hkv, int BS, int D, int M,
    float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(q_offset);
  const int* vl = static_cast<const int*>(vlen);
  const int* tb = static_cast<const int*>(tables);
  float* ls = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = launch_d<float>(D, q, k_pool, v_pool, qo, vl, tb, out, ls, B, Tq, Hq,
                          Hkv, BS, M, scale, causal, st);
  } else if (dtype == kDtypeBF16) {
    err = launch_d<__nv_bfloat16>(D, q, k_pool, v_pool, qo, vl, tb, out, ls, B,
                                  Tq, Hq, Hkv, BS, M, scale, causal, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
