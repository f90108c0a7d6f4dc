// Paged single-token decode attention: one query token per row against the
// KV pages its block table names, with the paper's online (m, d) carry.
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode_paged_pallas (the
//   pallas_call at line 245; body _make_paged_kernel:113), bf16/fp32 form.
// Bound on the H100: bytes.  Each valid cache position is read once per KV
//   head (K and V, D values each) for ~4*G flops per value, far below the
//   ~295 flops/byte where the tensor cores would bind.
// Design: one CTA per (kv head, batch row), G*D threads.  The G query heads
//   of a GQA group share every K/V page: the CTA loads one page of K and V
//   (BS x D, contiguous in the [P, Hkv, BS, D] pool) into shared memory and
//   all G heads score against it, so the cache is read once per group, not
//   once per query head.  The loop walks only the live logical blocks
//   j < ceil(vlen / BS), reading tables[b, j] for those and never
//   dereferencing dead entries; columns at or past vlen are masked to -inf
//   before the (m, d, acc) update, which is exact.  Thread (g, dd) owns one
//   output element and carries its row's (m, d) redundantly with the other
//   threads of head g, so no cross-thread reduction is needed at the end.
//   Idle rows decode with vlen = 1 against the sentinel block 0; they run and
//   their output is discarded by the caller.
#include "common.cuh"

namespace {

template <typename T, int D>
__global__ void decode_paged_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pool,
                                    const T* __restrict__ v_pool,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ vlen,
                                    T* __restrict__ out, int Hq, int Hkv,
                                    int BS, int M, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, nthr = blockDim.x;  // nthr == G * D
  const int g = tid / D, dd = tid % D;
  float* qs = smem;                      // [G, D], pre-scaled
  float* ks = qs + G * D;                // [BS, D + 1] (padded rows)
  float* vs = ks + BS * (D + 1);         // [BS, D]
  float* ss = vs + BS * D;               // [G, BS] scores

  const size_t qrow = (static_cast<size_t>(b) * Hq + h * G + g) * D + dd;
  qs[tid] = to_f32(q[qrow]) * scale;
  const int L = vlen[b];
  const int nb = min((L + BS - 1) / BS, M);

  float m = REPRO_NEG_INF, d = 0.f, acc = 0.f;
  for (int j = 0; j < nb; ++j) {
    const size_t page =
        (static_cast<size_t>(tables[static_cast<size_t>(b) * M + j]) * Hkv + h) *
        BS * D;
    __syncthreads();  // the previous page is no longer read
    for (int e = tid; e < BS * D; e += nthr) {
      const int t = e / D, c = e % D;
      ks[t * (D + 1) + c] = to_f32(k_pool[page + e]);
      vs[e] = to_f32(v_pool[page + e]);
    }
    __syncthreads();
    for (int e = tid; e < G * BS; e += nthr) {
      const int gg = e / BS, t = e % BS;
      float s = REPRO_NEG_INF;
      if (j * BS + t < L) {
        s = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) s += qs[gg * D + c] * ks[t * (D + 1) + c];
      }
      ss[e] = s;
    }
    __syncthreads();
    // one ⊕ step of Algorithm 3 over this page, for head g, dim dd
    float mb = REPRO_NEG_INF;
    for (int t = 0; t < BS; ++t) mb = fmaxf(mb, ss[g * BS + t]);
    const float mn = fmaxf(m, mb);
    const float alpha = rescale(m, mn);
    float ds = 0.f, av = 0.f;
    for (int t = 0; t < BS; ++t) {
      const float s = ss[g * BS + t];
      const float p = s == REPRO_NEG_INF ? 0.f : expf(s - mn);
      ds += p;
      av += p * vs[t * D + dd];
    }
    d = d * alpha + ds;
    acc = acc * alpha + av;
    m = mn;
  }
  out[qrow] = from_f32<T>(acc / fmaxf(d, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* vlen, void* out, int B,
                   int Hq, int Hkv, int BS, int M, float scale,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * (G * D + BS * (D + 1) + BS * D + G * BS);
  decode_paged_kernel<T, D><<<dim3(Hkv, B), G * D, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, vlen, static_cast<T*>(out), Hq,
      Hkv, BS, M, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k_pool,
                     const void* v_pool, const int* tables, const int* vlen,
                     void* out, int B, int Hq, int Hkv, int BS, int M,
                     float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k_pool, v_pool, tables, vlen, out, B, Hq, Hkv, BS,
                         M, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hq, D] and out [B, Hq, D] contiguous; pools [P, Hkv, BS, D]
// contiguous; tables [B, M] int32; vlen [B] int32.  D == 64 (smollm-360m's
// head_dim), (Hq / Hkv) * D <= 1024.  Returns cudaGetLastError().
extern "C" int flash_decode_paged_launch(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* tables, const void* vlen,
                                         void* out, int dtype, int B, int Hq,
                                         int Hkv, int BS, int D, int M,
                                         float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* vl = static_cast<const int*>(vlen);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = launch_d<float>(D, q, k_pool, v_pool, tb, vl, out, B, Hq, Hkv, BS, M,
                          scale, st);
  } else if (dtype == kDtypeBF16) {
    err = launch_d<__nv_bfloat16>(D, q, k_pool, v_pool, tb, vl, out, B, Hq,
                                  Hkv, BS, M, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
