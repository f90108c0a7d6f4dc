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
//   and lse = m + log d, or -inf for a row with no valid key (d == 0).  The
//   tile loop is prefill_attend (attention.cuh), shared with the contiguous
//   cached-prefill kernel (flash_attention_offset.cu); here a tile is one
//   page, addressed through the table.
#include "attention.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kPrefillThreads)
    prefill_paged_kernel(const T* __restrict__ q,
                         const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const int* __restrict__ q_offset,
                         const int* __restrict__ vlen,
                         const int* __restrict__ tables, T* __restrict__ out,
                         float* __restrict__ lse, int Tq, int Hq, int Hkv,
                         int BS, int M, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int i0 = blockIdx.x * kPrefillRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const PagedRows rows{tables + static_cast<size_t>(b) * M,
                       static_cast<size_t>(Hkv) * BS * D,
                       static_cast<size_t>(hk) * BS * D, D};
  prefill_attend<T, D>(q, k_pool, v_pool, rows, min(vlen[b], M * BS), BS,
                       q_offset[b], b, h, i0, Tq, Hq, out, lse, scale, causal,
                       smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* q_offset, const int* vlen, const int* tables,
                   void* out, float* lse, int B, int Tq, int Hq, int Hkv,
                   int BS, int M, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * prefill_smem_words(D, BS);
  const dim3 grid((Tq + kPrefillRows - 1) / kPrefillRows, Hq, B);
  prefill_paged_kernel<T, D><<<grid, kPrefillThreads, smem, stream>>>(
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
