// Paged cached-prefill flash attention: a chunk of queries at absolute
// offset q_offset attends causally to the KV pages its block table names.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_paged_pallas
//   (the pallas_call at line 432; body _make_paged_kernel:274), in both
//   forms: bf16/fp32 pools (flash_attention_paged_launch) and int8 pools
//   with bf16 scale pages (flash_attention_paged_int8_launch, the quantized
//   body at :307-325).
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
//   page, addressed through the table.  The int8 form runs the same loop
//   over int8 pools, each page dequantized by its scale column (scale pages
//   [P, Hkv, BS] through the same table entry) as it lands in shared memory.
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

// The int8 form: int8 pools; scale pages [P, Hkv, BS] bf16 with element
// strides (sp, sh, st).
template <typename T, int D>
__global__ void __launch_bounds__(kPrefillThreads)
    prefill_paged_int8_kernel(
        const T* __restrict__ q, const signed char* __restrict__ k_pool,
        const signed char* __restrict__ v_pool,
        const __nv_bfloat16* __restrict__ k_scale,
        const __nv_bfloat16* __restrict__ v_scale,
        const int* __restrict__ q_offset, const int* __restrict__ vlen,
        const int* __restrict__ tables, T* __restrict__ out,
        float* __restrict__ lse, int Tq, int Hq, int Hkv, int BS, int M,
        long long sp, long long sh, long long st, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int i0 = blockIdx.x * kPrefillRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int* table = tables + static_cast<size_t>(b) * M;
  const PagedRows rows{table, static_cast<size_t>(Hkv) * BS * D,
                       static_cast<size_t>(hk) * BS * D, D};
  const Scales<PagedRows> sc{
      k_scale, v_scale,
      PagedRows{table, static_cast<size_t>(sp), static_cast<size_t>(hk * sh),
                static_cast<size_t>(st)}};
  prefill_attend<T, D>(q, k_pool, v_pool, rows, min(vlen[b], M * BS), BS,
                       q_offset[b], b, h, i0, Tq, Hq, out, lse, scale, causal,
                       smem, sc);
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

template <typename T, int D>
cudaError_t launch_int8(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale,
                        const int* q_offset, const int* vlen,
                        const int* tables, void* out, float* lse, int B,
                        int Tq, int Hq, int Hkv, int BS, int M, long long sp,
                        long long sh, long long st, float scale, int causal,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * prefill_smem_words(D, BS);
  const dim3 grid((Tq + kPrefillRows - 1) / kPrefillRows, Hq, B);
  prefill_paged_int8_kernel<T, D><<<grid, kPrefillThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const signed char*>(k_pool),
      static_cast<const signed char*>(v_pool),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), q_offset, vlen, tables,
      static_cast<T*>(out), lse, Tq, Hq, Hkv, BS, M, sp, sh, st, scale,
      causal);
  return cudaGetLastError();
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

// The int8 form: q, out, q_offset, vlen, tables and lse as above; pools
// [P, Hkv, BS, D] int8 contiguous; scale pages [P, Hkv, BS] bf16 with
// element strides (sp, sh, st), the same for both.  D == 64.
extern "C" int flash_attention_paged_int8_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* q_offset,
    const void* vlen, const void* tables, void* out, void* lse, int dtype,
    int B, int Tq, int Hq, int Hkv, int BS, int D, int M, long long sp,
    long long sh, long long st, float scale, int causal, void* stream) {
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(q_offset);
  const int* vl = static_cast<const int*>(vlen);
  const int* tb = static_cast<const int*>(tables);
  float* ls = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64 && dtype == kDtypeF32) {
    err = launch_int8<float, 64>(q, k_pool, v_pool, k_scale, v_scale, qo, vl,
                                 tb, out, ls, B, Tq, Hq, Hkv, BS, M, sp, sh,
                                 st, scale, causal, stm);
  } else if (D == 64 && dtype == kDtypeBF16) {
    err = launch_int8<__nv_bfloat16, 64>(q, k_pool, v_pool, k_scale, v_scale,
                                         qo, vl, tb, out, ls, B, Tq, Hq, Hkv,
                                         BS, M, sp, sh, st, scale, causal,
                                         stm);
  }
  return static_cast<int>(err);
}
