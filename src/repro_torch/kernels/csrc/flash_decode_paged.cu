// Paged single-token decode attention: one query token per row against the
// KV pages its block table names, with the paper's online (m, d) carry.
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode_paged_pallas (the
//   pallas_call at line 245; body _make_paged_kernel:113), in both forms:
//   bf16/fp32 pools (flash_decode_paged_launch) and int8 pools with bf16
//   scale pages (flash_decode_paged_int8_launch, the quantized body at
//   :137-156).
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
//   their output is discarded by the caller.  The tile loop is
//   decode_attend (attention.cuh), shared with the contiguous decode kernel
//   (flash_decode.cu); here a tile is one page, addressed through the table.
// int8 form: the same loop over int8 pools, each page's K and V dequantized
//   as it lands in shared memory by its scale column, scale pages
//   [P, Hkv, BS] read through the same table entry (attention.cuh, Scales).
//   The cache streams at 1 byte per value plus 2 per (position, head)
//   scale, about half the bf16 form's bytes.
#include "attention.cuh"

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
  const PagedRows rows{tables + static_cast<size_t>(b) * M,
                       static_cast<size_t>(Hkv) * BS * D,
                       static_cast<size_t>(h) * BS * D, D};
  decode_attend<T, D>(q, k_pool, v_pool, rows, min(vlen[b], M * BS), BS, out,
                      (static_cast<size_t>(b) * Hq + h * G) * D, G, scale,
                      smem);
}

// The int8 form: k_pool / v_pool int8; scale pages [P, Hkv, BS] bf16 with
// element strides (sp, sh, st).
template <typename T, int D>
__global__ void decode_paged_int8_kernel(
    const T* __restrict__ q, const signed char* __restrict__ k_pool,
    const signed char* __restrict__ v_pool,
    const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ vlen, T* __restrict__ out, int Hq, int Hkv,
    int BS, int M, long long sp, long long sh, long long st, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int* table = tables + static_cast<size_t>(b) * M;
  const PagedRows rows{table, static_cast<size_t>(Hkv) * BS * D,
                       static_cast<size_t>(h) * BS * D, D};
  const Scales<PagedRows> sc{
      k_scale, v_scale,
      PagedRows{table, static_cast<size_t>(sp), static_cast<size_t>(h * sh),
                static_cast<size_t>(st)}};
  decode_attend<T, D>(q, k_pool, v_pool, rows, min(vlen[b], M * BS), BS, out,
                      (static_cast<size_t>(b) * Hq + h * G) * D, G, scale,
                      smem, sc);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* vlen, void* out, int B,
                   int Hq, int Hkv, int BS, int M, float scale,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * decode_smem_words(G, D, BS);
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

template <typename T, int D>
cudaError_t launch_int8(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale,
                        const int* tables, const int* vlen, void* out, int B,
                        int Hq, int Hkv, int BS, int M, long long sp,
                        long long sh, long long st, float scale,
                        cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * decode_smem_words(G, D, BS);
  decode_paged_int8_kernel<T, D><<<dim3(Hkv, B), G * D, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const signed char*>(k_pool),
      static_cast<const signed char*>(v_pool),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), tables, vlen,
      static_cast<T*>(out), Hq, Hkv, BS, M, sp, sh, st, scale);
  return cudaGetLastError();
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

// The int8 form: q and out as above (float or bf16, `dtype`); pools
// [P, Hkv, BS, D] int8 contiguous; scale pages [P, Hkv, BS] bf16 with
// element strides (sp, sh, st), the same for both.  D == 64.
extern "C" int flash_decode_paged_int8_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* vlen, void* out, int dtype, int B, int Hq, int Hkv, int BS,
    int D, int M, long long sp, long long sh, long long st, float scale,
    void* stream) {
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* vl = static_cast<const int*>(vlen);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64 && dtype == kDtypeF32) {
    err = launch_int8<float, 64>(q, k_pool, v_pool, k_scale, v_scale, tb, vl,
                                 out, B, Hq, Hkv, BS, M, sp, sh, st, scale,
                                 stm);
  } else if (D == 64 && dtype == kDtypeBF16) {
    err = launch_int8<__nv_bfloat16, 64>(q, k_pool, v_pool, k_scale, v_scale,
                                         tb, vl, out, B, Hq, Hkv, BS, M, sp,
                                         sh, st, scale, stm);
  }
  return static_cast<int>(err);
}
