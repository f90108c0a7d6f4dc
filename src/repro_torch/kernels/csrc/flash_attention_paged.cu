// Paged cached-prefill flash attention: a chunk of queries at absolute
// offset q_offset attends causally to the KV pages its block table names.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_paged_pallas
//   (the pallas_call at line 432; body _make_paged_kernel:274), in both
//   forms: bf16/fp32 pools (flash_attention_paged_launch, and for bf16
//   flash_attention_paged_wgmma_launch) and int8 pools with bf16 scale pages
//   (flash_attention_paged_int8_launch, the quantized body at :307-325).
// Bound on the H100: bytes at the serving path's chunk widths (2..64 query
//   rows): each live K/V position is read once per query tile for 4*D flops
//   per row, and a 64-row chunk stays under the ~295 flops/byte the tensor
//   cores need before they, not memory, bind.
// Pages are addressed through the table (PagedRows, attention.cuh: tile j
//   of a row is page table[j] of the [P, Hkv, BS, D] pool at KV head h / G),
//   only up to the last live position, so dead table entries are never
//   dereferenced and dead blocks cost nothing.  Scores are masked in
//   absolute coordinates (k_pos <= q_offset + i) and at vlen before the
//   online (m, d, acc) update; rows past Tq are masked, so Tq need not
//   divide by the tile.  The output is acc / d and lse = m + log d, or 0
//   and -inf for a row with no valid key.
//
// Three forms, chosen by the pools' dtype (no probe, no fallback):
//
// bf16: paged_wgmma_kernel, on the tensor cores, shaped as the contiguous
//   prefill's offset_wgmma_kernel: one warpgroup a CTA owns 64 query rows of
//   one (query head, batch row), heaviest query tile first, and runs the
//   fresh forward's tile loop wg::attend (wgmma.cuh) over 64-key K/V tiles
//   gathered through the table (PagedKeys: a tile spans 64 / BS pages, or
//   one more where BS does not divide 64; their table entries are staged
//   in shared memory once a tile, a tile ahead, by cp.async).  At B 1, Tq 64
//   that is 15 CTAs of one warpgroup doing wgmma products where the CUDA-core
//   form ran 60 CTAs walking one page per barrier.  At D 128 (32 CTAs for
//   mistral-nemo-12b's 32 query heads) a row is two 128-byte swizzle atoms
//   and the ring needs 81 KB of dynamic shared memory, allowed first.
//
// fp32: prefill_paged_kernel, on CUDA cores.  One CTA per (query tile of
//   BQ = 16 rows, query head, batch row), 128 threads, 8 per query row; the
//   CTA walks the logical blocks up to the last live one, min(ceil(vlen /
//   BS) - 1, (q_offset + last row) / BS) as last_live_block does in the
//   reference, loading one K and one V page into shared memory per step;
//   each thread carries its row's (m, d) and D / 8 accumulator lanes, in
//   fp32 throughout (the fp32 parity runs hold it to 1e-5).  The tile loop
//   is prefill_attend (attention.cuh), shared with the contiguous
//   cached-prefill kernel (flash_attention_offset.cu); here a tile is one
//   page.
//
// int8: prefill_paged_int8_kernel, the fp32 form's loop over int8 pools
//   (bf16 or fp32 q), each page dequantized by its scale column (scale
//   pages [P, Hkv, BS] through the same table entry) as it lands in shared
//   memory.  No serving path launches it: an int8 prefill attends over its
//   exact K/V through the contiguous kernel.
#include "attention.cuh"
#include "wgmma.cuh"

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

template <int D>
__global__ void __launch_bounds__(wg::kThreads)
    paged_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool,
                       const int* __restrict__ q_offset,
                       const int* __restrict__ vlen,
                       const int* __restrict__ tables,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int B, int Tq, int Hq,
                       int Hkv, int BS, int M, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char tiles[];
  __shared__ int staged[2 * wg::PagedKeys<D>::kSlot];
  // heaviest query tile first: blockIdx.x = (reversed tile, b, h), h fastest
  int bid = blockIdx.x;
  const int h = bid % Hq;
  bid /= Hq;
  const int b = bid % B;
  const int i0 = ((Tq + wg::kRows - 1) / wg::kRows - 1 - bid / B) * wg::kRows;
  const int hk = h / (Hq / Hkv);
  const size_t qstride = static_cast<size_t>(Hq) * D;
  const size_t q0 = static_cast<size_t>(b) * Tq * qstride + h * D;
  const size_t page = static_cast<size_t>(BS) * D;
  const wg::PagedKeys<D> keys{tables + static_cast<size_t>(b) * M, staged,
                              Hkv * page, hk * page, BS};
  wg::attend<D, D>(q + q0, k_pool, v_pool, keys, out + q0,
                   lse + (static_cast<size_t>(b) * Hq + h) * Tq, qstride,
                   qstride, i0, Tq, q_offset[b],
                   max(min(vlen[b], M * BS), 0), scale, causal, tiles);
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
  const cudaError_t err =
      allow_dynamic_smem<prefill_paged_int8_kernel<T, D>>(smem);
  if (err != cudaSuccess) return err;
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

template <int D>
cudaError_t launch_f32(const void* q, const void* k_pool, const void* v_pool,
                       const int* q_offset, const int* vlen,
                       const int* tables, void* out, float* lse, int B,
                       int Tq, int Hq, int Hkv, int BS, int M, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * prefill_smem_words(D, BS);
  const cudaError_t err =
      allow_dynamic_smem<prefill_paged_kernel<float, D>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kPrefillRows - 1) / kPrefillRows, Hq, B);
  prefill_paged_kernel<float, D><<<grid, kPrefillThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), q_offset, vlen, tables,
      static_cast<float*>(out), lse, Tq, Hq, Hkv, BS, M, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k_pool, const void* v_pool,
                        const int* q_offset, const int* vlen,
                        const int* tables, void* out, float* lse, int B,
                        int Tq, int Hq, int Hkv, int BS, int M, float scale,
                        int causal, cudaStream_t stream) {
  constexpr int kSmem = wg::attend_smem(D);
  const cudaError_t err = allow_dynamic_smem<paged_wgmma_kernel<D>>(kSmem);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((Tq + wg::kRows - 1) / wg::kRows) * B * Hq;
  paged_wgmma_kernel<D><<<blocks, wg::kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), q_offset, vlen, tables,
      static_cast<__nv_bfloat16*>(out), lse, B, Tq, Hq, Hkv, BS, M, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// q and out [B, Tq, Hq, D] contiguous; pools [P, Hkv, BS, D] contiguous;
// q_offset, vlen [B] int32; tables [B, M] int32; lse [B, Hq, Tq] float32.
// D is 64 or 128 (the instances of with_head_dim), any other D is refused.
// The fp32 form (prefill_paged_kernel, CUDA cores).  Returns
// cudaGetLastError().
extern "C" int flash_attention_paged_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* q_offset, const void* vlen, const void* tables, void* out,
    void* lse, int dtype, int B, int Tq, int Hq, int Hkv, int BS, int D, int M,
    float scale, int causal, void* stream) {
  if (dtype != kDtypeF32) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_head_dim(D, [&](auto d) {
    return launch_f32<decltype(d)::value>(
        q, k_pool, v_pool, static_cast<const int*>(q_offset),
        static_cast<const int*>(vlen), static_cast<const int*>(tables), out,
        static_cast<float*>(lse), B, Tq, Hq, Hkv, BS, M, scale, causal,
        static_cast<cudaStream_t>(stream));
  }));
}

// The bf16 form on the tensor cores (paged_wgmma_kernel): the operands of
// flash_attention_paged_launch in bf16, every pointer 16-byte aligned (the
// 16-byte copies).  D is 64 or 128.  Returns cudaGetLastError().
extern "C" int flash_attention_paged_wgmma_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* q_offset, const void* vlen, const void* tables, void* out,
    void* lse, int dtype, int B, int Tq, int Hq, int Hkv, int BS, int D, int M,
    float scale, int causal, void* stream) {
  if (dtype != kDtypeBF16) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_head_dim(D, [&](auto d) {
    return launch_bf16<decltype(d)::value>(
        q, k_pool, v_pool, static_cast<const int*>(q_offset),
        static_cast<const int*>(vlen), static_cast<const int*>(tables), out,
        static_cast<float*>(lse), B, Tq, Hq, Hkv, BS, M, scale, causal,
        static_cast<cudaStream_t>(stream));
  }));
}

// Dynamic shared memory of the bf16 (wgmma) form at head dim D, in bytes
// (its table entries' 512 bytes are static).
extern "C" int flash_attention_paged_wgmma_smem(int D) {
  return wg::attend_smem(D);
}

// The int8 form: q, out, q_offset, vlen, tables and lse as above; pools
// [P, Hkv, BS, D] int8 contiguous; scale pages [P, Hkv, BS] bf16 with
// element strides (sp, sh, st), the same for both.  D is 64 or 128.
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
  return static_cast<int>(with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (dtype == kDtypeF32)
      return launch_int8<float, kD>(q, k_pool, v_pool, k_scale, v_scale, qo,
                                    vl, tb, out, ls, B, Tq, Hq, Hkv, BS, M,
                                    sp, sh, st, scale, causal, stm);
    if (dtype == kDtypeBF16)
      return launch_int8<__nv_bfloat16, kD>(q, k_pool, v_pool, k_scale,
                                            v_scale, qo, vl, tb, out, ls, B,
                                            Tq, Hq, Hkv, BS, M, sp, sh, st,
                                            scale, causal, stm);
    return cudaErrorInvalidValue;
  }));
}
