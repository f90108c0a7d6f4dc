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
//   ~295 flops/byte where the tensor cores would bind, so the kernels run on
//   the CUDA cores.  At serving sizes (B 8, 5 KV heads, ~330 positions) the
//   bytes take well under a microsecond: what costs is latency, so the
//   design keeps the card full and every load in flight.
// Design: the Pallas kernel walks the pages as a sequential grid axis; here
//   that axis becomes parallel CTAs whose partials the paper's ⊕ merges.
//   The wrapper's planner (kernels/flash_decode.py, decode_plan) cuts the
//   key range [0, M * BS) into splits of a whole number of pages, enough to
//   fill the SMs twice where the cache is long enough, never under 32
//   positions.  decode_paged_split_kernel runs one CTA of 128 threads per
//   (split, KV head, batch row) (attention.cuh, decode_split): it reads only
//   the table entries of its own live pages, j < ceil(vlen / BS), issues
//   every K/V row of its split as 16-byte cp.async copies at once, scores
//   the G query heads of the group against each position (the G heads share
//   every page, so the cache is read once per group), takes one expf per
//   (head, position), and writes its partial (m, d, acc) to the workspace;
//   a CTA whose split starts at or past vlen exits without reading.  The
//   last live split of a (row, head) to finish, found by a ticket counter
//   that it then sets back to 0, ⊕-merges the row's partials in split order
//   and writes acc / d, so the result does not depend on which CTA merges
//   and a call is one launch.  Nothing at or past vlen is read, and
//   vlen == 0 gives 0.  Idle rows decode with vlen = 1 against the sentinel
//   block 0; their output is discarded.
// int8 form: the same kernels over int8 pools; each position's K and V are
//   dequantized in registers as float(int8) * float(bf16 scale), the scale
//   pages [P, Hkv, BS] read through the same table entry (attention.cuh,
//   Scales).  The cache streams at 1 byte per value plus 2 per (position,
//   head) scale, about half the bf16 form's bytes.
#include "attention.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads) decode_paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ vlen, int Hq, int Hkv, int BS, int M, int split,
    int splits, float scale, float* __restrict__ part_acc,
    float2* __restrict__ part_md, int* __restrict__ tickets,
    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char decode_smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const PagedRows rows{tables + static_cast<size_t>(b) * M,
                       static_cast<size_t>(Hkv) * BS * D,
                       static_cast<size_t>(h) * BS * D, D};
  const size_t pair = static_cast<size_t>(b) * Hkv + h;
  decode_split<T, D>(q, k_pool, v_pool, rows, BS,
                     min(max(vlen[b], 0), M * BS), split,
                     (static_cast<size_t>(b) * Hq + h * G) * D, G, scale,
                     part_acc + pair * splits * G * D,
                     part_md + pair * splits * G, tickets + pair, out,
                     decode_smem);
}

// The int8 form: k_pool / v_pool int8; scale pages [P, Hkv, BS] bf16 with
// element strides (sp, sh, st).
template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_paged_int8_split_kernel(
        const T* __restrict__ q, const signed char* __restrict__ k_pool,
        const signed char* __restrict__ v_pool,
        const __nv_bfloat16* __restrict__ k_scale,
        const __nv_bfloat16* __restrict__ v_scale,
        const int* __restrict__ tables, const int* __restrict__ vlen, int Hq,
        int Hkv, int BS, int M, int split, int splits, long long sp,
        long long sh, long long st, float scale, float* __restrict__ part_acc,
        float2* __restrict__ part_md, int* __restrict__ tickets,
        T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char decode_smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int* table = tables + static_cast<size_t>(b) * M;
  const PagedRows rows{table, static_cast<size_t>(Hkv) * BS * D,
                       static_cast<size_t>(h) * BS * D, D};
  const Scales<PagedRows> sc{
      k_scale, v_scale,
      PagedRows{table, static_cast<size_t>(sp), static_cast<size_t>(h * sh),
                static_cast<size_t>(st)}};
  const size_t pair = static_cast<size_t>(b) * Hkv + h;
  decode_split<T, D>(q, k_pool, v_pool, rows, BS,
                     min(max(vlen[b], 0), M * BS), split,
                     (static_cast<size_t>(b) * Hq + h * G) * D, G, scale,
                     part_acc + pair * splits * G * D,
                     part_md + pair * splits * G, tickets + pair, out,
                     decode_smem, sc);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* vlen, void* out, void* work,
                   void* tickets, int B, int Hq, int Hkv, int BS, int D,
                   int M, int split, int splits, float scale,
                   cudaStream_t stream) {
  if (D != 64 || Hkv <= 0) return cudaErrorInvalidValue;
  const size_t smem = decode_split_smem(Hq / Hkv, 64, sizeof(T), split,
                                        false);
  return launch_decode<T>(
      decode_paged_split_kernel<T, 64>, smem, B, Hq, Hkv, 64, split, splits,
      out, work, tickets, stream, static_cast<const T*>(q),
      static_cast<const T*>(k_pool), static_cast<const T*>(v_pool), tables,
      vlen, Hq, Hkv, BS, M, split, splits, scale);
}

template <typename T>
cudaError_t launch_int8(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale,
                        const int* tables, const int* vlen, void* out,
                        void* work, void* tickets, int B, int Hq, int Hkv,
                        int BS, int D, int M, int split, int splits,
                        long long sp,
                        long long sh, long long st, float scale,
                        cudaStream_t stream) {
  if (D != 64 || Hkv <= 0) return cudaErrorInvalidValue;
  const size_t smem = decode_split_smem(Hq / Hkv, 64, 1, split, true);
  return launch_decode<T>(
      decode_paged_int8_split_kernel<T, 64>, smem, B, Hq, Hkv, 64, split,
      splits, out, work, tickets, stream, static_cast<const T*>(q),
      static_cast<const signed char*>(k_pool),
      static_cast<const signed char*>(v_pool),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), tables, vlen, Hq, Hkv, BS,
      M, split, splits, sp, sh, st, scale);
}

}  // namespace

// q [B, Hq, D] and out [B, Hq, D] contiguous; pools [P, Hkv, BS, D]
// contiguous and 16-byte aligned; tables [B, M] int32; vlen [B] int32;
// work: B * Hkv * splits * G * (D + 2) floats, G = Hq / Hkv <= 8; tickets:
// B * Hkv ints, 0 on entry (and left 0).  Splits of `split` positions (a
// multiple of BS), splits * split >= M * BS.  D == 64 (smollm-360m's
// head_dim).  One launch; returns cudaGetLastError().
extern "C" int flash_decode_paged_launch(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* tables, const void* vlen,
                                         void* out, void* work, void* tickets,
                                         int dtype, int B, int Hq, int Hkv,
                                         int BS, int D, int M, int split,
                                         int splits, float scale,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* vl = static_cast<const int*>(vlen);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kDtypeF32) {
    err = launch<float>(q, k_pool, v_pool, tb, vl, out, work, tickets, B, Hq,
                        Hkv, BS, D, M, split, splits, scale, st);
  } else if (dtype == kDtypeBF16) {
    err = launch<__nv_bfloat16>(q, k_pool, v_pool, tb, vl, out, work, tickets,
                                B, Hq, Hkv, BS, D, M, split, splits, scale,
                                st);
  }
  return static_cast<int>(err);
}

// The int8 form: q and out as above (float or bf16, `dtype`); pools
// [P, Hkv, BS, D] int8 contiguous; scale pages [P, Hkv, BS] bf16 with
// element strides (sp, sh, st), the same for both.  D == 64.
extern "C" int flash_decode_paged_int8_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* vlen, void* out, void* work, void* tickets, int dtype, int B,
    int Hq, int Hkv, int BS, int D, int M, int split, int splits,
    long long sp, long long sh, long long st, float scale, void* stream) {
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* vl = static_cast<const int*>(vlen);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kDtypeF32) {
    err = launch_int8<float>(q, k_pool, v_pool, k_scale, v_scale, tb, vl, out,
                             work, tickets, B, Hq, Hkv, BS, D, M, split,
                             splits, sp, sh, st, scale, stm);
  } else if (dtype == kDtypeBF16) {
    err = launch_int8<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale, tb,
                                     vl, out, work, tickets, B, Hq, Hkv, BS,
                                     D, M, split, splits, sp, sh, st, scale,
                                     stm);
  }
  return static_cast<int>(err);
}
