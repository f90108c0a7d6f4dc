// Cached-prefill flash attention over a contiguous KV cache: a chunk of
// queries at absolute offset q_offset[b] attends causally to positions
// [0, vlen[b]) of its row's cache.
//
// Replaces: src/repro/kernels/flash_attention.py,
//   flash_attention_offset_pallas (the pallas_call at line 260; body
//   _make_offset_kernel:147), bf16/fp32.
// Bound on the H100: bytes at the serving path's chunk widths (1..64 query
//   rows) and the lockstep prefill's 256: each live K/V position is read
//   once per query tile for 4*D flops per row; a chunk stays under the ~295
//   flops/byte the tensor cores need before they, not memory, bind.
// Design: one CTA per (query tile of 16 rows, query head, batch row), 128
//   threads, 8 per query row; KV head h / G.  q, k and v stay in the model
//   layout ([B, Tq, Hq, D] and [B, Tk, Hkv, D], the cache read through the
//   strides the wrapper passes), so nothing is transposed or padded: the
//   reference's ops._flash_offset padded the cache to a tile multiple (a copy
//   of the whole cache per call); here positions at or past vlen are neither
//   read nor scored, and rows past Tq are masked, so Tq need not divide by
//   the tile.  vlen is clamped to Tk.  The tile loop stops at the last live
//   tile, min(ceil(vlen / kTile), (q_offset + last row) / kTile + 1), as
//   last_live_tile does in the reference.  Scores are masked in absolute
//   coordinates (k_pos <= q_offset + i) and at vlen before the online
//   (m, d, acc) update; a row with no valid key gets lse -inf and output 0.
//   The tile loop is prefill_attend (attention.cuh), shared with the paged
//   prefill kernel.
#include "attention.cuh"

namespace {

constexpr int kTile = 32;  // cache positions per tile

template <typename T, int D>
__global__ void __launch_bounds__(kPrefillThreads)
    prefill_offset_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ q_offset,
                          const int* __restrict__ vlen, T* __restrict__ out,
                          float* __restrict__ lse, int Tq, int Hq, int Hkv,
                          int Tk, long long sb, long long ss, long long sh,
                          float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int i0 = blockIdx.x * kPrefillRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const ContiguousRows rows{static_cast<size_t>(b * sb + hk * sh),
                            static_cast<size_t>(kTile * ss),
                            static_cast<size_t>(ss)};
  prefill_attend<T, D>(q, k, v, rows, max(min(vlen[b], Tk), 0), kTile,
                       q_offset[b], b, h, i0, Tq, Hq, out, lse, scale, causal,
                       smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_offset, const int* vlen, void* out, float* lse,
                   int B, int Tq, int Hq, int Hkv, int Tk, long long sb,
                   long long ss, long long sh, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * prefill_smem_words(D, kTile);
  const dim3 grid((Tq + kPrefillRows - 1) / kPrefillRows, Hq, B);
  prefill_offset_kernel<T, D><<<grid, kPrefillThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_offset, vlen, static_cast<T*>(out), lse, Tq,
      Hq, Hkv, Tk, sb, ss, sh, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const int* q_offset, const int* vlen, void* out,
                     float* lse, int B, int Tq, int Hq, int Hkv, int Tk,
                     long long sb, long long ss, long long sh, float scale,
                     int causal, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, q_offset, vlen, out, lse, B, Tq, Hq, Hkv, Tk,
                         sb, ss, sh, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q and out [B, Tq, Hq, D] contiguous; k, v [B, Tk, Hkv, D] with element
// strides (sb, ss, sh, 1), the same for both; q_offset, vlen [B] int32;
// lse [B, Hq, Tq] float32.  D == 64 (smollm-360m's head_dim).  Returns
// cudaGetLastError().
extern "C" int flash_attention_offset_launch(
    const void* q, const void* k, const void* v, const void* q_offset,
    const void* vlen, void* out, void* lse, int dtype, int B, int Tq, int Hq,
    int Hkv, int Tk, int D, long long sb, long long ss, long long sh,
    float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(q_offset);
  const int* vl = static_cast<const int*>(vlen);
  float* ls = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = launch_d<float>(D, q, k, v, qo, vl, out, ls, B, Tq, Hq, Hkv, Tk, sb,
                          ss, sh, scale, causal, st);
  } else if (dtype == kDtypeBF16) {
    err = launch_d<__nv_bfloat16>(D, q, k, v, qo, vl, out, ls, B, Tq, Hq, Hkv,
                                  Tk, sb, ss, sh, scale, causal, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
