// Fresh flash attention forward, the training form: queries and keys of the
// same call, query row i at absolute position i, every key valid.  Returns
// the output and the row log-sum-exp the backward rebuilds P from.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
//   (the pallas_call at line 122; body _make_kernel:69, _online_update:56),
//   bf16/fp32.
// Bound on the H100: operations at the training shape (T = 512, D = 64):
//   each (row, key) pair below the diagonal costs 4 * D flops and the inputs
//   are read once, about 128 flops per byte of q, k, v and out; a kernel on
//   CUDA cores (67 TFLOP/s fp32) is far from either roof.
// Design: the fresh form is the cached-prefill form at q_offset 0 over all
//   Tk keys, so it runs prefill_attend (attention.cuh), the tile loop of the
//   offset and paged prefill kernels, in a kernel without offset or valid-
//   length operands.  One CTA per (16 query rows, query head, batch row),
//   128 threads; KV head h / G (GQA without repeating K/V).  q and out are
//   [B, Tq, Hq, D]; k and v are read in the model layout [B, Tk, Hkv, D]
//   through their strides, with no transpose and no padding: rows past Tq
//   are masked and keys past Tk are never read, so T need not divide by the
//   tile (the reference needed a divisor block, ops.py:143).  lse is
//   [B, Hq, Tq] float32.
#include "attention.cuh"

namespace {

constexpr int kTile = 32;  // keys per tile

template <typename T, int D>
__global__ void __launch_bounds__(kPrefillThreads)
    fresh_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Tq, int Tk, int Hq, int Hkv,
                     long long sb, long long ss, long long sh, float scale,
                     int causal) {
  extern __shared__ __align__(16) float smem[];
  const int i0 = blockIdx.x * kPrefillRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const ContiguousRows rows{static_cast<size_t>(b * sb + hk * sh),
                            static_cast<size_t>(kTile * ss),
                            static_cast<size_t>(ss)};
  prefill_attend<T, D>(q, k, v, rows, Tk, kTile, 0, b, h, i0, Tq, Hq, out,
                       lse, scale, causal, smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Tq, int Tk, int Hq, int Hkv,
                   long long sb, long long ss, long long sh, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * prefill_smem_words(D, kTile);
  const dim3 grid((Tq + kPrefillRows - 1) / kPrefillRows, Hq, B);
  fresh_fwd_kernel<T, D><<<grid, kPrefillThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Tq, Tk, Hq, Hkv,
      sb, ss, sh, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q and out [B, Tq, Hq, D] contiguous; k, v [B, Tk, Hkv, D] with element
// strides (sb, ss, sh, 1), the same for both; lse [B, Hq, Tq] float32.
// D == 64 (smollm-360m's head_dim).  Returns cudaGetLastError().
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int dtype, int B, int Tq, int Tk,
                                          int Hq, int Hkv, int D, long long sb,
                                          long long ss, long long sh,
                                          float scale, int causal,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = launch<float, 64>(q, k, v, out, ls, B, Tq, Tk, Hq, Hkv, sb, ss, sh,
                            scale, causal, st);
  } else if (dtype == kDtypeBF16) {
    err = launch<__nv_bfloat16, 64>(q, k, v, out, ls, B, Tq, Tk, Hq, Hkv, sb,
                                    ss, sh, scale, causal, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
