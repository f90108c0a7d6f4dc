// Fresh flash attention forward, the training form: queries and keys of the
// same call, query row i at absolute position i, every key valid.  Returns
// the output and the row log-sum-exp the backward rebuilds P from.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
//   (the pallas_call at line 122; body _make_kernel:69, _online_update:56),
//   bf16/fp32.
// Bound on the H100: bytes at the training shape (B 8, T 512, 15/5 heads,
//   D 64, bf16, causal): q, k, v, out and lse read or written once, 21.2
//   MB, take 6.3 us at 3.35 TB/s; the 2 products of 2 * D flops per (row,
//   key) pair below the diagonal, 4.0 GFLOP, take 4.1 us at 989 TFLOP/s.
//
// Two forms, chosen by dtype (no probe, no fallback):
//
// bf16: fresh_fwd_wgmma_kernel, on the tensor cores.  One CTA is one
//   warpgroup (128 threads) and owns 64 query rows of one (query head,
//   batch row); KV head h / G (GQA without repeating K/V).  The tile loop is
//   wg::attend (wgmma.cuh) at q_offset 0 over all Tk keys, shared with the
//   cached-prefill kernel's bf16 form: S = Q·Kᵀ and O += P·V as wgmma
//   products from 128B-swizzled tiles that a two-stage cp.async ring fills,
//   the online (m, d) update in registers.  Causal: key tiles run only to
//   the diagonal and only the diagonal tile (and a ragged last tile) is
//   masked; CTAs are numbered heaviest query tile first, so the triangle's
//   long CTAs start first.  Keys at or past Tk are zero-filled without being
//   read and score -inf; query rows past Tq are zero-filled and not written,
//   so T need not be a multiple of 64.
//
// fp32: fresh_fwd_kernel, on CUDA cores: the cached-prefill form at
//   q_offset 0 over all Tk keys, prefill_attend (attention.cuh), the tile
//   loop of the offset and paged prefill kernels, in a kernel without offset
//   or valid-length operands.  One CTA per (16 query rows, query head, batch
//   row), 128 threads, fp32 accumulation throughout (the path the fp32
//   train parity holds to 1e-5).
//
// Both read q and out as [B, Tq, Hq, D] and k, v in the model layout
// [B, Tk, Hkv, D] through their strides, with no transpose and no padding;
// lse is [B, Hq, Tq] float32.
#include "attention.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTile = 32;  // keys per tile of the fp32 form

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

__global__ void __launch_bounds__(wg::kThreads)
    fresh_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int B, int Tq, int Tk,
                           int Hq, int Hkv, long long sb, long long ss,
                           long long sh, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char tiles[];
  // heaviest query tile first: blockIdx.x = (reversed tile, b, h), h fastest
  int bid = blockIdx.x;
  const int h = bid % Hq;
  bid /= Hq;
  const int b = bid % B;
  const int i0 = ((Tq + wg::kRows - 1) / wg::kRows - 1 - bid / B) * wg::kRows;
  const int hk = h / (Hq / Hkv);
  const size_t qstride = static_cast<size_t>(Hq) * wg::kD;
  const size_t q0 = static_cast<size_t>(b) * Tq * qstride + h * wg::kD;
  const wg::ContiguousKeys keys{
      ContiguousRows{static_cast<size_t>(b * sb + hk * sh),
                     static_cast<size_t>(wg::kRows * ss),
                     static_cast<size_t>(ss)}};
  wg::attend(q + q0, k, v, keys, out + q0,
             lse + (static_cast<size_t>(b) * Hq + h) * Tq, qstride, i0, Tq, 0,
             Tk, scale, causal, tiles);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int Tq, int Tk, int Hq, int Hkv,
                       long long sb, long long ss, long long sh, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * prefill_smem_words(64, kTile);
  const dim3 grid((Tq + kPrefillRows - 1) / kPrefillRows, Hq, B);
  fresh_fwd_kernel<float, 64><<<grid, kPrefillThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Tq, Tk, Hq,
      Hkv, sb, ss, sh, scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int Tq, int Tk, int Hq,
                        int Hkv, long long sb, long long ss, long long sh,
                        float scale, int causal, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((Tq + wg::kRows - 1) /
                                                wg::kRows) * B * Hq;
  fresh_fwd_wgmma_kernel<<<blocks, wg::kThreads, wg::kAttendSmem,
                           stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, B, Tq, Tk, Hq, Hkv, sb, ss, sh, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q and out [B, Tq, Hq, D] contiguous; k, v [B, Tk, Hkv, D] with element
// strides (sb, ss, sh, 1), the same for both (bf16: multiples of 8, and
// every pointer 16-byte aligned, for the 16-byte copies); lse [B, Hq, Tq]
// float32.  D == 64 (smollm-360m's head_dim).  Returns cudaGetLastError().
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
    err = launch_f32(q, k, v, out, ls, B, Tq, Tk, Hq, Hkv, sb, ss, sh, scale,
                     causal, st);
  } else if (dtype == kDtypeBF16) {
    err = launch_bf16(q, k, v, out, ls, B, Tq, Tk, Hq, Hkv, sb, ss, sh, scale,
                      causal, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of the bf16 (wgmma) kernel, in bytes.
extern "C" int flash_attention_fwd_wgmma_smem() { return wg::kAttendSmem; }
