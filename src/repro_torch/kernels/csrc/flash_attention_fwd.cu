// Fresh flash attention forward, the training form: queries and keys of the
// same call, query row i at absolute position i, every key valid.  Returns
// the output and the row log-sum-exp the backward rebuilds P from.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
//   (the pallas_call at line 122; body _make_kernel:69, _online_update:56),
//   bf16/fp32.
// Bound on the H100: bytes at smollm-360m's training shape (B 8, T 512,
//   15/5 heads, D 64, bf16, causal): q, k, v, out and lse read or written
//   once, 21.2 MB, take 6.3 us at 3.35 TB/s; the 2 products of 2 * D flops
//   per (row, key) pair below the diagonal, 4.0 GFLOP, take 4.1 us at 989
//   TFLOP/s.  At mistral-nemo-12b's (32/8 heads, D 128) the bytes are 84.4
//   MB (25.2 us) and the flops 17.2 GFLOP (17.4 us): bytes again.  At
//   minicpm3-4b's (40/40 heads, Dqk 96, Dv 64) 105.5 MB (31.5 us) against
//   13.4 GFLOP (13.6 us): bytes.
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
//   so T need not be a multiple of 64.  At D 128 a row is two 128-byte
//   swizzle atoms and the ring needs 81 KB of dynamic shared memory (41 KB
//   at D 64), which the launch allows first.  MLA's decompressed form
//   (Dqk 96, Dv 64): Q and K tiles are an atom column and half of one
//   (wgmma.cuh), S contracts over six k-steps, V and O are one atom column
//   as at D 64, and V is read through strides of its own (at equal widths it
//   shares K's, one address for both copies); 65 KB.
//
// fp32: fresh_fwd_kernel, on CUDA cores: the cached-prefill form at
//   q_offset 0 over all Tk keys, prefill_attend (attention.cuh), the tile
//   loop of the offset and paged prefill kernels, in a kernel without offset
//   or valid-length operands.  One CTA per (16 query rows, query head, batch
//   row), 128 threads, fp32 accumulation throughout (the path the fp32
//   train parity holds to 1e-5).
//
// Head dims (Dqk, Dv): (64, 64), (128, 128) and (96, 64) (common.cuh,
// with_head_dims).  Both forms read q as [B, Tq, Hq, Dqk], write out as
// [B, Tq, Hq, Dv], and read k [B, Tk, Hkv, Dqk] and v [B, Tk, Hkv, Dv] in
// the model layout, each through its own strides, with no transpose and no
// padding; lse is [B, Hq, Tq] float32.
#include "attention.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTile = 32;  // keys per tile of the fp32 form

template <typename T, int Dqk, int Dv>
__global__ void __launch_bounds__(kPrefillThreads)
    fresh_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Tq, int Tk, int Hq, int Hkv,
                     KVStrides st, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int i0 = blockIdx.x * kPrefillRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const ContiguousRows krows{static_cast<size_t>(b * st.sb + hk * st.sh),
                             static_cast<size_t>(kTile * st.ss),
                             static_cast<size_t>(st.ss)};
  const ContiguousRows vrows{static_cast<size_t>(b * st.vsb + hk * st.vsh),
                             static_cast<size_t>(kTile * st.vss),
                             static_cast<size_t>(st.vss)};
  prefill_attend<T, Dqk, T, ContiguousRows, NoScales, Dv, ContiguousRows>(
      q, k, v, krows, Tk, kTile, 0, b, h, i0, Tq, Hq, out, lse, scale, causal,
      smem, NoScales(), vrows);
}

template <int Dqk, int Dv>
__global__ void __launch_bounds__(wg::kThreads)
    fresh_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int B, int Tq, int Tk,
                           int Hq, int Hkv, KVStrides st, float scale,
                           int causal) {
  extern __shared__ __align__(16) unsigned char tiles[];
  // heaviest query tile first: blockIdx.x = (reversed tile, b, h), h fastest
  int bid = blockIdx.x;
  const int h = bid % Hq;
  bid /= Hq;
  const int b = bid % B;
  const int i0 = ((Tq + wg::kRows - 1) / wg::kRows - 1 - bid / B) * wg::kRows;
  const int hk = h / (Hq / Hkv);
  const size_t qstride = static_cast<size_t>(Hq) * Dqk;
  const size_t ostride = static_cast<size_t>(Hq) * Dv;
  const size_t q0 = static_cast<size_t>(b) * Tq * qstride + h * Dqk;
  const size_t o0 = static_cast<size_t>(b) * Tq * ostride + h * Dv;
  const ContiguousRows krows{static_cast<size_t>(b * st.sb + hk * st.sh),
                             static_cast<size_t>(wg::kRows * st.ss),
                             static_cast<size_t>(st.ss)};
  float* lb = lse + (static_cast<size_t>(b) * Hq + h) * Tq;
  if constexpr (Dqk == Dv) {  // V at K's offsets: one address, two copies
    wg::attend<Dqk, Dv>(q + q0, k, v, wg::ContiguousKeys{krows}, out + o0,
                        lb, qstride, ostride, i0, Tq, 0, Tk, scale, causal,
                        tiles);
  } else {
    const wg::SplitKeys keys{
        krows, ContiguousRows{static_cast<size_t>(b * st.vsb + hk * st.vsh),
                              static_cast<size_t>(wg::kRows * st.vss),
                              static_cast<size_t>(st.vss)}};
    wg::attend<Dqk, Dv>(q + q0, k, v, keys, out + o0, lb, qstride, ostride,
                        i0, Tq, 0, Tk, scale, causal, tiles);
  }
}

template <int Dqk, int Dv>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int Tq, int Tk, int Hq, int Hkv,
                       KVStrides st, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * prefill_smem_words(Dqk, Dv, kTile);
  const cudaError_t err =
      allow_dynamic_smem<fresh_fwd_kernel<float, Dqk, Dv>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kPrefillRows - 1) / kPrefillRows, Hq, B);
  fresh_fwd_kernel<float, Dqk, Dv><<<grid, kPrefillThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Tq, Tk, Hq,
      Hkv, st, scale, causal);
  return cudaGetLastError();
}

template <int Dqk, int Dv>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int Tq, int Tk, int Hq,
                        int Hkv, KVStrides st, float scale, int causal,
                        cudaStream_t stream) {
  constexpr int kSmem = wg::attend_smem(Dqk, Dv);
  const cudaError_t err =
      allow_dynamic_smem<fresh_fwd_wgmma_kernel<Dqk, Dv>>(kSmem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((Tq + wg::kRows - 1) /
                                                wg::kRows) * B * Hq;
  fresh_fwd_wgmma_kernel<Dqk, Dv><<<blocks, wg::kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, B, Tq, Tk, Hq, Hkv, st, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, Hq, Dqk] and out [B, Tq, Hq, Dv] contiguous; k [B, Tk, Hkv, Dqk]
// with element strides (sb, ss, sh, 1) and v [B, Tk, Hkv, Dv] with (vsb,
// vss, vsh, 1), which the bf16 form takes equal to k's where Dv == Dqk
// (bf16: multiples of 8, and every pointer 16-byte aligned, for the 16-byte
// copies); lse [B, Hq, Tq] float32.  (Dqk, Dv) is (64, 64),
// (128, 128) or (96, 64) (with_head_dims: smollm-360m's, mistral-nemo-12b's
// and qwen2-moe-a2.7b's, minicpm3-4b's decompressed MLA), any other pair is
// refused.  Returns cudaGetLastError().
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int dtype, int B, int Tq, int Tk, int Hq, int Hkv, int Dqk, int Dv,
    long long sb, long long ss, long long sh, long long vsb, long long vss,
    long long vsh, float scale, int causal, void* stream) {
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  const KVStrides st{sb, ss, sh, vsb, vss, vsh};
  if (dtype != kDtypeF32 && dtype != kDtypeBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_head_dims(Dqk, Dv, [&](auto dq, auto dv) {
    constexpr int kQK = decltype(dq)::value, kV = decltype(dv)::value;
    return dtype == kDtypeF32
               ? launch_f32<kQK, kV>(q, k, v, out, ls, B, Tq, Tk, Hq, Hkv, st,
                                     scale, causal, stm)
               : launch_bf16<kQK, kV>(q, k, v, out, ls, B, Tq, Tk, Hq, Hkv,
                                      st, scale, causal, stm);
  }));
}

// Dynamic shared memory of the bf16 (wgmma) kernel at head dims (Dqk, Dv),
// in bytes.
extern "C" int flash_attention_fwd_wgmma_smem(int Dqk, int Dv) {
  return wg::attend_smem(Dqk, Dv);
}
