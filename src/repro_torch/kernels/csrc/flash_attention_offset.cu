// Cached-prefill flash attention over a contiguous KV cache: a chunk of
// queries at absolute offset q_offset[b] attends causally to positions
// [0, vlen[b]) of its row's cache.
//
// Replaces: src/repro/kernels/flash_attention.py,
//   flash_attention_offset_pallas (the pallas_call at line 260; body
//   _make_offset_kernel:147), bf16/fp32.
// Bound on the H100: bytes at the serving path's chunk widths (1..64 query
//   rows), the int8 single-shot prefill's 80..272 and the lockstep
//   prefill's 256: each live K/V position is read once per query tile for
//   4*D flops per row; a chunk stays under the ~295 flops/byte the tensor
//   cores need before they, not memory, bind.
// q, k and v stay in the model layout ([B, Tq, Hq, D] and [B, Tk, Hkv, D],
//   the cache read through the strides the wrapper passes), so nothing is
//   transposed or padded: the reference's ops._flash_offset padded the
//   cache to a tile multiple (a copy of the whole cache per call); here
//   positions at or past vlen are neither read nor scored, and rows past Tq
//   are masked, so Tq need not divide by the tile.  vlen is clamped to Tk.
//   The tile loop stops at the last live tile, min(ceil(vlen / tile),
//   (q_offset + last row) / tile + 1), as last_live_tile does in the
//   reference.  Scores are masked in absolute coordinates (k_pos <=
//   q_offset + i) and at vlen before the online (m, d, acc) update; a row
//   with no valid key gets lse -inf and output 0.  KV head h / G.
//
// Two forms, chosen by dtype (no probe, no fallback):
//
// bf16: offset_wgmma_kernel, on the tensor cores, at every chunk width (a
//   64-row tile wastes rows below Tq 64 and is still the faster form).  One
//   warpgroup a CTA owns 64 query rows of one (query head, batch row),
//   heaviest query tile first; its tile loop is wg::attend (wgmma.cuh), the
//   fresh forward's, given the row's q_offset and vlen: S = Q·Kᵀ and O +=
//   P·V as wgmma products on 64-key K/V tiles that a two-stage cp.async
//   ring fills (zero-filled, unread, at or past vlen); only tiles crossing
//   vlen or the diagonal are masked.  At D 128 a row is two 128-byte
//   swizzle atoms and the ring needs 81 KB of dynamic shared memory, which
//   the launch allows first.
//
// fp32: prefill_offset_kernel, on CUDA cores.  One CTA per (query tile of
//   16 rows, query head, batch row), 128 threads, 8 per query row;
//   32-position tiles; fp32 accumulation throughout (the fp32 parity runs
//   hold it to 1e-5).  The tile loop is prefill_attend (attention.cuh),
//   shared with the paged prefill kernel.
#include "attention.cuh"
#include "wgmma.cuh"

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

template <int D>
__global__ void __launch_bounds__(wg::kThreads)
    offset_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ q_offset,
                        const int* __restrict__ vlen,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int B, int Tq, int Hq,
                        int Hkv, int Tk, long long sb, long long ss,
                        long long sh, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char tiles[];
  // heaviest query tile first: blockIdx.x = (reversed tile, b, h), h fastest
  int bid = blockIdx.x;
  const int h = bid % Hq;
  bid /= Hq;
  const int b = bid % B;
  const int i0 = ((Tq + wg::kRows - 1) / wg::kRows - 1 - bid / B) * wg::kRows;
  const int hk = h / (Hq / Hkv);
  const size_t qstride = static_cast<size_t>(Hq) * D;
  const size_t q0 = static_cast<size_t>(b) * Tq * qstride + h * D;
  const wg::ContiguousKeys keys{
      ContiguousRows{static_cast<size_t>(b * sb + hk * sh),
                     static_cast<size_t>(wg::kRows * ss),
                     static_cast<size_t>(ss)}};
  wg::attend<D, D>(q + q0, k, v, keys, out + q0,
                   lse + (static_cast<size_t>(b) * Hq + h) * Tq, qstride,
                   qstride, i0, Tq, q_offset[b], max(min(vlen[b], Tk), 0),
                   scale, causal, tiles);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* q_offset, const int* vlen, void* out,
                       float* lse, int B, int Tq, int Hq, int Hkv, int Tk,
                       long long sb, long long ss, long long sh, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * prefill_smem_words(D, kTile);
  const cudaError_t err =
      allow_dynamic_smem<prefill_offset_kernel<float, D>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kPrefillRows - 1) / kPrefillRows, Hq, B);
  prefill_offset_kernel<float, D><<<grid, kPrefillThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), q_offset, vlen, static_cast<float*>(out),
      lse, Tq, Hq, Hkv, Tk, sb, ss, sh, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* q_offset, const int* vlen, void* out,
                        float* lse, int B, int Tq, int Hq, int Hkv, int Tk,
                        long long sb, long long ss, long long sh, float scale,
                        int causal, cudaStream_t stream) {
  constexpr int kSmem = wg::attend_smem(D);
  const cudaError_t err = allow_dynamic_smem<offset_wgmma_kernel<D>>(kSmem);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((Tq + wg::kRows - 1) / wg::kRows) * B * Hq;
  offset_wgmma_kernel<D><<<blocks, wg::kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_offset, vlen,
      static_cast<__nv_bfloat16*>(out), lse, B, Tq, Hq, Hkv, Tk, sb, ss, sh,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q and out [B, Tq, Hq, D] contiguous; k, v [B, Tk, Hkv, D] with element
// strides (sb, ss, sh, 1), the same for both; q_offset, vlen [B] int32;
// lse [B, Hq, Tq] float32.  D is 64 or 128 (the instances of
// with_head_dim), any other D is refused.  The fp32 form
// (prefill_offset_kernel, CUDA cores).  Returns cudaGetLastError().
extern "C" int flash_attention_offset_launch(
    const void* q, const void* k, const void* v, const void* q_offset,
    const void* vlen, void* out, void* lse, int B, int Tq, int Hq, int Hkv,
    int Tk, int D, long long sb, long long ss, long long sh, float scale,
    int causal, void* stream) {
  return static_cast<int>(with_head_dim(D, [&](auto d) {
    return launch_f32<decltype(d)::value>(
        q, k, v, static_cast<const int*>(q_offset),
        static_cast<const int*>(vlen), out, static_cast<float*>(lse), B, Tq,
        Hq, Hkv, Tk, sb, ss, sh, scale, causal,
        static_cast<cudaStream_t>(stream));
  }));
}

// The bf16 form (offset_wgmma_kernel, tensor cores), the same operands in
// bf16 (every pointer 16-byte aligned, K/V strides multiples of 8, for the
// 16-byte copies).  D is 64 or 128.  Returns cudaGetLastError().
extern "C" int flash_attention_offset_wgmma_launch(
    const void* q, const void* k, const void* v, const void* q_offset,
    const void* vlen, void* out, void* lse, int B, int Tq, int Hq, int Hkv,
    int Tk, int D, long long sb, long long ss, long long sh, float scale,
    int causal, void* stream) {
  return static_cast<int>(with_head_dim(D, [&](auto d) {
    return launch_bf16<decltype(d)::value>(
        q, k, v, static_cast<const int*>(q_offset),
        static_cast<const int*>(vlen), out, static_cast<float*>(lse), B, Tq,
        Hq, Hkv, Tk, sb, ss, sh, scale, causal,
        static_cast<cudaStream_t>(stream));
  }));
}

// Dynamic shared memory of the bf16 (wgmma) form at head dim D, in bytes.
extern "C" int flash_attention_offset_wgmma_smem(int D) {
  return wg::attend_smem(D);
}
