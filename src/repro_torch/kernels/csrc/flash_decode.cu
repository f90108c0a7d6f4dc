// Single-token decode attention over a contiguous KV cache: one query token
// per row against positions [0, vlen[b]) of that row's cache, with the
// paper's online (m, d) carry.
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode_pallas (the
//   pallas_call at line 98; body _make_kernel:35), bf16/fp32.  Its int8
//   form (flash_decode_int8_launch: int8 caches with bf16 scales
//   [B, S, Hkv]) replaces no pallas_call: the reference ran XLA's
//   _chunked_fwd_impl with k_scale/v_scale there (dispatch.py:858-870).
//   The port's rule that a CUDA tensor runs a kernel or raises asks for it.
// Bound on the H100: bytes.  Each valid cache position is read once per KV
//   head (K and V, D values each) for ~4*G flops per value, far below the
//   ~295 flops/byte where the tensor cores would bind.
// Design: one CTA per (kv head, batch row), G*D threads; the G query heads
//   of a GQA group share every K/V tile in shared memory, so the cache is
//   read once per group.  The cache stays in the model layout
//   [B, S, Hkv, D] and is read through the strides the wrapper passes: the
//   reference's ops.flash_decode transposed the whole cache to
//   [B, Hkv, S, D] on every call (a copy of every slot at full length), which
//   would move more bytes than the kernel reads.  A tile is kTile positions;
//   only tiles below ceil(vlen / kTile) are visited, and positions at or past
//   vlen are neither read nor scored, so a row reads exactly its valid
//   prefix.  vlen == 0 gives output 0; idle slots arrive with vlen 1 and read
//   position 0 of their own slot.  The tile loop is decode_attend
//   (attention.cuh), shared with the paged decode kernel.  The int8 form
//   runs the same loop; each tile's int8 K and V are dequantized by their
//   positions' scales, read through the scales' own strides, as they land
//   in shared memory.
#include "attention.cuh"

namespace {

constexpr int kTile = 32;  // cache positions per tile

template <typename T, int D>
__global__ void decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ vlen,
                              T* __restrict__ out, int Hq, int Hkv, int S,
                              long long sb, long long ss, long long sh,
                              float scale) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const ContiguousRows rows{static_cast<size_t>(b * sb + h * sh),
                            static_cast<size_t>(kTile * ss),
                            static_cast<size_t>(ss)};
  decode_attend<T, D>(q, k, v, rows, max(min(vlen[b], S), 0), kTile, out,
                      (static_cast<size_t>(b) * Hq + h * G) * D, G, scale,
                      smem);
}

// The int8 form: k, v int8 with element strides (sb, ss, sh, 1); scales
// [B, S, Hkv] bf16 with strides (zb, zs, zh).
template <typename T, int D>
__global__ void decode_int8_kernel(
    const T* __restrict__ q, const signed char* __restrict__ k,
    const signed char* __restrict__ v,
    const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ vlen,
    T* __restrict__ out, int Hq, int Hkv, int S, long long sb, long long ss,
    long long sh, long long zb, long long zs, long long zh, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const ContiguousRows rows{static_cast<size_t>(b * sb + h * sh),
                            static_cast<size_t>(kTile * ss),
                            static_cast<size_t>(ss)};
  const Scales<ContiguousRows> sc{
      k_scale, v_scale,
      ContiguousRows{static_cast<size_t>(b * zb + h * zh),
                     static_cast<size_t>(kTile * zs),
                     static_cast<size_t>(zs)}};
  decode_attend<T, D>(q, k, v, rows, max(min(vlen[b], S), 0), kTile, out,
                      (static_cast<size_t>(b) * Hq + h * G) * D, G, scale,
                      smem, sc);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* vlen, void* out, int B, int Hq, int Hkv, int S,
                   long long sb, long long ss, long long sh, float scale,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * decode_smem_words(G, D, kTile);
  decode_kernel<T, D><<<dim3(Hkv, B), G * D, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), vlen, static_cast<T*>(out), Hq, Hkv, S, sb, ss,
      sh, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const int* vlen, void* out, int B, int Hq, int Hkv, int S,
                     long long sb, long long ss, long long sh, float scale,
                     cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, vlen, out, B, Hq, Hkv, S, sb, ss, sh, scale,
                         stream);
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t launch_int8(const void* q, const void* k, const void* v,
                        const void* k_scale, const void* v_scale,
                        const int* vlen, void* out, int B, int Hq, int Hkv,
                        int S, long long sb, long long ss, long long sh,
                        long long zb, long long zs, long long zh, float scale,
                        cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * decode_smem_words(G, D, kTile);
  decode_int8_kernel<T, D><<<dim3(Hkv, B), G * D, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const signed char*>(k),
      static_cast<const signed char*>(v),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), vlen, static_cast<T*>(out),
      Hq, Hkv, S, sb, ss, sh, zb, zs, zh, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, Hq, D] and out [B, Hq, D] contiguous; k, v [B, S, Hkv, D] with
// element strides (sb, ss, sh, 1), the same for both; vlen [B] int32.
// D == 64 (smollm-360m's head_dim), (Hq / Hkv) * D <= 1024.  Returns
// cudaGetLastError().
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* vlen, void* out,
                                   int dtype, int B, int Hq, int Hkv, int S,
                                   int D, long long sb, long long ss,
                                   long long sh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(vlen);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = launch_d<float>(D, q, k, v, vl, out, B, Hq, Hkv, S, sb, ss, sh,
                          scale, st);
  } else if (dtype == kDtypeBF16) {
    err = launch_d<__nv_bfloat16>(D, q, k, v, vl, out, B, Hq, Hkv, S, sb, ss,
                                  sh, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The int8 form: q and out as above (float or bf16, `dtype`); k, v
// [B, S, Hkv, D] int8 with element strides (sb, ss, sh, 1), the same for
// both; k_scale, v_scale [B, S, Hkv] bf16 with strides (zb, zs, zh), the
// same for both.  D == 64.
extern "C" int flash_decode_int8_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* vlen, void* out, int dtype, int B,
    int Hq, int Hkv, int S, int D, long long sb, long long ss, long long sh,
    long long zb, long long zs, long long zh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(vlen);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64 && dtype == kDtypeF32) {
    err = launch_int8<float, 64>(q, k, v, k_scale, v_scale, vl, out, B, Hq,
                                 Hkv, S, sb, ss, sh, zb, zs, zh, scale, st);
  } else if (D == 64 && dtype == kDtypeBF16) {
    err = launch_int8<__nv_bfloat16, 64>(q, k, v, k_scale, v_scale, vl, out,
                                         B, Hq, Hkv, S, sb, ss, sh, zb, zs,
                                         zh, scale, st);
  }
  return static_cast<int>(err);
}
