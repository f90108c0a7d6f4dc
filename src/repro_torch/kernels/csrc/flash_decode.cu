// Single-token decode attention over a contiguous KV cache: one query token
// per row against positions [0, vlen[b]) of that row's cache, with the
// paper's online (m, d) carry.
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode_pallas (the
//   pallas_call at line 98; body _make_kernel:35), bf16/fp32.
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
//   (attention.cuh), shared with the paged decode kernel.
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
