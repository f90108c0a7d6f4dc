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
//   batch row); KV head h / G (GQA without repeating K/V).  Q's tile is
//   copied once into shared memory; K and V tiles of 64 keys stream through
//   a two-stage cp.async ring into 128B-swizzled tiles (wgmma.cuh), so the
//   copy of tile j + 1 overlaps the products of tile j.  Per tile:
//   S = Q·Kᵀ as four wgmma m64n64k16 (fp32 accumulators in registers); the
//   online (m, d) update in registers, in the accumulator layout: a row's
//   max from its thread's 16 scores and two quad shuffles, each exponential
//   taken once as exp2f with scale·log2(e) folded in, the rescale guard of
//   common.cuh (m_old == m_new gives 1, so -inf/-inf gives no NaN), and d
//   kept as per-thread partial sums, quad-reduced once at the end; then
//   O += P·V with P converted to bf16 in registers as wgmma's register A
//   operand and V read MN-major (transposed B).  Causal: key tiles run only
//   to the diagonal and only the diagonal tile (and a ragged last tile) is
//   masked; CTAs are numbered heaviest query tile first, so the triangle's
//   long CTAs start first.  Epilogue: out = O / d in bf16, lse = m + log d.
//   Keys at or past Tk are zero-filled without being read and score -inf;
//   query rows past Tq are zero-filled and not written, so T need not be a
//   multiple of 64.
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

// Shared memory of the bf16 form: Q, then two stages of (K, V), and the
// 1 KB the base is aligned up by.
constexpr int kWgmmaSmem = 5 * wg::kTileBytes + 1024;

__global__ void __launch_bounds__(wg::kThreads)
    fresh_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int B, int Tq, int Tk,
                           int Hq, int Hkv, long long sb, long long ss,
                           long long sh, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char tiles[];
  const uint32_t sq = wg::aligned_base(tiles);
  const uint32_t skv = sq + wg::kTileBytes;  // stage s: K, then V
  constexpr int R = wg::kRows;

  // heaviest query tile first: blockIdx.x = (reversed tile, b, h), h fastest
  int bid = blockIdx.x;
  const int h = bid % Hq;
  bid /= Hq;
  const int b = bid % B;
  const int qt = (Tq + R - 1) / R - 1 - bid / B;
  const int i0 = qt * R;
  const int hk = h / (Hq / Hkv);
  const size_t qstride = static_cast<size_t>(Hq) * wg::kD;
  const __nv_bfloat16* qrows =
      q + (static_cast<size_t>(b) * Tq + i0) * qstride + h * wg::kD;
  const __nv_bfloat16* kb = k + b * sb + hk * sh;
  const __nv_bfloat16* vb = v + b * sb + hk * sh;

  int nk = (Tk + R - 1) / R;
  if (causal) nk = min(nk, (min(i0 + R, Tq) - 1) / R + 1);

  wg::load_tile(sq, qrows, qstride, Tq - i0);
  wg::load_tile(skv, kb, ss, Tk);
  wg::load_tile(skv + wg::kTileBytes, vb, ss, Tk);
  wg::cp_async_commit();

  const float sl2 = scale * 1.4426950408889634f;  // scale · log2(e)
  float o[32], s[32];
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = s[i] = 0.f;
  const int row0 = wg::frag_row(0);  // this thread's rows: row0, row0 + 8

  for (int j = 0; j < nk; ++j) {
    wg::cp_async_wait_all();
    wg::fence_proxy_async();
    __syncthreads();  // tile j landed; every thread is done with tile j - 1
    if (j + 1 < nk) {
      const uint32_t nxt = skv + ((j + 1) & 1) * 2 * wg::kTileBytes;
      const int k0 = (j + 1) * R;
      wg::load_tile(nxt, kb + k0 * ss, ss, Tk - k0);
      wg::load_tile(nxt + wg::kTileBytes, vb + k0 * ss, ss, Tk - k0);
    }
    wg::cp_async_commit();
    const uint32_t ks = skv + (j & 1) * 2 * wg::kTileBytes;
    const uint32_t vs = ks + wg::kTileBytes;

    wg::fence_acc(s);
    wg::fence();
    wg::gemm_k(s, sq, ks);  // S = Q·Kᵀ
    wg::commit();
    wg::wait_all();
    wg::fence_acc(s);

    const int k0 = j * R;
    if (k0 + R > Tk || (causal && k0 + R - 1 > i0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + wg::frag_col(i), qp = i0 + wg::frag_row(i);
        if (kp >= Tk || (causal && kp > qp)) s[i] = REPRO_NEG_INF;
      }
    }
    // one ⊕ step of Algorithm 3 per row, in scaled log2 units
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1],
                                                         s[i]);
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = wg::quad_max(mx[r]);
      alpha[r] = m[r] == mx[r] ? 1.f : exp2f((m[r] - mx[r]) * sl2);
      m[r] = mx[r];
      ms[r] = mx[r] == REPRO_NEG_INF ? 0.f : mx[r] * sl2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2f(fmaf(s[i], sl2, -ms[r]));  // -inf scores give 0
      l[r] += s[i];
      o[i] *= alpha[r];
    }
    uint32_t p[4][4];
    wg::to_frag(s, p);
    wg::fence_acc(o);
    wg::fence();
    wg::gemm_rs(o, p, vs);  // O += P·V
    wg::commit();
    wg::wait_all();
    wg::fence_acc(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float d = wg::quad_sum(l[r]);
    const int i = i0 + row0 + 8 * r;
    if (i >= Tq) continue;
    const float inv = 1.f / fmaxf(d, 1e-30f);
    __nv_bfloat16* orow = out + static_cast<size_t>(b) * Tq * qstride +
                          i * qstride + h * wg::kD;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = wg::frag_col(4 * n);
      *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
          o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
    if ((threadIdx.x & 3) == 0)
      lse[(static_cast<size_t>(b) * Hq + h) * Tq + i] =
          d > 0.f ? m[r] * scale + logf(d) : REPRO_NEG_INF;
  }
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
  fresh_fwd_wgmma_kernel<<<blocks, wg::kThreads, kWgmmaSmem, stream>>>(
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
extern "C" int flash_attention_fwd_wgmma_smem() { return kWgmmaSmem; }
