// Multi-head latent attention (MLA) over a latent cache, the absorbed form
// that MLA serving runs: every query head h of batch row b scores
//   s_j = scale * (q_eff[h] . c_j + q_rope[h] . r_j)
// against the latent rows j < L of its row (c [B, S, R], r [B, S, Dr]) and
// returns sum_j softmax(s)_j * c_j, [B, T, H, R].  One shared "KV head"
// (MQA) whose key is [c, r] (Dqk = R + Dr = 288 for minicpm3-4b) and whose
// value is c itself (Dv = R = 256).  The scale is the caller's,
// (qk_nope + qk_rope)^-0.5, never derived from the kernel's widths.
//
// Replaces no pallas_call: the reference ran this attention in XLA
//   (src/repro/models/layers.py:414-425, mla_apply's cached branch; its
//   custom scale sends the decode to the chunked fallback at
//   src/repro/kernels/dispatch.py:573, and a value dim other than q's keeps
//   the prefill off the kernel at :887).  The port's rule that a CUDA tensor
//   runs a kernel or raises asks for these two entry points:
//   flash_decode_mla_launch (one query token, split-key with the paper's ⊕
//   merge) and flash_attention_mla_launch (the cached prefill, causal in
//   absolute coordinates from a per-row offset).
// Bound on the H100: each latent row (288 values) is read once per batch
//   row and used by all 40 heads for both the scores and the values, ~75
//   flops per byte of bf16: bytes bind for the tensor cores (295 flops/byte)
//   but not for the CUDA cores (67 TFLOP/s fp32, 20 flops/byte), which these
//   simple kernels use, so they sit far above their byte bound.  The
//   tensor-core design (the heads as one m64 wgmma tile, the latent tile as
//   the B operand, K-major for the scores and MN-major for P.V) is the next
//   redesign.
// Design: a CTA of 8 warps takes 40 query rows, 5 a warp; a lane holds 8 of
//   a row's 256 latent dims of q (pre-scaled) and of its accumulator, and
//   one of its 32 rope dims (lane_values / lane_dim of attention.cuh, so a
//   bf16 row is one 16-byte load a lane).  The CTA stages 32 latent rows (c
//   and r) at a time in shared memory with 16-byte cp.async copies, and
//   every warp uses that tile twice: the scores (a dot over the lane's dims,
//   then a shuffle tree; lane p keeps position p's score), one online (m,
//   d, acc) step of Algorithm 3 a tile and row, and P.V (position p's
//   weight broadcast from lane p).  Only positions below a row's limit are
//   staged or read, so a row never reads past its valid length (a masked
//   weight of 0 times a NaN would still be NaN).
//   The decode (mla_split_kernel) runs one CTA a (split, batch row)
//   with all H <= 40 heads: the wrapper's planner (kernels/flash_mla.py,
//   decode_plan) cuts [0, S) into splits of whole 32-row tiles, and each CTA
//   writes its partial (m, d, acc) to a workspace; the last live split of a
//   row (a ticket counter, set back to 0 by that CTA) ⊕-merges them in split
//   order (decode_merge), so the result does not depend on which CTA merges.
//   vlen 0 gives 0.  The prefill (mla_prefill_kernel) flattens a batch
//   row's (t, h) pairs into T * H query rows, t = row / H, 40 rows a CTA,
//   all against one latent row per key; row (t, h) sees keys j <
//   min(vlen, q_offset + t + 1) (causal) and the CTA's key loop stops at its
//   last row's limit.  Both read c and r in place through their strides (the
//   reference's k_cat concatenation copied the whole cache a layer and step).
#include "attention.cuh"

namespace {

constexpr int kLatent = 256;   // R, kv_lora_rank
constexpr int kRope = 32;      // Dr, qk_rope_head_dim
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 5;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;  // 40: minicpm3-4b's heads
constexpr int kTile = 32;      // latent rows staged a pass

static_assert(kLatent == 32 * kLaneDims, "a lane holds 8 latent dims");
static_assert(kRope == 32, "a lane holds one rope dim");

// One warp's query rows: q (pre-scaled) and the online state.
struct WarpRows {
  float q[kRowsPerWarp][kLaneDims];    // latent dims lane_dim(lane, i)
  float qr[kRowsPerWarp];              // rope dim `lane`
  float acc[kRowsPerWarp][kLaneDims];  // the same dims as q
  float m[kRowsPerWarp], d[kRowsPerWarp];
  int lim[kRowsPerWarp];               // keys [0, lim) visible
};

// Row j of the warp: its q from `q` [.., R] and `qr` [.., Dr] at row index
// `row` (or zeros, with no visible key, when `ok` is false).
template <typename T>
__device__ __forceinline__ void load_row(WarpRows& w, int j, bool ok,
                                         const T* __restrict__ q,
                                         const T* __restrict__ qr, size_t row,
                                         int lim, float scale, int lane) {
#pragma unroll
  for (int i = 0; i < kLaneDims; ++i) {
    w.q[j][i] = ok ? to_f32(q[row * kLatent + lane_dim<T, kLatent>(lane, i)]) *
                         scale
                   : 0.f;
    w.acc[j][i] = 0.f;
  }
  w.qr[j] = ok ? to_f32(qr[row * kRope + lane]) * scale : 0.f;
  w.m[j] = REPRO_NEG_INF;
  w.d[j] = 0.f;
  w.lim[j] = ok ? lim : 0;
}

// Latent rows [k0, k0 + n), n <= kTile, of one batch row (c, r at that row,
// position strides cs, rs) into shared memory, every 16-byte copy in flight
// before the wait; the tile is ready for every warp on return.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ c,
                                          const T* __restrict__ r,
                                          long long cs, long long rs, int k0,
                                          int n, T* cts, T* rts) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kC = kLatent / kVec;  // copies a c row
  constexpr int kR = kRope / kVec;    // copies an r row
  for (int e = threadIdx.x; e < n * (kC + kR); e += kThreads) {
    const int p = e / (kC + kR), ch = e % (kC + kR);
    const long long t = k0 + p;
    if (ch < kC) {
      cp_async16(smem_addr(cts + p * kLatent + ch * kVec),
                 c + t * cs + ch * kVec);
    } else {
      cp_async16(smem_addr(rts + p * kRope + (ch - kC) * kVec),
                 r + t * rs + (ch - kC) * kVec);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
}

// The warp's rows against tile positions [0, n) (absolute k0 + p): the
// scores, one online step per row, then P.V.  A position at or past a row's
// limit scores -inf and weighs 0; positions past n are not read.
template <typename T>
__device__ __forceinline__ void attend_tile(const T* cts, const T* rts, int k0,
                                            int n, WarpRows& w, int lane) {
  float s[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) s[j] = REPRO_NEG_INF;
  for (int p = 0; p < n; ++p) {  // warp-uniform
    float x[kLaneDims];
    lane_values<kLatent>(cts + p * kLatent, lane, x);
    const float xr = to_f32(rts[p * kRope + lane]);
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      float part = w.qr[j] * xr;
#pragma unroll
      for (int i = 0; i < kLaneDims; ++i) part = fmaf(w.q[j][i], x[i], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == p && k0 + p < w.lim[j]) s[j] = part;
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    float mc = s[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
    const float mn = fmaxf(w.m[j], mc);
    const float alpha = rescale(w.m[j], mn);
    const float p = s[j] == REPRO_NEG_INF ? 0.f : expf(s[j] - mn);
    float ps = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    w.d[j] = w.d[j] * alpha + ps;
    w.m[j] = mn;
#pragma unroll
    for (int i = 0; i < kLaneDims; ++i) w.acc[j][i] *= alpha;
    s[j] = p;
  }
  for (int p = 0; p < n; ++p) {
    float x[kLaneDims];
    lane_values<kLatent>(cts + p * kLatent, lane, x);
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const float pw = __shfl_sync(0xffffffffu, s[j], p);
#pragma unroll
      for (int i = 0; i < kLaneDims; ++i)
        w.acc[j][i] = fmaf(pw, x[i], w.acc[j][i]);
    }
  }
}

// Keys [k0, k1) of batch row `c`, `r` for every warp's rows, a tile a pass.
template <typename T>
__device__ __forceinline__ void attend_range(const T* __restrict__ c,
                                             const T* __restrict__ r,
                                             long long cs, long long rs,
                                             int k0, int k1, T* cts, T* rts,
                                             WarpRows& w, int lane) {
  for (int t0 = k0; t0 < k1; t0 += kTile) {
    const int n = min(kTile, k1 - t0);
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T>(c, r, cs, rs, t0, n, cts, rts);
    attend_tile<T>(cts, rts, t0, n, w, lane);
  }
}

// One split of a one-token decode: heads [0, H) of batch row b =
// blockIdx.y against positions [s0, s0 + n), s0 = blockIdx.x * split, n =
// min(split, L - s0), L = min(vlen[b], S).  q, qr and out are [B, H, R] /
// [B, H, Dr] / [B, H, R]; the workspace holds part_acc [B, splits, H, R]
// and part_md [B, splits, H].
template <typename T>
__global__ void __launch_bounds__(kThreads) mla_split_kernel(
    const T* __restrict__ q, const T* __restrict__ qr,
    const T* __restrict__ c, const T* __restrict__ r,
    const int* __restrict__ vlen, int H, int S, int split, int splits,
    long long cb, long long cs, long long rb, long long rs, float scale,
    float* __restrict__ part_acc, float2* __restrict__ part_md,
    int* __restrict__ tickets, T* __restrict__ out) {
  __shared__ __align__(16) T cts[kTile * kLatent];
  __shared__ __align__(16) T rts[kTile * kRope];
  __shared__ int last;
  const int b = blockIdx.y;
  const int L = min(max(vlen[b], 0), S);
  const int s0 = blockIdx.x * split;
  const size_t out0 = static_cast<size_t>(b) * H * kLatent;
  if (s0 >= L) {                        // uniform: a dead split
    if (L == 0 && blockIdx.x == 0) {    // no valid position: 0
      for (int e = threadIdx.x; e < H * kLatent; e += kThreads)
        out[out0 + e] = from_f32<T>(0.f);
    }
    return;
  }
  const int n = min(split, L - s0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpRows w;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int h = warp * kRowsPerWarp + j;
    load_row<T>(w, j, h < H, q, qr, static_cast<size_t>(b) * H + h, L, scale,
                lane);
  }
  attend_range<T>(c + b * cb, r + b * rb, cs, rs, s0, s0 + n, cts, rts, w,
                  lane);

  // the split's partial, then the ticket; the last live split merges
  const size_t part = static_cast<size_t>(b) * splits + blockIdx.x;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int h = warp * kRowsPerWarp + j;
    if (h >= H) break;
#pragma unroll
    for (int i = 0; i < kLaneDims; ++i)
      part_acc[(part * H + h) * kLatent + lane_dim<T, kLatent>(lane, i)] =
          w.acc[j][i];
    if (lane == 0) part_md[part * H + h] = make_float2(w.m[j], w.d[j]);
  }
  const int live = (L + split - 1) / split;
  __threadfence();                      // the partial before the ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + b, 1) == live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                      // every other split's partial
  decode_merge(part_acc + static_cast<size_t>(b) * splits * H * kLatent,
               part_md + static_cast<size_t>(b) * splits * H, live, H,
               kLatent, out + out0);
  if (threadIdx.x == 0) tickets[b] = 0;  // every live split has its ticket
}

// The cached prefill: query rows [row0, row0 + 40) of batch row b =
// blockIdx.y, row0 = blockIdx.x * 40, a row being (t, h) = (row / H, row %
// H) of q [B, T, H, R] / qr [B, T, H, Dr] (rows past T * H are masked).
// Row (t, h) sees keys j < min(vlen[b], S) and, when causal, j <=
// qo[b] + t.  Writes out [B, T, H, R] = acc / max(d, 1e-30), 0 for a row
// with no visible key.
template <typename T>
__global__ void __launch_bounds__(kThreads) mla_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ qr,
    const T* __restrict__ c, const T* __restrict__ r,
    const int* __restrict__ qo, const int* __restrict__ vlen, int Tq, int H,
    int S, long long cb, long long cs, long long rb, long long rs, int causal,
    float scale, T* __restrict__ out) {
  __shared__ __align__(16) T cts[kTile * kLatent];
  __shared__ __align__(16) T rts[kTile * kRope];
  const int b = blockIdx.y;
  const int L = min(max(vlen[b], 0), S);
  const int off = qo[b];
  const int rows = Tq * H;
  const int row0 = blockIdx.x * kRowsPerCta;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto limit = [&](int t) {
    return max(causal ? min(L, off + t + 1) : L, 0);
  };
  WarpRows w;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int row = row0 + warp * kRowsPerWarp + j;
    load_row<T>(w, j, row < rows, q, qr, static_cast<size_t>(b) * rows + row,
                limit(row / H), scale, lane);
  }
  // the CTA's last row sees the most keys
  const int kmax = limit((min(row0 + kRowsPerCta, rows) - 1) / H);
  attend_range<T>(c + b * cb, r + b * rb, cs, rs, 0, kmax, cts, rts, w, lane);
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int row = row0 + warp * kRowsPerWarp + j;
    if (row >= rows) break;
    const float inv = 1.f / fmaxf(w.d[j], 1e-30f);
    T* o = out + (static_cast<size_t>(b) * rows + row) * kLatent;
#pragma unroll
    for (int i = 0; i < kLaneDims; ++i)
      o[lane_dim<T, kLatent>(lane, i)] = from_f32<T>(w.acc[j][i] * inv);
  }
}

template <typename T>
cudaError_t launch_decode_mla(const void* q, const void* qr, const void* c,
                              const void* r, const int* vlen, void* out,
                              void* work, void* tickets, int B, int H, int S,
                              int split, int splits, long long cb,
                              long long cs, long long rb, long long rs,
                              float scale, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || H > kRowsPerCta || split < 1 ||
      splits < 1 || static_cast<long long>(split) * splits < S)
    return cudaErrorInvalidValue;
  float* acc = static_cast<float*>(work);
  float2* md = reinterpret_cast<float2*>(
      acc + static_cast<size_t>(B) * splits * H * kLatent);
  mla_split_kernel<T><<<dim3(splits, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(qr),
      static_cast<const T*>(c), static_cast<const T*>(r), vlen, H, S, split,
      splits, cb, cs, rb, rs, scale, acc, md, static_cast<int*>(tickets),
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_prefill_mla(const void* q, const void* qr, const void* c,
                               const void* r, const int* qo, const int* vlen,
                               void* out, int B, int Tq, int H, int S,
                               long long cb, long long cs, long long rb,
                               long long rs, int causal, float scale,
                               cudaStream_t stream) {
  if (B < 1 || B > 65535 || Tq < 1 || H < 1) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(Tq) * H;
  const long long ctas = (rows + kRowsPerCta - 1) / kRowsPerCta;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  mla_prefill_kernel<T><<<dim3(static_cast<unsigned>(ctas), B), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(qr),
      static_cast<const T*>(c), static_cast<const T*>(r), qo, vlen, Tq, H, S,
      cb, cs, rb, rs, causal, scale, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// q [B, H, R] and qr [B, H, Dr] contiguous (one query token), out [B, H, R];
// c [B, S, R] and r [B, S, Dr] with element strides (cb, cs, 1) and (rb, rs,
// 1), 16-byte aligned rows; vlen [B] int32; work: B * splits * H * (R + 2)
// floats; tickets: B ints, 0 on entry (and left 0).  R = 256, Dr = 32, H <=
// 40; splits of `split` positions, splits * split >= S.  One launch; returns
// cudaGetLastError().
extern "C" int flash_decode_mla_launch(const void* q, const void* qr,
                                       const void* c, const void* r,
                                       const void* vlen, void* out,
                                       void* work, void* tickets, int dtype,
                                       int B, int H, int S, int split,
                                       int splits, long long cb, long long cs,
                                       long long rb, long long rs,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(vlen);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kDtypeF32) {
    err = launch_decode_mla<float>(q, qr, c, r, vl, out, work, tickets, B, H,
                                   S, split, splits, cb, cs, rb, rs, scale,
                                   st);
  } else if (dtype == kDtypeBF16) {
    err = launch_decode_mla<__nv_bfloat16>(q, qr, c, r, vl, out, work,
                                           tickets, B, H, S, split, splits,
                                           cb, cs, rb, rs, scale, st);
  }
  return static_cast<int>(err);
}

// q [B, T, H, R] and qr [B, T, H, Dr] contiguous, out [B, T, H, R]; the
// caches as above; qo and vlen [B] int32 (key j is seen by token t when j <
// vlen[b] and, causal, j <= qo[b] + t).  One launch; returns
// cudaGetLastError().
extern "C" int flash_attention_mla_launch(
    const void* q, const void* qr, const void* c, const void* r,
    const void* qo, const void* vlen, void* out, int dtype, int B, int Tq,
    int H, int S, long long cb, long long cs, long long rb, long long rs,
    int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(qo);
  const int* vl = static_cast<const int*>(vlen);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kDtypeF32) {
    err = launch_prefill_mla<float>(q, qr, c, r, o, vl, out, B, Tq, H, S, cb,
                                    cs, rb, rs, causal, scale, st);
  } else if (dtype == kDtypeBF16) {
    err = launch_prefill_mla<__nv_bfloat16>(q, qr, c, r, o, vl, out, B, Tq,
                                            H, S, cb, cs, rb, rs, causal,
                                            scale, st);
  }
  return static_cast<int>(err);
}
