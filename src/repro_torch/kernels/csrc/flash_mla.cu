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
//   runs a kernel or raises asks for these entry points: the one-token
//   decode (split-key with the paper's ⊕ merge) and the cached prefill
//   (causal in absolute coordinates from a per-row offset), each in two
//   forms chosen by dtype (no probe, no fallback): bf16 on the tensor cores,
//   fp32 on the CUDA cores.
// Bound on the H100: each latent row (288 values) is read once per batch
//   row and used by all 40 heads for both the scores and the values, ~75
//   flops per byte of bf16, under the ~295 flops/byte where the tensor
//   cores would bind: bytes bind (1.24 MB, 0.37 us for minicpm3-4b's decode
//   step at B 8 over lengths 65-328).  At the serving shapes a call moves
//   so few bytes that latency sets its time: one tile's copy, its products
//   and, for the decode, the merge's round trips through L2.  The CUDA
//   cores would bind first (67 TFLOP/s fp32, 20 flops/byte), which is why
//   the bf16 forms run on the tensor cores.
//
// bf16: mla_decode_wgmma_kernel and mla_prefill_wgmma_kernel (namespace
//   latent).  A CTA is two warpgroups (256 threads) over one 64-row query
//   tile: the 40 heads of a batch row (rows 40-63 zero, never written) for
//   the decode, 64 flattened (token, head) rows for the prefill.  Operands
//   are 128B-swizzled bf16 tiles (wgmma.cuh): Q as q_eff's four atom
//   columns plus q_rope in the first half of a fifth (40 KB); a key stage
//   is 64 latent rows in the same layout, c in four atom columns and r in
//   the fifth (40 KB), two stages through a cp.async ring, 121 KB of
//   dynamic shared memory (one CTA an SM; the launch raises the limit
//   first).  V is the same c tile read MN-major, so c is copied once.  Per
//   key tile each warpgroup computes the same S = Q·Kᵀ, one m64n64 fp32
//   accumulator over k = 288 (16 k-steps over c's atom columns, 2 over the
//   rope column's 32 values), the online (m, d) update of wg::attend (exp2
//   with scale·log2 e folded in, the rescale guard so -inf/-inf gives no
//   NaN), then O += P·V for its own 128 of the 256 columns (two m64n64
//   accumulators), P in registers as wgmma's A operand in two bf16 terms,
//   hi = bf16(p) and lo = bf16(p - hi) (split_frag: with one bf16 P, rows
//   over a few keys land two output ulps off the fp32 arithmetic).
//   Positions at or past a row's limit are zero-filled without being read
//   and score -inf.
//   The decode runs one CTA a (split, batch row), splits of whole 64-key
//   tiles (kernels/flash_mla.py, decode_plan); a row with one live split
//   writes its output at once, otherwise each live split leaves its partial
//   (acc [H, R] unnormalized, (m·scale, d) per head) in the workspace and
//   the last to take a ticket merges (merge_partials): each (split, head)
//   weight e^{m_i - M} / Σ d_i e^{m_i - M} is computed once into shared
//   memory, then every thread streams float4s of output with the loads of
//   up to 8 partials for 2 outputs in flight together, summed in split
//   order, so the result does not depend on which CTA merges.  The prefill
//   runs one CTA a 64-row tile of a batch row's T·H flattened rows (row i at
//   position q_offset + i / H; grid ceil(T·H / 64) x B, heaviest tile
//   first); its key loop stops at its last row's limit, and only tiles past
//   its first row's limit are masked.
//
// fp32: mla_split_kernel and mla_prefill_kernel, on the CUDA cores (the fp32
//   parity runs hold them to 1e-5).  A CTA of 8 warps takes 40 query rows,
//   5 a warp; a lane holds 8 of a row's 256 latent dims of q (pre-scaled)
//   and of its accumulator, and one of its 32 rope dims (lane_values /
//   lane_dim of attention.cuh).  The CTA stages 32 latent rows (c and r) at
//   a time in shared memory with 16-byte cp.async copies, and every warp
//   uses that tile twice: the scores (a dot over the lane's dims, then a
//   shuffle tree; lane p keeps position p's score), one online (m, d, acc)
//   step of Algorithm 3 a tile and row, and P.V (position p's weight
//   broadcast from lane p).  Only positions below a row's limit are staged
//   or read, so a row never reads past its valid length (a masked weight of
//   0 times a NaN would still be NaN).  The decode (mla_split_kernel) runs
//   one CTA a (split, batch row) with all H <= 40 heads, splits of whole
//   32-row tiles; each CTA writes its partial (m, d, acc) to a workspace;
//   the last live split of a row (a ticket counter, set back to 0 by that
//   CTA) ⊕-merges them in split order (decode_merge).  The prefill
//   (mla_prefill_kernel) flattens a batch row's (t, h) pairs into T * H
//   query rows, 40 rows a CTA; row (t, h) sees keys j < min(vlen, q_offset +
//   t + 1) (causal) and the CTA's key loop stops at its last row's limit.
//
// Both forms read c and r in place through their strides (the reference's
// k_cat concatenation copied the whole cache a layer and step); vlen 0
// gives exactly 0.
#include "attention.cuh"
#include "wgmma.cuh"

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

// ---- bf16: the tensor-core forms -------------------------------------------
namespace latent {

constexpr int kRows = wg::kRows;                  // query rows, keys a stage
constexpr int kThreads = 2 * wg::kThreads;        // two warpgroups
constexpr int kAtoms = kLatent / wg::kD;          // c's atom columns: 4
constexpr int kChunks = (kLatent + kRope) / 8;    // 16-byte copies a row
// a tile: c's four atom columns, then r in the first half of a fifth
constexpr uint32_t kTileBytes = (kAtoms + 1) * wg::kTileBytes;   // 40 KB
// Q, two key stages and the 1 KB the base is aligned up by: 121 KB
constexpr int kSmem = 3 * kTileBytes + 1024;
constexpr int kMergeOuts = 2;     // float4 outputs a thread merges at once
constexpr int kMergeSplits = 8;   // partials loaded at once for each

static_assert(kRows * kChunks % kThreads == 0, "whole copies a thread");
static_assert(kRope == 32, "r fills the first two k-steps of an atom column");

// Rows [0, 64) of a latent operand into the tile at `dst`, by the CTA's 256
// threads: row i's c (R values) from c + i * cs and its r (Dr values) from
// r + i * rs, c's 16-byte chunk k at wg::chunk_offset(i, k) and r's chunk k
// at chunk (32 + k), the fifth atom column; rows at or past `valid` are
// zero-filled without being read.
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* c,
                                          const __nv_bfloat16* r,
                                          long long cs, long long rs,
                                          int valid) {
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int i = e / kChunks, k = e % kChunks;
    const bool ok = i < valid;
    const __nv_bfloat16* src =
        k < kLatent / 8 ? c + (ok ? i * cs : 0) + k * 8
                        : r + (ok ? i * rs : 0) + (k - kLatent / 8) * 8;
    cp_async16(dst + wg::chunk_offset(i, k), src, ok);
  }
}

// S = Q·Kᵀ over a latent row's 288 values: 16 k-steps over c's four atom
// columns (wg::gemm_k), then 2 over the rope column's first 32 values.
__device__ __forceinline__ void scores(float (&s)[32], uint32_t sq,
                                       uint32_t sk) {
  wg::gemm_k<kLatent>(s, sq, sk);
  constexpr uint32_t col = kAtoms * wg::kTileBytes;
#pragma unroll
  for (int kk = 0; kk < kRope / 16; ++kk)
    wg::mma_ss(s, wg::desc_k(sq + col, kk), wg::desc_k(sk + col, kk), 1);
}

// P (a 64 x 64 accumulator) as two bf16 register operands, hi = bf16(p)
// and lo = bf16(p - hi): (hi + lo)·V keeps ~16 bits of each weight where
// one bf16 P keeps 8, which leaves the output of a row over a few keys two
// bf16 ulps off the fp32 arithmetic.
__device__ __forceinline__ void split_frag(const float (&d)[32],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
  wg::to_frag(d, hi);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][i]));
      lo[kk][i] = wg::pack_bf16(d[8 * kk + 2 * i] - h.x,
                                d[8 * kk + 2 * i + 1] - h.y);
    }
}

// This thread's share of a tile's result: O for the two rows it holds
// (wg::frag_row(0) and 8 below) at its warpgroup's 128 columns (two
// m64n64 accumulators), each row's running max m (score units) and its
// partial sum of weights l (quad-summed by the caller).
struct Rows {
  float o[2][32];
  float m[2], l[2];
};

// The query tile (rows [0, qvalid) at q + i * R, qr + i * Dr) against keys
// [k0, k1) of one batch row (c + t * cs, r + t * rs), in 64-key tiles
// through a two-stage cp.async ring (the copy of tile j + 1 overlaps the
// products of tile j).  Key t is seen by this thread's row rr when t <
// lim[rr]; tiles that end at or below lim_min (every row's limit) are not
// masked.  sl2 = scale · log2(e).
__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ q,
                                       const __nv_bfloat16* __restrict__ qr,
                                       int qvalid,
                                       const __nv_bfloat16* __restrict__ c,
                                       const __nv_bfloat16* __restrict__ r,
                                       long long cs, long long rs, int k0,
                                       int k1, const int (&lim)[2],
                                       int lim_min, float sl2,
                                       unsigned char* smem, Rows& w) {
  const uint32_t sq = wg::aligned_base(smem);
  const uint32_t skv = sq + kTileBytes;             // stage s: skv + s * 40 KB
  const uint32_t vcol = (threadIdx.x / wg::kThreads) * 2 * wg::kTileBytes;
  const int nk = (k1 - k0 + kRows - 1) / kRows;

  load_rows(sq, q, qr, kLatent, kRope, qvalid);
  load_rows(skv, c + k0 * cs, r + k0 * rs, cs, rs, k1 - k0);
  cp_async_commit();

  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
    w.o[0][i] = w.o[1][i] = 0.f;
  }
  w.m[0] = w.m[1] = REPRO_NEG_INF;
  w.l[0] = w.l[1] = 0.f;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait_all();
    wg::fence_proxy_async();
    __syncthreads();  // tile j landed; every thread is done with tile j - 1
    const int t0 = k0 + j * kRows;
    if (j + 1 < nk) {
      const int t1 = t0 + kRows;
      load_rows(skv + ((j + 1) & 1) * kTileBytes, c + t1 * cs, r + t1 * rs,
                cs, rs, k1 - t1);
    }
    cp_async_commit();
    const uint32_t ks = skv + (j & 1) * kTileBytes;

    wg::fence_acc(s);
    wg::fence();
    scores(s, sq, ks);
    wg::commit();
    wg::wait_all();
    wg::fence_acc(s);

    if (t0 + kRows > lim_min) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (t0 + wg::frag_col(i) >= lim[(i >> 1) & 1]) s[i] = REPRO_NEG_INF;
    }
    // one ⊕ step of Algorithm 3 per row, in scaled log2 units (wg::attend)
    float mx[2] = {w.m[0], w.m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], ms[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = wg::quad_max(mx[rr]);
      alpha[rr] = w.m[rr] == mx[rr] ? 1.f : exp2f((w.m[rr] - mx[rr]) * sl2);
      w.m[rr] = mx[rr];
      ms[rr] = mx[rr] == REPRO_NEG_INF ? 0.f : mx[rr] * sl2;
      w.l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      s[i] = exp2f(fmaf(s[i], sl2, -ms[rr]));  // -inf scores give 0
      w.l[rr] += s[i];
      w.o[0][i] *= alpha[rr];
      w.o[1][i] *= alpha[rr];
    }
    uint32_t hi[4][4], lo[4][4];
    split_frag(s, hi, lo);
    wg::fence_acc(w.o[0]);
    wg::fence_acc(w.o[1]);
    wg::fence();
    // O[:, cols] += (P_hi + P_lo)·V[:, cols], V = c read MN-major
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      wg::gemm_rs(w.o[a], hi, ks + vcol + a * wg::kTileBytes);
      wg::gemm_rs(w.o[a], lo, ks + vcol + a * wg::kTileBytes);
    }
    wg::commit();
    wg::wait_all();
    wg::fence_acc(w.o[0]);
    wg::fence_acc(w.o[1]);
  }
  cp_async_wait_all();  // no copy outlives the loop (nk == 0 issues some)
}

// The column of this thread's accumulator float 4n (+1 beside it) in O's
// 256: its warpgroup's 128, then accumulator a's 64.
__device__ __forceinline__ int out_col(int a, int n) {
  return (threadIdx.x / wg::kThreads) * 2 * wg::kD + a * wg::kD +
         wg::frag_col(4 * n);
}

// out row i (i < valid, rows R apart) = O / d in bf16, d the rows' sums.
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           int valid, const Rows& w,
                                           const float (&d)[2]) {
  const int row0 = wg::frag_row(0);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = row0 + 8 * rr;
    if (i >= valid) continue;
    const float inv = 1.f / fmaxf(d[rr], 1e-30f);
    __nv_bfloat16* orow = out + static_cast<size_t>(i) * kLatent;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + out_col(a, n)) =
            __floats2bfloat162_rn(w.o[a][4 * n + 2 * rr] * inv,
                                  w.o[a][4 * n + 2 * rr + 1] * inv);
  }
}

// The merge of one batch row's `live` partials (acc [live, H, R], md
// [live, H] as (m·scale, d)) into out [H, R]: out = Σ_i w_i acc_i with w_i
// = e^{m_i - M} / max(Σ_i d_i e^{m_i - M}, 1e-30), M = max_i m_i (rescale
// pins a -inf/-inf pair to 1).  The weights, one a (split, head), are
// computed once into `wt` (shared memory, live * H float2); then each
// thread takes float4s of output kMergeOuts at a time, with all their
// loads from kMergeSplits partials in flight together, and sums them in
// split order.  The partials come from other CTAs' writes, so they are
// read from L2 (__ldcg), past this SM's L1.
__device__ __forceinline__ void merge_partials(
    const float* __restrict__ acc, const float2* __restrict__ md, int live,
    int H, __nv_bfloat16* __restrict__ out, float2* wt) {
  for (int e = threadIdx.x; e < live * H; e += kThreads)
    wt[e] = __ldcg(md + e);
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float mx = REPRO_NEG_INF, den = 0.f;
    for (int i = 0; i < live; ++i) mx = fmaxf(mx, wt[i * H + h].x);
    for (int i = 0; i < live; ++i)
      den += wt[i * H + h].y * rescale(wt[i * H + h].x, mx);
    const float inv = 1.f / fmaxf(den, 1e-30f);
    for (int i = 0; i < live; ++i)
      wt[i * H + h].x = rescale(wt[i * H + h].x, mx) * inv;
  }
  __syncthreads();
  const int n4 = H * kLatent / 4;                  // float4s of output
  const float4* a4 = reinterpret_cast<const float4*>(acc);
  for (int f0 = threadIdx.x; f0 < n4; f0 += kThreads * kMergeOuts) {
    float4 sum[kMergeOuts];
#pragma unroll
    for (int u = 0; u < kMergeOuts; ++u) sum[u] = make_float4(0, 0, 0, 0);
    for (int i0 = 0; i0 < live; i0 += kMergeSplits) {
      float4 x[kMergeOuts][kMergeSplits];
#pragma unroll
      for (int u = 0; u < kMergeOuts; ++u)
#pragma unroll
        for (int j = 0; j < kMergeSplits; ++j) {
          const int f = f0 + u * kThreads, i = i0 + j;
          x[u][j] = f < n4 && i < live
                        ? __ldcg(a4 + static_cast<size_t>(i) * n4 + f)
                        : make_float4(0, 0, 0, 0);
        }
#pragma unroll
      for (int u = 0; u < kMergeOuts; ++u) {
        const int f = f0 + u * kThreads;
        if (f >= n4) continue;
        const int h = f / (kLatent / 4);
#pragma unroll
        for (int j = 0; j < kMergeSplits; ++j) {
          if (i0 + j >= live) break;
          const float g = wt[(i0 + j) * H + h].x;
          sum[u].x = fmaf(g, x[u][j].x, sum[u].x);
          sum[u].y = fmaf(g, x[u][j].y, sum[u].y);
          sum[u].z = fmaf(g, x[u][j].z, sum[u].z);
          sum[u].w = fmaf(g, x[u][j].w, sum[u].w);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMergeOuts; ++u) {
      const int f = f0 + u * kThreads;
      if (f < n4)
        *reinterpret_cast<uint2*>(out + 4 * f) =
            make_uint2(wg::pack_bf16(sum[u].x, sum[u].y),
                       wg::pack_bf16(sum[u].z, sum[u].w));
    }
  }
}

// One split of a one-token decode: heads [0, H) of batch row b =
// blockIdx.y against positions [s0, s0 + n), s0 = blockIdx.x * split (a
// multiple of 64), n = min(split, L - s0), L = min(vlen[b], S).  q, qr and
// out are [B, H, R] / [B, H, Dr] / [B, H, R]; the workspace holds part_acc
// [B, splits, H, R] and part_md [B, splits, H].  A split at or past L
// returns at once (split 0 of a row with L == 0 writes its output, 0,
// first); a row with one live split writes its output itself.
__global__ void __launch_bounds__(kThreads, 1) mla_decode_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ qr,
    const __nv_bfloat16* __restrict__ c, const __nv_bfloat16* __restrict__ r,
    const int* __restrict__ vlen, int H, int S, int split, int splits,
    long long cb, long long cs, long long rb, long long rs, float scale,
    float* __restrict__ part_acc, float2* __restrict__ part_md,
    int* __restrict__ tickets, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int b = blockIdx.y;
  const int L = min(max(vlen[b], 0), S);
  const int s0 = blockIdx.x * split;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * H * kLatent;
  if (s0 >= L) {                        // uniform: a dead split
    if (L == 0 && blockIdx.x == 0) {    // no valid position: 0
      for (int e = threadIdx.x; e < H * kLatent; e += kThreads)
        ob[e] = __float2bfloat16(0.f);
    }
    return;
  }
  const int k1 = s0 + min(split, L - s0);
  const int live = (L + split - 1) / split;
  const int lim[2] = {k1, k1};
  Rows w;
  attend(q + static_cast<size_t>(b) * H * kLatent,
         qr + static_cast<size_t>(b) * H * kRope, H, c + b * cb, r + b * rb,
         cs, rs, s0, k1, lim, k1, scale * 1.4426950408889634f, smem, w);
  const float d[2] = {wg::quad_sum(w.l[0]), wg::quad_sum(w.l[1])};
  if (live == 1) {                      // uniform: nothing to merge
    store_rows(ob, H, w, d);
    return;
  }

  // the split's partial, then the ticket; the last live split merges
  const size_t part = static_cast<size_t>(b) * splits + blockIdx.x;
  float* pa = part_acc + part * H * kLatent;
  const int row0 = wg::frag_row(0);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int h = row0 + 8 * rr;
    if (h >= H) continue;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(pa + h * kLatent + out_col(a, n)) =
            make_float2(w.o[a][4 * n + 2 * rr], w.o[a][4 * n + 2 * rr + 1]);
    if (threadIdx.x < wg::kThreads && (threadIdx.x & 3) == 0)
      part_md[part * H + h] = make_float2(w.m[rr] * scale, d[rr]);
  }
  __threadfence();                      // the partial before the ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + b, 1) == live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                      // every other split's partial
  merge_partials(part_acc + static_cast<size_t>(b) * splits * H * kLatent,
                 part_md + static_cast<size_t>(b) * splits * H, live, H, ob,
                 reinterpret_cast<float2*>(
                     smem + (wg::aligned_base(smem) - smem_addr(smem))));
  if (threadIdx.x == 0) tickets[b] = 0;  // every live split has its ticket
}

// The cached prefill: flattened query rows [i0, i0 + 64) of batch row b =
// blockIdx.y, i0 = 64 * (gridDim.x - 1 - blockIdx.x) (the heaviest tile
// first), row i being (t, h) = (i / H, i % H) of q [B, T, H, R] / qr
// [B, T, H, Dr] (rows past T * H are zero-filled and not written).  Row
// (t, h) sees keys j < min(vlen[b], S) and, when causal, j <= qo[b] + t.
// Writes out [B, T, H, R] = O / max(d, 1e-30), 0 for a row with no visible
// key.
__global__ void __launch_bounds__(kThreads, 1) mla_prefill_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ qr,
    const __nv_bfloat16* __restrict__ c, const __nv_bfloat16* __restrict__ r,
    const int* __restrict__ qo, const int* __restrict__ vlen, int Tq, int H,
    int S, long long cb, long long cs, long long rb, long long rs, int causal,
    float scale, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int rows = Tq * H;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int valid = min(kRows, rows - i0);
  const int L = min(max(vlen[b], 0), S);
  const int off = qo[b];
  auto limit = [&](int i) {
    return max(causal ? min(L, off + i / H + 1) : L, 0);
  };
  const int row0 = wg::frag_row(0);
  const int lim[2] = {row0 < valid ? limit(i0 + row0) : 0,
                      row0 + 8 < valid ? limit(i0 + row0 + 8) : 0};
  const size_t q0 = static_cast<size_t>(b) * rows + i0;
  Rows w;
  // the tile's last row sees the most keys, its first the fewest
  attend(q + q0 * kLatent, qr + q0 * kRope, valid, c + b * cb, r + b * rb,
         cs, rs, 0, limit(i0 + valid - 1), lim, limit(i0),
         scale * 1.4426950408889634f, smem, w);
  const float d[2] = {wg::quad_sum(w.l[0]), wg::quad_sum(w.l[1])};
  store_rows(out + q0 * kLatent, valid, w, d);
}

// Partials a decode may merge: live * H float2 weights in the tiles' space.
__host__ __device__ constexpr bool merge_fits(int splits, int H) {
  return static_cast<long long>(splits) * H * 8 <= 3LL * kTileBytes;
}

}  // namespace latent

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

using bf16 = __nv_bfloat16;

cudaError_t launch_decode_wgmma(const void* q, const void* qr, const void* c,
                                const void* r, const int* vlen, void* out,
                                void* work, void* tickets, int B, int H,
                                int S, int split, int splits, long long cb,
                                long long cs, long long rb, long long rs,
                                float scale, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || H > latent::kRows ||
      split < latent::kRows || split % latent::kRows || splits < 1 ||
      static_cast<long long>(split) * splits < S ||
      !latent::merge_fits(splits, H) || !(scale > 0.f))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      allow_dynamic_smem<latent::mla_decode_wgmma_kernel>(latent::kSmem);
  if (err != cudaSuccess) return err;
  float* acc = static_cast<float*>(work);
  float2* md = reinterpret_cast<float2*>(
      acc + static_cast<size_t>(B) * splits * H * kLatent);
  latent::mla_decode_wgmma_kernel<<<dim3(splits, B), latent::kThreads,
                                    latent::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(qr),
      static_cast<const bf16*>(c), static_cast<const bf16*>(r), vlen, H, S,
      split, splits, cb, cs, rb, rs, scale, acc, md,
      static_cast<int*>(tickets), static_cast<bf16*>(out));
  return cudaGetLastError();
}

cudaError_t launch_prefill_wgmma(const void* q, const void* qr,
                                 const void* c, const void* r, const int* qo,
                                 const int* vlen, void* out, int B, int Tq,
                                 int H, int S, long long cb, long long cs,
                                 long long rb, long long rs, int causal,
                                 float scale, cudaStream_t stream) {
  if (B < 1 || B > 65535 || Tq < 1 || H < 1 || !(scale > 0.f))
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(Tq) * H;
  const long long ctas = (rows + latent::kRows - 1) / latent::kRows;
  if (ctas > 0x7fffffffLL || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaError_t err =
      allow_dynamic_smem<latent::mla_prefill_wgmma_kernel>(latent::kSmem);
  if (err != cudaSuccess) return err;
  latent::mla_prefill_wgmma_kernel<<<dim3(static_cast<unsigned>(ctas), B),
                                     latent::kThreads, latent::kSmem,
                                     stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(qr),
      static_cast<const bf16*>(c), static_cast<const bf16*>(r), qo, vlen, Tq,
      H, S, cb, cs, rb, rs, causal, scale, static_cast<bf16*>(out));
  return cudaGetLastError();
}

}  // namespace

// q [B, H, R] and qr [B, H, Dr] contiguous (one query token), out [B, H, R];
// c [B, S, R] and r [B, S, Dr] with element strides (cb, cs, 1) and (rb, rs,
// 1), 16-byte aligned rows; vlen [B] int32; work: B * splits * H * (R + 2)
// floats; tickets: B ints, 0 on entry (and left 0).  R = 256, Dr = 32, H <=
// 40; splits of `split` positions, splits * split >= S.  The fp32 form
// (mla_split_kernel, CUDA cores).  One launch; returns cudaGetLastError().
extern "C" int flash_decode_mla_launch(const void* q, const void* qr,
                                       const void* c, const void* r,
                                       const void* vlen, void* out,
                                       void* work, void* tickets, int B,
                                       int H, int S, int split, int splits,
                                       long long cb, long long cs,
                                       long long rb, long long rs,
                                       float scale, void* stream) {
  return static_cast<int>(launch_decode_mla<float>(
      q, qr, c, r, static_cast<const int*>(vlen), out, work, tickets, B, H, S,
      split, splits, cb, cs, rb, rs, scale,
      static_cast<cudaStream_t>(stream)));
}

// The bf16 form (mla_decode_wgmma_kernel, tensor cores), the same operands
// in bf16 (every pointer 16-byte aligned): H <= 64, `split` a multiple of
// 64, splits * H * 8 bytes within the tiles' shared memory (the merge's
// weights), scale > 0.  One launch; returns cudaGetLastError().
extern "C" int flash_decode_mla_wgmma_launch(
    const void* q, const void* qr, const void* c, const void* r,
    const void* vlen, void* out, void* work, void* tickets, int B, int H,
    int S, int split, int splits, long long cb, long long cs, long long rb,
    long long rs, float scale, void* stream) {
  return static_cast<int>(launch_decode_wgmma(
      q, qr, c, r, static_cast<const int*>(vlen), out, work, tickets, B, H, S,
      split, splits, cb, cs, rb, rs, scale,
      static_cast<cudaStream_t>(stream)));
}

// q [B, T, H, R] and qr [B, T, H, Dr] contiguous, out [B, T, H, R]; the
// caches as above; qo and vlen [B] int32 (key j is seen by token t when j <
// vlen[b] and, causal, j <= qo[b] + t).  The fp32 form
// (mla_prefill_kernel, CUDA cores).  One launch; returns
// cudaGetLastError().
extern "C" int flash_attention_mla_launch(
    const void* q, const void* qr, const void* c, const void* r,
    const void* qo, const void* vlen, void* out, int B, int Tq, int H, int S,
    long long cb, long long cs, long long rb, long long rs, int causal,
    float scale, void* stream) {
  return static_cast<int>(launch_prefill_mla<float>(
      q, qr, c, r, static_cast<const int*>(qo),
      static_cast<const int*>(vlen), out, B, Tq, H, S, cb, cs, rb, rs, causal,
      scale, static_cast<cudaStream_t>(stream)));
}

// The bf16 form (mla_prefill_wgmma_kernel, tensor cores), the same
// operands in bf16 (every pointer 16-byte aligned), scale > 0.  One
// launch; returns cudaGetLastError().
extern "C" int flash_attention_mla_wgmma_launch(
    const void* q, const void* qr, const void* c, const void* r,
    const void* qo, const void* vlen, void* out, int B, int Tq, int H, int S,
    long long cb, long long cs, long long rb, long long rs, int causal,
    float scale, void* stream) {
  return static_cast<int>(launch_prefill_wgmma(
      q, qr, c, r, static_cast<const int*>(qo),
      static_cast<const int*>(vlen), out, B, Tq, H, S, cb, cs, rb, rs, causal,
      scale, static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of the bf16 forms, in bytes (both kernels).
extern "C" int flash_mla_wgmma_smem() { return latent::kSmem; }
