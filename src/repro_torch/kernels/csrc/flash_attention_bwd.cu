// Flash attention backward from the forward's saved log-sum-exp: P is rebuilt
// tile by tile as exp(s - lse), the paper's (m, d) in log form, so the
// [Tq, Tk] score matrix is never stored.  Two kernels, as in the reference:
//
//   dq    one CTA per (query tile, query head, batch row): streams the key
//         tiles up to the diagonal and accumulates
//         dq = sum_k ds * k,  ds = p * (dp - delta) * scale,  dp = dO . v;
//   dk/dv one CTA per (key tile, KV head, batch row): loops over the G query
//         heads of its group and the query tiles from the diagonal on and
//         accumulates dv = sum_q p * dO and dk = sum_q ds * q.
//
// Replaces: src/repro/kernels/flash_attention_bwd.py,
//   flash_attention_bwd_pallas (line 114; the pallas_calls at :134, dq, and
//   :154, dk/dv), bf16/fp32.
// Bound on the H100: bytes at the training shape (B 8, T 512, 15/5 heads,
//   D 64, bf16, causal): one read of q, k, v, out, dO and lse and one write
//   of dq, dk and dv, 42.1 MB, take 12.6 us at 3.35 TB/s; the five products
//   of 2 * D flops per (row, key) pair below the diagonal, 10.1 GFLOP, take
//   10.2 us at 989 TFLOP/s.  The two kernels recompute S and dP each, 14.1
//   GFLOP in all.  At mistral-nemo-12b's (32/8 heads, D 128): 168.3 MB (50.2
//   us) against 43.0 GFLOP (43.5 us), bytes again; at qwen2-moe-a2.7b's
//   (16/16, D 128) 151.5 MB (45.2 us) against 21.5 GFLOP (21.8 us); at
//   minicpm3-4b's (40/40, Dqk 96, Dv 64) 211.0 MB (63.0 us) against 35.0
//   GFLOP (35.4 us: S, dK and dQ contract or run 96 wide, dP and dV 64).
// Design, both forms: the reference emitted dk/dv per query head
//   ([B, Hq, T, D]) and summed the G heads of a group afterwards
//   (ops.py:196-197); here the dk/dv CTA owns its keys for the whole group,
//   so dk and dv are written once, already reduced, straight into
//   [B, Tk, Hkv, D]: no per-head buffer, no atomics, and every sum runs in
//   a fixed order, so the result does not depend on scheduling (a restarted
//   run reproduces an uninterrupted one bit for bit).  Head dims (Dqk, Dv):
//   (64, 64), (128, 128) or (96, 64) (with_head_dims).  q and dq are
//   [B, Tq, Hq, Dqk], dO [B, Tq, Hq, Dv]; k [B, Tk, Hkv, Dqk] and v
//   [B, Tk, Hkv, Dv] are read in the model layout, each through its own
//   strides, and dk, dv written [B, Tk, Hkv, Dqk] / [B, Tk, Hkv, Dv]; lse
//   and delta = rowsum(dO * O) are [B, Hq, Tq] float32.  Rows
//   past Tq and keys past Tk are masked and never read, so T need not
//   divide by the tile.  The form is chosen by dtype, with no fallback.
//
// bf16 (bwd_dq_wgmma_kernel, bwd_dkv_wgmma_kernel): every product on the
//   tensor cores as wgmma m64n64k16 with fp32 accumulators in registers
//   (wgmma.cuh).  A CTA is one warpgroup owning 64 rows.  dq: Q and dO
//   resident in 128B-swizzled shared memory, lse and delta of its two rows
//   a thread in registers; K and V tiles of 64 keys through a two-stage
//   cp.async ring; per tile S = Q·Kᵀ and dP = dO·Vᵀ, then P = exp2(S·scale·
//   log2 e − lse·log2 e) and dS = P ⊙ (dP − delta)·scale in registers, and
//   dQ += dS·K with dS in bf16 as the register A operand and K read
//   MN-major.  dk/dv: K and V resident; Q and dO tiles of 64 queries, with
//   their lse and delta (staged through registers into the ring's stage,
//   written after the tile's products so the loads overlap them), stream
//   through the ring over the group's G heads; per tile Sᵀ = K·Qᵀ,
//   dPᵀ = V·dOᵀ, Pᵀ and dSᵀ in registers (lse and delta indexed by column),
//   then dV += Pᵀ·dO and dK += dSᵀ·Q with dO and Q read MN-major.  Only the
//   diagonal tile and ragged edge tiles are masked.  CTAs are numbered
//   heaviest first under the causal mask (dq: last query tile first;
//   dk/dv: first key tile first).
//   Head dim D 64 or 128: a tile of D 128 is two 128-byte swizzle atom
//   columns 8 KB apart, as wg::attend lays it out, so S, dP (and Sᵀ, dPᵀ)
//   contract over eight k-steps across both, and dQ, dK and dV are one
//   m64n64 accumulator per atom column, each product reading its operand's
//   column MN-major.  dk/dv then holds dK and dV as 128 fp32 registers a
//   thread: Sᵀ and dPᵀ are declared inside the step, so they are dead
//   through the next step's products rather than held beside them, and the
//   kernel stays under __launch_bounds__(128)'s 255 registers (ptxas's
//   count is printed by chip_smoke.py's build phase).  Shared memory: 49 /
//   51 KB at D 64, 97 / 99 KB at D 128 (dq / dk/dv), allowed at launch.
//   (96, 64), MLA's decompressed form: Q and K tiles are an atom column and
//   half of one (wgmma.cuh), so S and Sᵀ contract over six k-steps and dP,
//   dPᵀ over four; dQ and dK are two m64n64 accumulators whose last 32
//   columns are computed and dropped, dV one (96 fp32 registers a thread
//   in dk/dv); 73 / 75 KB.
// fp32 (bwd_dq_kernel, bwd_dkv_kernel): CUDA cores, 16 owned rows and 16
//   streamed rows a step, fp32 throughout (the path the fp32 train parity
//   holds to 1e-4), at the same pairs.
#include "attention.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kRows = 16;     // rows a CTA owns: queries (dq), keys (dk/dv)
constexpr int kTile = 16;     // rows streamed per step: keys (dq), queries
constexpr int kThreads = 128;
constexpr int kRowThreads = kThreads / kRows;  // 8 threads per owned row

__host__ __device__ constexpr int bwd_smem_words(int Dqk, int Dv) {
  // owned [kRows, Dqk + 1] and [kRows, Dv + 1] operands, streamed ones of
  // kTile rows, two [kRows, kTile] score tiles, two [kRows or kTile] row
  // statistics
  return kRows * (Dqk + Dv + 2) + kTile * (Dqk + Dv + 2) +
         2 * kRows * kTile + 2 * kTile;
}

// Rows [r0, r0 + n) of an operand whose row r starts at base + r * stride
// (its D values contiguous) into shared memory [n, D + 1] as fp32 times
// `mul`; rows at or past `limit` load as 0 without being read.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          size_t base, size_t stride, int r0,
                                          int n, int limit, float mul,
                                          float* dst) {
  for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (r0 + r < limit)
      x = to_f32(src[base + static_cast<size_t>(r0 + r) * stride + c]) * mul;
    dst[r * (D + 1) + c] = x;
  }
}

// lse and delta of rows [r0, r0 + n) of one (batch row, query head), whose
// row r lives at base + r; rows at or past Tq load as 0.
__device__ __forceinline__ void load_stats(const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           size_t base, int r0, int n, int Tq,
                                           float* ls, float* dl) {
  if (threadIdx.x < n) {
    const int r = r0 + threadIdx.x;
    ls[threadIdx.x] = r < Tq ? lse[base + r] : 0.f;
    dl[threadIdx.x] = r < Tq ? delta[base + r] : 0.f;
  }
}

template <typename T, int Dqk, int Dv>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int Tq,
                  int Tk, int Hq, int Hkv, KVStrides st, float scale,
                  int causal) {
  constexpr int kLanes = Dqk / kRowThreads;
  extern __shared__ __align__(16) float smem[];
  const int i0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads, lane = tid % kRowThreads;
  float* qs = smem;                       // [kRows, Dqk + 1], pre-scaled
  float* dos = qs + kRows * (Dqk + 1);    // [kRows, Dv + 1]
  float* ks = dos + kRows * (Dv + 1);     // [kTile, Dqk + 1]
  float* vs = ks + kTile * (Dqk + 1);     // [kTile, Dv + 1]
  float* dss = vs + kTile * (Dv + 1);     // [kRows, kTile] ds
  float* ls = dss + kRows * kTile;        // [kRows] lse
  float* dl = ls + kRows;                 // [kRows] delta

  const size_t qbase = (static_cast<size_t>(b) * Tq * Hq + h) * Dqk;
  const size_t qstride = static_cast<size_t>(Hq) * Dqk;
  const size_t dobase = (static_cast<size_t>(b) * Tq * Hq + h) * Dv;
  const size_t dostride = static_cast<size_t>(Hq) * Dv;
  const size_t kbase = b * st.sb + hk * st.sh;
  const size_t vbase = b * st.vsb + hk * st.vsh;
  load_rows<T, Dqk>(q, qbase, qstride, i0, kRows, Tq, scale, qs);
  load_rows<T, Dv>(dout, dobase, dostride, i0, kRows, Tq, 1.f, dos);
  load_stats(lse, delta, (static_cast<size_t>(b) * Hq + h) * Tq, i0, kRows,
             Tq, ls, dl);
  const int last_row = min(i0 + kRows, Tq) - 1;
  int nb = (Tk + kTile - 1) / kTile;
  if (causal) nb = min(nb, last_row / kTile + 1);

  float acc[kLanes];
#pragma unroll
  for (int c = 0; c < kLanes; ++c) acc[c] = 0.f;
  for (int j = 0; j < nb; ++j) {
    __syncthreads();  // previous tile consumed (q, dO and stats written)
    load_rows<T, Dqk>(k, kbase, st.ss, j * kTile, kTile, Tk, 1.f, ks);
    load_rows<T, Dv>(v, vbase, st.vss, j * kTile, kTile, Tk, 1.f, vs);
    __syncthreads();
    for (int e = tid; e < kRows * kTile; e += kThreads) {
      const int r = e / kTile, t = e % kTile;
      const int q_pos = i0 + r, k_pos = j * kTile + t;
      float ds = 0.f;
      if (q_pos < Tq && k_pos < Tk && (!causal || k_pos <= q_pos)) {
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int c = 0; c < Dqk; ++c)
          s += qs[r * (Dqk + 1) + c] * ks[t * (Dqk + 1) + c];
#pragma unroll 16
        for (int c = 0; c < Dv; ++c)
          dp += dos[r * (Dv + 1) + c] * vs[t * (Dv + 1) + c];
        ds = expf(s - ls[r]) * (dp - dl[r]) * scale;
      }
      dss[e] = ds;
    }
    __syncthreads();
    for (int t = 0; t < kTile; ++t) {
      const float x = dss[row * kTile + t];
#pragma unroll
      for (int c = 0; c < kLanes; ++c)
        acc[c] += x * ks[t * (Dqk + 1) + lane + c * kRowThreads];
    }
  }
  if (i0 + row < Tq) {
    T* o = dq + qbase + static_cast<size_t>(i0 + row) * qstride;
#pragma unroll
    for (int c = 0; c < kLanes; ++c)
      o[lane + c * kRowThreads] = from_f32<T>(acc[c]);
  }
}

template <typename T, int Dqk, int Dv>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int Tq, int Tk, int Hq, int Hkv,
                   KVStrides st, float scale, int causal) {
  constexpr int kKLanes = Dqk / kRowThreads, kVLanes = Dv / kRowThreads;
  extern __shared__ __align__(16) float smem[];
  const int j0 = blockIdx.x * kRows, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads, lane = tid % kRowThreads;
  float* ks = smem;                       // [kRows, Dqk + 1]
  float* vs = ks + kRows * (Dqk + 1);     // [kRows, Dv + 1]
  float* qs = vs + kRows * (Dv + 1);      // [kTile, Dqk + 1]
  float* dos = qs + kTile * (Dqk + 1);    // [kTile, Dv + 1]
  float* ps = dos + kTile * (Dv + 1);     // [kTile, kRows] p
  float* dss = ps + kTile * kRows;        // [kTile, kRows] ds
  float* ls = dss + kTile * kRows;        // [kTile] lse
  float* dl = ls + kTile;                 // [kTile] delta

  load_rows<T, Dqk>(k, b * st.sb + hk * st.sh, st.ss, j0, kRows, Tk, 1.f,
                    ks);
  load_rows<T, Dv>(v, b * st.vsb + hk * st.vsh, st.vss, j0, kRows, Tk, 1.f,
                   vs);
  // causal: the first query tile holding a row at or past key j0
  const int i_first = causal ? j0 / kTile : 0;
  const int nq = (Tq + kTile - 1) / kTile;
  const size_t qstride = static_cast<size_t>(Hq) * Dqk;
  const size_t dostride = static_cast<size_t>(Hq) * Dv;

  float dka[kKLanes], dva[kVLanes];
#pragma unroll
  for (int c = 0; c < kKLanes; ++c) dka[c] = 0.f;
#pragma unroll
  for (int c = 0; c < kVLanes; ++c) dva[c] = 0.f;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qbase = (static_cast<size_t>(b) * Tq * Hq + h) * Dqk;
    const size_t dobase = (static_cast<size_t>(b) * Tq * Hq + h) * Dv;
    for (int i = i_first; i < nq; ++i) {
      __syncthreads();  // previous tile consumed (k, v written at first)
      load_rows<T, Dqk>(q, qbase, qstride, i * kTile, kTile, Tq, 1.f, qs);
      load_rows<T, Dv>(dout, dobase, dostride, i * kTile, kTile, Tq, 1.f,
                       dos);
      load_stats(lse, delta, (static_cast<size_t>(b) * Hq + h) * Tq,
                 i * kTile, kTile, Tq, ls, dl);
      __syncthreads();
      for (int e = tid; e < kTile * kRows; e += kThreads) {
        const int r = e / kRows, t = e % kRows;
        const int q_pos = i * kTile + r, k_pos = j0 + t;
        float p = 0.f, ds = 0.f;
        if (q_pos < Tq && k_pos < Tk && (!causal || k_pos <= q_pos)) {
          float s = 0.f, dp = 0.f;
#pragma unroll 16
          for (int c = 0; c < Dqk; ++c)
            s += qs[r * (Dqk + 1) + c] * ks[t * (Dqk + 1) + c];
#pragma unroll 16
          for (int c = 0; c < Dv; ++c)
            dp += dos[r * (Dv + 1) + c] * vs[t * (Dv + 1) + c];
          p = expf(s * scale - ls[r]);
          ds = p * (dp - dl[r]) * scale;
        }
        ps[e] = p;
        dss[e] = ds;
      }
      __syncthreads();
      for (int r = 0; r < kTile; ++r) {
        const float pv = ps[r * kRows + row], dsv = dss[r * kRows + row];
#pragma unroll
        for (int c = 0; c < kVLanes; ++c)
          dva[c] += pv * dos[r * (Dv + 1) + lane + c * kRowThreads];
#pragma unroll
        for (int c = 0; c < kKLanes; ++c)
          dka[c] += dsv * qs[r * (Dqk + 1) + lane + c * kRowThreads];
      }
    }
  }
  if (j0 + row < Tk) {
    const size_t o = (static_cast<size_t>(b) * Tk + j0 + row) * Hkv + hk;
#pragma unroll
    for (int c = 0; c < kKLanes; ++c)
      dk[o * Dqk + lane + c * kRowThreads] = from_f32<T>(dka[c]);
#pragma unroll
    for (int c = 0; c < kVLanes; ++c)
      dv[o * Dv + lane + c * kRowThreads] = from_f32<T>(dva[c]);
  }
}

// ---- bf16: the tensor-core forms ------------------------------------------
using bf16 = __nv_bfloat16;

// The bf16 forms' V strides: k's where the widths are equal (V at K's
// offsets, as the wrapper requires there, so no register holds a second
// set), v's own at (96, 64).
template <int Dqk, int Dv>
__device__ __forceinline__ KVStrides v_strides(const KVStrides& st) {
  if constexpr (Dqk == Dv) return {st.sb, st.ss, st.sh, st.sb, st.ss, st.sh};
  return st;
}
constexpr float kLog2e = 1.4426950408889634f;
// A dk/dv ring stage at head dims (Dqk, Dv): the Q and dO tiles, then
// lse·log2(e) [64] and delta [64] in fp32 (512 bytes, padded to 1 KB so
// stages stay 1024-aligned).
__host__ __device__ constexpr uint32_t dkv_stage(int Dqk, int Dv) {
  return wg::tile_bytes(Dqk) + wg::tile_bytes(Dv) + 1024;
}
// Dynamic shared memory at head dims (Dqk, Dv), with the 1 KB the base is
// aligned up by: dq holds Q, dO and two stages of (K, V) (49 KB at D 64, 97
// KB at D 128, 73 KB at (96, 64)); dk/dv holds K, V and two stages (51 KB,
// 99 KB, 75 KB).  Past the default 48 KB, so every launch raises the limit
// first.
__host__ __device__ constexpr int dq_smem(int Dqk, int Dv) {
  return 3 * (wg::tile_bytes(Dqk) + wg::tile_bytes(Dv)) + 1024;
}
__host__ __device__ constexpr int dkv_smem(int Dqk, int Dv) {
  return wg::tile_bytes(Dqk) + wg::tile_bytes(Dv) + 2 * dkv_stage(Dqk, Dv) +
         1024;
}

// Row `row` of a [.., 64-wide atom columns] fp32 accumulator set `acc`
// (kCols of them, one per 64 columns) into a bf16 row at `o`, its first
// `width` columns (a product 96 wide drops the last 32 of its second).
template <int kCols, int width>
__device__ __forceinline__ void store_row(bf16* o, const float (&acc)[kCols][32],
                                          int r) {
#pragma unroll
  for (int a = 0; a < kCols; ++a)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (a * wg::kD + 8 * n < width)
        *reinterpret_cast<__nv_bfloat162*>(o + a * wg::kD +
                                           wg::frag_col(4 * n)) =
            __floats2bfloat162_rn(acc[a][4 * n + 2 * r],
                                  acc[a][4 * n + 2 * r + 1]);
}

template <int Dqk, int Dv>
__global__ void __launch_bounds__(wg::kThreads)
    bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int B, int Tq, int Tk, int Hq, int Hkv, KVStrides st,
                        float scale, int causal) {
  extern __shared__ __align__(16) unsigned char tiles[];
  constexpr int R = wg::kRows;
  constexpr uint32_t kKTile = wg::tile_bytes(Dqk), kVTile = wg::tile_bytes(Dv);
  constexpr uint32_t kStage = kKTile + kVTile;
  constexpr int kCols = (Dqk + wg::kD - 1) / wg::kD;  // dQ's accumulators
  const uint32_t sq = wg::aligned_base(tiles), sdo = sq + kKTile;
  const uint32_t skv = sdo + kVTile;  // stage s: K, then V

  // heaviest query tile first: blockIdx.x = (reversed tile, b, h), h fastest
  int bid = blockIdx.x;
  const int h = bid % Hq;
  bid /= Hq;
  const int b = bid % B;
  const int i0 = ((Tq + R - 1) / R - 1 - bid / B) * R;
  const int hk = h / (Hq / Hkv);
  const size_t qstride = static_cast<size_t>(Hq) * Dqk;
  const size_t dostride = static_cast<size_t>(Hq) * Dv;
  const size_t qoff = (static_cast<size_t>(b) * Tq + i0) * qstride + h * Dqk;
  const size_t dooff = (static_cast<size_t>(b) * Tq + i0) * dostride + h * Dv;
  const KVStrides vst = v_strides<Dqk, Dv>(st);
  const bf16* kb = k + b * st.sb + hk * st.sh;
  const bf16* vb = v + b * vst.vsb + hk * vst.vsh;
  wg::load_tile<Dqk>(sq, q + qoff, qstride, Tq - i0);
  wg::load_tile<Dv>(sdo, dout + dooff, dostride, Tq - i0);
  wg::load_tile<Dqk>(skv, kb, st.ss, Tk);
  wg::load_tile<Dv>(skv + kKTile, vb, vst.vss, Tk);
  wg::cp_async_commit();

  int nk = (Tk + R - 1) / R;
  if (causal) nk = min(nk, (min(i0 + R, Tq) - 1) / R + 1);
  const float sl2 = scale * kLog2e;
  const int row0 = wg::frag_row(0);  // this thread's rows: row0, row0 + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + row0 + 8 * r;
    const size_t a = (static_cast<size_t>(b) * Hq + h) * Tq + i;
    lse2[r] = i < Tq ? lse[a] * kLog2e : 0.f;
    dl[r] = i < Tq ? delta[a] : 0.f;
  }
  float acc[kCols][32];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    wg::cp_async_wait_all();
    wg::fence_proxy_async();
    __syncthreads();  // tile j landed; every thread is done with tile j - 1
    if (j + 1 < nk) {
      const uint32_t nxt = skv + ((j + 1) & 1) * kStage;
      const int k0 = (j + 1) * R;
      wg::load_tile<Dqk>(nxt, kb + k0 * st.ss, st.ss, Tk - k0);
      wg::load_tile<Dv>(nxt + kKTile, vb + k0 * vst.vss, vst.vss, Tk - k0);
    }
    wg::cp_async_commit();
    const uint32_t ks = skv + (j & 1) * kStage;
    const uint32_t vs = ks + kKTile;

    // S and dP live within one step: dead once dS's fragments are made
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg::fence_acc(s);
    wg::fence_acc(dp);
    wg::fence();
    wg::gemm_k<Dqk>(s, sq, ks);   // S = Q·Kᵀ
    wg::gemm_k<Dv>(dp, sdo, vs);  // dP = dO·Vᵀ
    wg::commit();
    wg::wait_all();
    wg::fence_acc(s);
    wg::fence_acc(dp);

    const int k0 = j * R;
    const bool edge = k0 + R > Tk || (causal && k0 + R - 1 > i0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(fmaf(s[i], sl2, -lse2[r]));
      if (edge) {
        const int kp = k0 + wg::frag_col(i), qp = i0 + wg::frag_row(i);
        if (kp >= Tk || (causal && kp > qp)) p = 0.f;
      }
      s[i] = p * (dp[i] - dl[r]) * scale;  // dS
    }
    uint32_t f[4][4];
    wg::to_frag(s, f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) wg::fence_acc(acc[c]);
    wg::fence();
#pragma unroll
    for (int c = 0; c < kCols; ++c)  // dQ[:, 64c..] += dS·K[:, 64c..]
      wg::gemm_rs(acc[c], f, ks + c * wg::kTileBytes);
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int c = 0; c < kCols; ++c) wg::fence_acc(acc[c]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (i0 + row0 + 8 * r >= Tq) continue;
    store_row<kCols, Dqk>(dq + qoff + (row0 + 8 * r) * qstride, acc, r);
  }
}

template <int Dqk, int Dv>
__global__ void __launch_bounds__(wg::kThreads)
    bwd_dkv_wgmma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int B,
                         int Tq, int Tk, int Hq, int Hkv, KVStrides st,
                         float scale, int causal) {
  extern __shared__ __align__(16) unsigned char tiles[];
  constexpr int R = wg::kRows;
  constexpr uint32_t kKTile = wg::tile_bytes(Dqk), kVTile = wg::tile_bytes(Dv);
  constexpr uint32_t kStage = dkv_stage(Dqk, Dv);
  constexpr int kKCols = (Dqk + wg::kD - 1) / wg::kD;  // dK's accumulators
  constexpr int kVCols = Dv / wg::kD;                   // dV's
  static_assert(kVCols <= kKCols, "dV is no wider than dK");
  const uint32_t sk = wg::aligned_base(tiles), sv = sk + kKTile;
  const uint32_t ring = sv + kVTile;  // stage s: Q, dO, stats
  // generic pointer to a shared address, for the stats
  auto stats_at = [&](uint32_t addr) {
    return reinterpret_cast<float*>(tiles + (addr - wg::smem_addr(tiles)));
  };

  // heaviest key tile first: blockIdx.x = (key tile, b, KV head)
  int bid = blockIdx.x;
  const int hk = bid % Hkv;
  bid /= Hkv;
  const int b = bid % B;
  const int kt = bid / B, j0 = kt * R;
  const int G = Hq / Hkv;
  const KVStrides vst = v_strides<Dqk, Dv>(st);
  const bf16* kb = k + b * st.sb + hk * st.sh + j0 * st.ss;
  const bf16* vb = v + b * vst.vsb + hk * vst.vsh + j0 * vst.vss;
  wg::load_tile<Dqk>(sk, kb, st.ss, Tk - j0);
  wg::load_tile<Dv>(sv, vb, vst.vss, Tk - j0);

  // the query tiles this key tile meets: from the diagonal on (causal),
  // for each of the group's G heads; tile `it` is (head hk * G + it / ni,
  // query tile iq0 + it % ni)
  const int iq0 = causal ? kt : 0;
  const int ni = max((Tq + R - 1) / R - iq0, 0), total = G * ni;
  const size_t qstride = static_cast<size_t>(Hq) * Dqk;
  const size_t dostride = static_cast<size_t>(Hq) * Dv;
  const int tid = threadIdx.x;
  // issue the copies of tile `it` into stage `stg`, and return its lse·log2
  // e (threads 0-63) or delta (64-127) for the row `tid % 64`, 0 past Tq
  auto fetch = [&](int it, uint32_t stg) {
    const int h = hk * G + it / ni, q0 = (iq0 + it % ni) * R;
    const size_t row = static_cast<size_t>(b) * Tq + q0;
    wg::load_tile<Dqk>(stg, q + row * qstride + h * Dqk, qstride, Tq - q0);
    wg::load_tile<Dv>(stg + kKTile, dout + row * dostride + h * Dv, dostride,
                      Tq - q0);
    const int i = q0 + (tid & 63);
    const size_t a = (static_cast<size_t>(b) * Hq + h) * Tq + i;
    return i >= Tq ? 0.f : tid < 64 ? lse[a] * kLog2e : delta[a];
  };
  if (total > 0) stats_at(ring + kKTile + kVTile)[tid] = fetch(0, ring);
  wg::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float dka[kKCols][32], dva[kVCols][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int c = 0; c < kKCols; ++c) dka[c][i] = 0.f;
#pragma unroll
    for (int c = 0; c < kVCols; ++c) dva[c][i] = 0.f;
  }

  for (int it = 0; it < total; ++it) {
    wg::cp_async_wait_all();
    wg::fence_proxy_async();
    __syncthreads();  // tile it landed; every thread is done with it - 1
    const uint32_t nxt = ring + ((it + 1) & 1) * kStage;
    float pre = 0.f;
    if (it + 1 < total) pre = fetch(it + 1, nxt);
    wg::cp_async_commit();
    const uint32_t qs = ring + (it & 1) * kStage;
    const uint32_t dos = qs + kKTile;
    const float* ls = stats_at(dos + kVTile);
    const float* dl = ls + R;

    // Sᵀ and dPᵀ live within one step: dead once their fragments are made,
    // so at D 128 they do not sit beside dK's and dV's 128 floats a thread
    // through the next step's products
    float sT[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sT[i] = dpt[i] = 0.f;
    wg::fence_acc(sT);
    wg::fence_acc(dpt);
    wg::fence();
    wg::gemm_k<Dqk>(sT, sk, qs);   // Sᵀ = K·Qᵀ
    wg::gemm_k<Dv>(dpt, sv, dos);  // dPᵀ = V·dOᵀ
    wg::commit();
    wg::wait_all();
    wg::fence_acc(sT);
    wg::fence_acc(dpt);

    const int q0 = (iq0 + it % ni) * R;
    const bool edge = q0 + R > Tq || j0 + R > Tk ||
                      (causal && j0 + R - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = wg::frag_col(i);  // query row of the tile
      float p = exp2f(fmaf(sT[i], sl2, -ls[c]));
      if (edge) {
        const int qp = q0 + c, kp = j0 + wg::frag_row(i);
        if (qp >= Tq || kp >= Tk || (causal && kp > qp)) p = 0.f;
      }
      dpt[i] = p * (dpt[i] - dl[c]) * scale;  // dSᵀ
      sT[i] = p;                              // Pᵀ
    }
    uint32_t pf[4][4], df[4][4];
    wg::to_frag(sT, pf);
    wg::to_frag(dpt, df);
#pragma unroll
    for (int c = 0; c < kVCols; ++c) wg::fence_acc(dva[c]);
#pragma unroll
    for (int c = 0; c < kKCols; ++c) wg::fence_acc(dka[c]);
    wg::fence();
#pragma unroll
    for (int c = 0; c < kKCols; ++c) {  // atom column c: values 64c..64c+63
      if (c < kVCols)
        wg::gemm_rs(dva[c], pf, dos + c * wg::kTileBytes);  // dV += Pᵀ·dO
      wg::gemm_rs(dka[c], df, qs + c * wg::kTileBytes);     // dK += dSᵀ·Q
    }
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int c = 0; c < kVCols; ++c) wg::fence_acc(dva[c]);
#pragma unroll
    for (int c = 0; c < kKCols; ++c) wg::fence_acc(dka[c]);
    // the next stage's stats, after this tile's products (no thread reads
    // that stage until the barrier that opens the next step)
    if (it + 1 < total) stats_at(nxt + kKTile + kVTile)[tid] = pre;
  }

  const int row0 = wg::frag_row(0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = j0 + row0 + 8 * r;
    if (kp >= Tk) continue;
    const size_t o = (static_cast<size_t>(b) * Tk + kp) * Hkv + hk;
    store_row<kKCols, Dqk>(dk + o * Dqk, dka, r);
    store_row<kVCols, Dv>(dv + o * Dv, dva, r);
  }
}

template <int Dqk, int Dv>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, int B, int Tq,
                           int Tk, int Hq, int Hkv, KVStrides st, float scale,
                           int causal, cudaStream_t stream) {
  constexpr int kSmem = dq_smem(Dqk, Dv);
  const cudaError_t err =
      allow_dynamic_smem<bwd_dq_wgmma_kernel<Dqk, Dv>>(kSmem);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((Tq + wg::kRows - 1) / wg::kRows) * B * Hq;
  bwd_dq_wgmma_kernel<Dqk, Dv><<<blocks, wg::kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), B, Tq, Tk, Hq, Hkv, st, scale, causal);
  return cudaGetLastError();
}

template <int Dqk, int Dv>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int B,
                            int Tq, int Tk, int Hq, int Hkv, KVStrides st,
                            float scale, int causal, cudaStream_t stream) {
  constexpr int kSmem = dkv_smem(Dqk, Dv);
  const cudaError_t err =
      allow_dynamic_smem<bwd_dkv_wgmma_kernel<Dqk, Dv>>(kSmem);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((Tk + wg::kRows - 1) / wg::kRows) * B * Hkv;
  bwd_dkv_wgmma_kernel<Dqk, Dv><<<blocks, wg::kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Tq, Tk, Hq, Hkv, st,
      scale, causal);
  return cudaGetLastError();
}

// ---- fp32: the CUDA-core forms ---------------------------------------------
// Shared memory of bwd_smem_words(Dqk, Dv) floats: 17 KB at D 64, 35 KB at
// 128, 22 KB at (96, 64), under the default 48 KB.
template <int Dqk, int Dv>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int Tq, int Tk,
                          int Hq, int Hkv, KVStrides st, float scale,
                          int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_words(Dqk, Dv);
  const dim3 grid((Tq + kRows - 1) / kRows, Hq, B);
  bwd_dq_kernel<float, Dqk, Dv><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), Tq, Tk, Hq, Hkv, st, scale, causal);
  return cudaGetLastError();
}

template <int Dqk, int Dv>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv, int B,
                           int Tq, int Tk, int Hq, int Hkv, KVStrides st,
                           float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_words(Dqk, Dv);
  const dim3 grid((Tk + kRows - 1) / kRows, Hkv, B);
  bwd_dkv_kernel<float, Dqk, Dv><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, Hq,
      Hkv, st, scale, causal);
  return cudaGetLastError();
}

static_assert(sizeof(float) * bwd_smem_words(128, 128) <= 48 * 1024,
              "the fp32 backward's shared memory must fit the default 48 KB");

}  // namespace

// q and dq [B, Tq, Hq, Dqk] and dout [B, Tq, Hq, Dv] contiguous; k
// [B, Tk, Hkv, Dqk] with element strides (sb, ss, sh, 1) and v
// [B, Tk, Hkv, Dv] with (vsb, vss, vsh, 1) (bf16: multiples of 8, and every
// pointer 16-byte aligned, for the 16-byte copies; the bf16 forms take v's
// strides equal to k's where Dv == Dqk); lse, delta [B, Hq, Tq] float32.
// (Dqk, Dv) is (64, 64), (128, 128) or (96, 64) (with_head_dims:
// smollm-360m's, mistral-nemo-12b's and qwen2-moe-a2.7b's, minicpm3-4b's
// decompressed MLA), any other pair is refused.  Returns
// cudaGetLastError().
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int B, int Tq,
    int Tk, int Hq, int Hkv, int Dqk, int Dv, long long sb, long long ss,
    long long sh, long long vsb, long long vss, long long vsh, float scale,
    int causal, void* stream) {
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const KVStrides st{sb, ss, sh, vsb, vss, vsh};
  if (dtype != kDtypeF32 && dtype != kDtypeBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_head_dims(Dqk, Dv, [&](auto dqk, auto dv) {
    constexpr int kQK = decltype(dqk)::value, kV = decltype(dv)::value;
    return dtype == kDtypeF32
               ? launch_dq_f32<kQK, kV>(q, k, v, dout, ls, dl, dq, B, Tq, Tk,
                                        Hq, Hkv, st, scale, causal, stm)
               : launch_dq_bf16<kQK, kV>(q, k, v, dout, ls, dl, dq, B, Tq, Tk,
                                         Hq, Hkv, st, scale, causal, stm);
  }));
}

// As above; dk [B, Tk, Hkv, Dqk] and dv [B, Tk, Hkv, Dv] contiguous, in k's
// dtype.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int Tq, int Tk, int Hq, int Hkv, int Dqk, int Dv, long long sb,
    long long ss, long long sh, long long vsb, long long vss, long long vsh,
    float scale, int causal, void* stream) {
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const KVStrides st{sb, ss, sh, vsb, vss, vsh};
  if (dtype != kDtypeF32 && dtype != kDtypeBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_head_dims(Dqk, Dv, [&](auto dqk, auto dvv) {
    constexpr int kQK = decltype(dqk)::value, kV = decltype(dvv)::value;
    return dtype == kDtypeF32
               ? launch_dkv_f32<kQK, kV>(q, k, v, dout, ls, dl, dk, dv, B, Tq,
                                         Tk, Hq, Hkv, st, scale, causal, stm)
               : launch_dkv_bf16<kQK, kV>(q, k, v, dout, ls, dl, dk, dv, B,
                                          Tq, Tk, Hq, Hkv, st, scale, causal,
                                          stm);
  }));
}

// Dynamic shared memory of the bf16 (wgmma) kernels at head dims (Dqk, Dv),
// in bytes.
extern "C" int flash_attention_bwd_dq_wgmma_smem(int Dqk, int Dv) {
  return dq_smem(Dqk, Dv);
}
extern "C" int flash_attention_bwd_dkv_wgmma_smem(int Dqk, int Dv) {
  return dkv_smem(Dqk, Dv);
}
