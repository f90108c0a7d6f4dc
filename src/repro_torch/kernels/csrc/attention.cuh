// Device code shared by the port's attention kernels: where a KV head's
// cache position lives, and the tile loops of the one-token decode and the
// cached-prefill kernels, written once for both cache layouts.
//
// A cache is walked in tiles of `tile` positions.  `Rows::at(j)` is the
// offset of tile j's first position for this (batch row, KV head), and
// `Rows::stride` the offset from one position to the next; the D values of a
// position are contiguous.  Two layouts:
//   PagedRows       block pools [P, Hkv, BS, D] through a block-table row:
//                   tile j is page table[j], tile == BS, stride D;
//   ContiguousRows  a cache in the model layout [B, S, Hkv, D] with strides
//                   (sb, ss, sh, 1): tile j starts at position j * tile,
//                   stride ss.
// Only tiles j < ceil(L / tile) are addressed (so a paged kernel never reads
// a dead table entry), and positions at or past L load as 0 without being
// read (so a contiguous kernel never reads past a row's valid length).
//
// int8 K/V carry a bf16 scale per (position, KV head), addressed by a second
// Rows of the same kind: scale pages [P, Hkv, BS] through the same table
// entry (PagedRows with the scale pool's strides), or scales [B, S, Hkv]
// through their strides (ContiguousRows).  A `Scales` policy multiplies each
// loaded value by its position's scale in fp32, float(int8) * float(bf16),
// the reference's arithmetic; the product is exact in fp32.  `NoScales` (fp
// K/V) does nothing.  Scales of positions at or past L are not read either.
#pragma once

#include "common.cuh"

struct PagedRows {
  const int* table;  // this batch row's M table entries
  size_t page;       // Hkv * BS * D: one physical block of the pool
  size_t head;       // h * BS * D: this KV head inside a block
  size_t stride;     // D
  __device__ size_t at(int j) const {
    return static_cast<size_t>(table[j]) * page + head;
  }
};

struct ContiguousRows {
  size_t base;       // b * sb + h * sh
  size_t step;       // tile * ss
  size_t stride;     // ss
  __device__ size_t at(int j) const { return base + j * step; }
};

struct NoScales {
  __device__ void apply(int, int, float&, float&) const {}
};

template <typename Rows>
struct Scales {
  const __nv_bfloat16* k;  // k_scale (pages or [B, S, Hkv])
  const __nv_bfloat16* v;  // v_scale, the same layout
  Rows rows;               // where tile j's scales start, and their stride
  // position t of tile j: K and V dequantized in place
  __device__ void apply(int j, int t, float& kx, float& vx) const {
    const size_t a = rows.at(j) + t * rows.stride;
    kx *= __bfloat162float(k[a]);
    vx *= __bfloat162float(v[a]);
  }
};

// K and V of tile j into shared memory as fp32: ks [tile, D + 1] (rows
// padded against bank conflicts in the dot products), vs [tile, D].
template <typename KV, int D, typename Rows, typename Sc>
__device__ __forceinline__ void load_kv_tile(const KV* __restrict__ k,
                                             const KV* __restrict__ v,
                                             const Rows& rows, const Sc& sc,
                                             int j, int tile, int L,
                                             float* ks, float* vs) {
  const size_t base = rows.at(j);
  for (int e = threadIdx.x; e < tile * D; e += blockDim.x) {
    const int t = e / D, c = e % D;
    float kx = 0.f, vx = 0.f;
    if (j * tile + t < L) {
      const size_t a = base + t * rows.stride + c;
      kx = to_f32(k[a]);
      vx = to_f32(v[a]);
      sc.apply(j, t, kx, vx);
    }
    ks[t * (D + 1) + c] = kx;
    vs[e] = vx;
  }
}

// fp32 words of shared memory the decode body uses.
__host__ __device__ constexpr int decode_smem_words(int G, int D, int tile) {
  return G * D + tile * (D + 1) + tile * D + G * tile;
}

// One query token of the G query heads of one KV head against positions
// [0, L) of its cache, by one CTA of G * D threads: thread (g, dd) owns
// output element (g, dd) and carries head g's (m, d) redundantly with the
// other threads of its head, so no reduction is needed at the end.  q and
// out hold the group's G * D values contiguously from `q0`.  Columns at or
// past L are masked to -inf before the (m, d, acc) update, which is exact;
// L == 0 gives output 0 (d clamped at 1e-30, as the reference does).  K/V
// are of q's type, or int8 with `sc` their scales.
template <typename T, int D, typename KV, typename Rows,
          typename Sc = NoScales>
__device__ __forceinline__ void decode_attend(
    const T* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const Rows& rows, int L, int tile,
    T* __restrict__ out, size_t q0, int G, float scale, float* smem,
    const Sc& sc = Sc()) {
  const int tid = threadIdx.x, nthr = blockDim.x;  // nthr == G * D
  const int g = tid / D, dd = tid % D;
  float* qs = smem;                      // [G, D], pre-scaled
  float* ks = qs + G * D;                // [tile, D + 1]
  float* vs = ks + tile * (D + 1);       // [tile, D]
  float* ss = vs + tile * D;             // [G, tile] scores

  qs[tid] = to_f32(q[q0 + tid]) * scale;
  const int nb = (L + tile - 1) / tile;
  float m = REPRO_NEG_INF, d = 0.f, acc = 0.f;
  for (int j = 0; j < nb; ++j) {
    __syncthreads();  // the previous tile is no longer read
    load_kv_tile<KV, D>(k, v, rows, sc, j, tile, L, ks, vs);
    __syncthreads();
    for (int e = tid; e < G * tile; e += nthr) {
      const int gg = e / tile, t = e % tile;
      float s = REPRO_NEG_INF;
      if (j * tile + t < L) {
        s = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) s += qs[gg * D + c] * ks[t * (D + 1) + c];
      }
      ss[e] = s;
    }
    __syncthreads();
    // one ⊕ step of Algorithm 3 over this tile, for head g, dim dd
    float mb = REPRO_NEG_INF;
    for (int t = 0; t < tile; ++t) mb = fmaxf(mb, ss[g * tile + t]);
    const float mn = fmaxf(m, mb);
    const float alpha = rescale(m, mn);
    float ds = 0.f, av = 0.f;
    for (int t = 0; t < tile; ++t) {
      const float s = ss[g * tile + t];
      const float p = s == REPRO_NEG_INF ? 0.f : expf(s - mn);
      ds += p;
      av += p * vs[t * D + dd];
    }
    d = d * alpha + ds;
    acc = acc * alpha + av;
    m = mn;
  }
  out[q0 + tid] = from_f32<T>(acc / fmaxf(d, 1e-30f));
}

// The cached-prefill CTA: kPrefillRows query rows, 8 threads per row.
constexpr int kPrefillRows = 16;
constexpr int kPrefillThreads = 128;
constexpr int kPrefillRowThreads = kPrefillThreads / kPrefillRows;  // 8

__host__ __device__ constexpr int prefill_smem_words(int D, int tile) {
  return kPrefillRows * (D + 1) + tile * (D + 1) + tile * D +
         kPrefillRows * tile;
}

// Query rows [i0, i0 + kPrefillRows) of head h of batch row b (q and out in
// the model layout [B, Tq, Hq, D]; rows past Tq are masked, so Tq need not
// divide by the tile) against positions [0, L) of their KV head's cache.
// Scores are masked in absolute coordinates (k_pos <= qo + i when causal)
// and at L before the online (m, d, acc) update; the tile loop stops at the
// last live tile, min(ceil(L / tile), (qo + last row) / tile + 1).  Each
// thread carries its row's (m, d) and D / 8 accumulator lanes.  Writes
// out = acc / max(d, 1e-30) and lse [B, Hq, Tq] = m + log d, or -inf and 0
// for a row with no valid key.  K/V are of q's type, or int8 with `sc`
// their scales.
template <typename T, int D, typename KV, typename Rows,
          typename Sc = NoScales>
__device__ __forceinline__ void prefill_attend(
    const T* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const Rows& rows, int L, int tile, int qo,
    int b, int h, int i0, int Tq, int Hq, T* __restrict__ out,
    float* __restrict__ lse, float scale, int causal, float* smem,
    const Sc& sc = Sc()) {
  constexpr int kLanes = D / kPrefillRowThreads;  // accumulator lanes
  const int tid = threadIdx.x;
  const int row = tid / kPrefillRowThreads, lane = tid % kPrefillRowThreads;
  float* qs = smem;                           // [rows, D + 1], pre-scaled
  float* ks = qs + kPrefillRows * (D + 1);    // [tile, D + 1]
  float* vs = ks + tile * (D + 1);            // [tile, D]
  float* ss = vs + tile * D;                  // [rows, tile] scores

  for (int e = tid; e < kPrefillRows * D; e += kPrefillThreads) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (i0 + r < Tq)
      x = to_f32(q[((static_cast<size_t>(b) * Tq + i0 + r) * Hq + h) * D + c]) *
          scale;
    qs[r * (D + 1) + c] = x;
  }
  const int last_row = min(i0 + kPrefillRows, Tq) - 1;
  int nb = (L + tile - 1) / tile;
  if (causal) nb = min(nb, (qo + last_row) / tile + 1);

  float m = REPRO_NEG_INF, d = 0.f;
  float acc[kLanes];
#pragma unroll
  for (int c = 0; c < kLanes; ++c) acc[c] = 0.f;

  for (int j = 0; j < nb; ++j) {
    __syncthreads();  // previous tile consumed (and qs written, at j == 0)
    load_kv_tile<KV, D>(k, v, rows, sc, j, tile, L, ks, vs);
    __syncthreads();
    for (int e = tid; e < kPrefillRows * tile; e += kPrefillThreads) {
      const int r = e / tile, t = e % tile;
      const int k_pos = j * tile + t, q_pos = qo + i0 + r;
      float s = REPRO_NEG_INF;
      if (i0 + r < Tq && k_pos < L && (!causal || k_pos <= q_pos)) {
        s = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c)
          s += qs[r * (D + 1) + c] * ks[t * (D + 1) + c];
      }
      ss[e] = s;
    }
    __syncthreads();
    // one ⊕ step of Algorithm 3 for this thread's row
    float mb = REPRO_NEG_INF;
    for (int t = 0; t < tile; ++t) mb = fmaxf(mb, ss[row * tile + t]);
    const float mn = fmaxf(m, mb);
    const float alpha = rescale(m, mn);
    float ds = 0.f;
#pragma unroll
    for (int c = 0; c < kLanes; ++c) acc[c] *= alpha;
    for (int t = 0; t < tile; ++t) {
      const float s = ss[row * tile + t];
      const float p = s == REPRO_NEG_INF ? 0.f : expf(s - mn);
      ds += p;
#pragma unroll
      for (int c = 0; c < kLanes; ++c)
        acc[c] += p * vs[t * D + lane + c * kPrefillRowThreads];
    }
    d = d * alpha + ds;
    m = mn;
  }

  const int i = i0 + row;
  if (i < Tq) {
    const float inv = 1.f / fmaxf(d, 1e-30f);
    T* o = out + ((static_cast<size_t>(b) * Tq + i) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < kLanes; ++c)
      o[lane + c * kPrefillRowThreads] = from_f32<T>(acc[c] * inv);
    if (lane == 0)
      lse[(static_cast<size_t>(b) * Hq + h) * Tq + i] =
          d > 0.f ? m + logf(fmaxf(d, 1e-30f)) : REPRO_NEG_INF;
  }
}
