// Device code shared by the port's attention kernels: where a KV head's
// cache position lives, the one-token decode's split and merge bodies, and
// the cached-prefill tile loop, written once for both cache layouts.
//
// A cache is addressed in tiles of `tile` positions.  `Rows::at(j)` is the
// offset of tile j's first position for this (batch row, KV head), and
// `Rows::stride` the offset from one position to the next; the D values of a
// position are contiguous.  Position t lies at at(t / tile) + (t % tile) *
// stride.  Two layouts:
//   PagedRows       block pools [P, Hkv, BS, D] through a block-table row:
//                   tile j is page table[j], tile == BS, stride D;
//   ContiguousRows  a cache in the model layout [B, S, Hkv, D] with strides
//                   (sb, ss, sh, 1): tile j starts at position j * tile,
//                   stride ss.
// Only tiles j < ceil(L / tile) are addressed (so a paged kernel never reads
// a dead table entry), and no position at or past L is read (so a
// contiguous kernel never reads past a row's valid length).
//
// int8 K/V carry a bf16 scale per (position, KV head), addressed by a second
// Rows of the same kind: scale pages [P, Hkv, BS] through the same table
// entry (PagedRows with the scale pool's strides), or scales [B, S, Hkv]
// through their strides (ContiguousRows).  A `Scales` policy multiplies each
// loaded value by its position's scale in fp32, float(int8) * float(bf16),
// the reference's arithmetic; the product is exact in fp32.  `NoScales` (fp
// K/V) does nothing.  Scales of positions at or past L are not read either.
//
// The one-token decode (decode_split) splits a row's key range [0, L) into
// splits of `split` positions, one CTA each; every CTA leaves its partial
// (m, d, acc) of the paper's online softmax in a workspace, and the last of
// a row's live splits to finish ⊕-combines them all in split order
// (decode_merge).
// Both run on the CUDA cores: a decode does ~4 * G flops per K/V value read,
// far below the ~295 flops/byte where the tensor cores would bind, and G
// query rows (3 for smollm-360m) cannot fill a 64-row wgmma tile.
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
  static constexpr bool kScaled = false;
  __device__ void apply(int, int, float&, float&) const {}
};

template <typename Rows>
struct Scales {
  static constexpr bool kScaled = true;
  const __nv_bfloat16* k;  // k_scale (pages or [B, S, Hkv])
  const __nv_bfloat16* v;  // v_scale, the same layout
  Rows rows;               // where tile j's scales start, and their stride
  // the K and V scales of position t of tile j
  __device__ float2 load(int j, int t) const {
    const size_t a = rows.at(j) + t * rows.stride;
    return make_float2(__bfloat162float(k[a]), __bfloat162float(v[a]));
  }
  // position t of tile j: K and V dequantized in place
  __device__ void apply(int j, int t, float& kx, float& vx) const {
    const float2 s = load(j, t);
    kx *= s.x;
    vx *= s.y;
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

// ---- the one-token decode: split the key range, then ⊕-merge -------------
constexpr int kDecodeThreads = 128;  // a split CTA: 4 warps, whatever G and D
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeMaxGroup = 8;   // query heads a KV head (G) at most
constexpr int kLaneDims = 8;         // head dims a lane holds of a position

// Dynamic shared memory of one split CTA, bytes: K and V of `split`
// positions in their storage type (`esz` bytes a value), the int8 forms'
// fp32 K and V scales, the scores [G, split], the warps' accumulators
// [warps, G, D] and each head's (m, d).  Every array starts 16-byte aligned
// when D * esz is a multiple of 16.
__host__ __device__ constexpr size_t decode_split_smem(int G, int D, int esz,
                                                       int split,
                                                       bool scaled) {
  return 2 * static_cast<size_t>(split) * D * esz +
         (scaled ? 2 * static_cast<size_t>(split) * 4 : 0) +
         static_cast<size_t>(G) * split * 4 +
         static_cast<size_t>(kDecodeWarps) * G * D * 4 +
         2 * kDecodeMaxGroup * 4;
}

// Lane `li` of a position's D / kLaneDims lanes: its kLaneDims values of a
// K or V row in shared memory as fp32, in one 16-byte load (bf16), one
// 8-byte load (int8) or two 16-byte loads (fp32, one from each half of the
// row, so a quarter-warp's loads fall on distinct banks).
template <int D>
__device__ __forceinline__ void lane_values(const __nv_bfloat16* row, int li,
                                            float (&x)[kLaneDims]) {
  const uint4 u = *reinterpret_cast<const uint4*>(row + kLaneDims * li);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <int D>
__device__ __forceinline__ void lane_values(const signed char* row, int li,
                                            float (&x)[kLaneDims]) {
  const int2 u = *reinterpret_cast<const int2*>(row + kLaneDims * li);
  const signed char* c = reinterpret_cast<const signed char*>(&u);
#pragma unroll
  for (int i = 0; i < kLaneDims; ++i) x[i] = static_cast<float>(c[i]);
}
template <int D>
__device__ __forceinline__ void lane_values(const float* row, int li,
                                            float (&x)[kLaneDims]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * li);
  const float4 b = *reinterpret_cast<const float4*>(row + D / 2 + 4 * li);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// The head dim of lane li's value i in lane_values' order.
template <typename KV, int D>
__device__ __forceinline__ int lane_dim(int li, int i) {
  if constexpr (sizeof(KV) == 4) {
    return i < 4 ? 4 * li + i : D / 2 + 4 * li + i - 4;
  } else {
    return kLaneDims * li + i;
  }
}

// The merge of one (batch row, KV head): the paper's ⊕ over its `live`
// split partials in split order, m = max m_i, d = Σ d_i e^{m_i - m} and acc
// likewise (``rescale`` pins a -inf/-inf pair to 1), then out = acc /
// max(d, 1e-30).  `out` and the partials start at this group's first head.
// A thread takes an output element and walks the splits kDecodeMergeBatch
// at a time, all of a batch's loads in flight before the first ⊕ step (one
// L2 round trip a batch, not one a split); the order of the steps is the
// splits' order.  The partials come from other CTAs' writes, so they are
// read from L2 (__ldcg), past this SM's L1.
constexpr int kDecodeMergeBatch = 8;

template <typename T>
__device__ __forceinline__ void decode_merge(const float* __restrict__ part_acc,
                                             const float2* __restrict__ part_md,
                                             int live, int G, int D,
                                             T* __restrict__ out) {
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D;
    float m = REPRO_NEG_INF, d = 0.f, a = 0.f;
    for (int i0 = 0; i0 < live; i0 += kDecodeMergeBatch) {
      float2 md[kDecodeMergeBatch];
      float ac[kDecodeMergeBatch];
#pragma unroll
      for (int j = 0; j < kDecodeMergeBatch; ++j) {
        const int i = i0 + j;
        md[j] = i < live ? __ldcg(part_md + i * G + g)
                         : make_float2(REPRO_NEG_INF, 0.f);
        ac[j] = i < live
                    ? __ldcg(part_acc + static_cast<size_t>(i) * G * D + e)
                    : 0.f;
      }
      float mn = m;
#pragma unroll
      for (int j = 0; j < kDecodeMergeBatch; ++j) mn = fmaxf(mn, md[j].x);
      const float r = rescale(m, mn);
      d *= r;
      a *= r;
#pragma unroll
      for (int j = 0; j < kDecodeMergeBatch; ++j) {
        const float w = rescale(md[j].x, mn);
        d += md[j].y * w;
        a += ac[j] * w;
      }
      m = mn;
    }
    out[e] = from_f32<T>(a / fmaxf(d, 1e-30f));
  }
}

// One split of a one-token decode: the G query heads of one KV head (q,
// out and the workspace rows from `q0` / `part_*`) against positions
// [s0, s0 + n) of its cache, s0 = blockIdx.x * split and n = min(split,
// L - s0).  A CTA whose split starts at or past L returns before reading
// anything (split 0 of a row with L == 0 writes its output, 0, first).
//   1. Every K/V row of the split goes out as 16-byte cp.async copies into
//      shared memory before any is waited on (and the int8 forms' scales as
//      plain loads); q of the G heads is loaded, pre-scaled, into registers
//      while they land.
//   2. Scores: D / 8 lanes take a position, 8 head dims each; a warp takes
//      32 / (D / 8) positions at once; G dot products per position, each
//      reduced by a shuffle tree.
//   3. One warp a head takes the split's max and one expf per (head,
//      position), overwriting the score with its weight, and their sum d.
//   4. P·V with the same lanes over D, positions spread over the CTA's
//      position groups, then a shuffle tree over a warp's groups and a sum
//      over the warps in order.
//   5. The partial, acc [G, D] (unnormalized) and (m, d) per head, goes to
//      the workspace; after a fence, the CTA takes a ticket from this (row,
//      head)'s counter, and the one that takes the last of the row's live
//      splits, ceil(L / split), merges them all (decode_merge) into `out`
//      and sets the counter back to 0 for the next call.
// Every reduction and the merge run in a fixed order whichever CTA merges,
// so a call is bit-identical from run to run.  K/V are of q's type, or
// int8 with `sc` their scales.
template <typename T, int D, typename KV, typename Rows,
          typename Sc = NoScales>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const Rows& rows, int tile, int L, int split,
    size_t q0, int G, float scale, float* __restrict__ part_acc,
    float2* __restrict__ part_md, int* __restrict__ ticket,
    T* __restrict__ out, unsigned char* smem, const Sc& sc = Sc()) {
  constexpr int kLanes = D / kLaneDims;              // lanes a position
  constexpr int kPerWarp = 32 / kLanes;              // positions a warp pass
  constexpr int kGroups = kDecodeThreads / kLanes;   // positions a CTA pass
  constexpr int kVec = 16 / sizeof(KV);              // values a 16-byte copy
  constexpr int kChunks = D / kVec;                  // copies a row
  static_assert(kLanes >= 1 && kLanes <= 32 && 32 % kLanes == 0,
                "D / 8 lanes must divide a warp");
  const int s0 = blockIdx.x * split;
  if (s0 >= L) {                                     // uniform: a dead split
    if (L == 0 && blockIdx.x == 0) {                 // no valid position
      for (int e = threadIdx.x; e < G * D; e += kDecodeThreads)
        out[q0 + e] = from_f32<T>(0.f);
    }
    return;
  }
  const int n = min(split, L - s0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = lane % kLanes, sub = lane / kLanes;
  KV* ks = reinterpret_cast<KV*>(smem);              // [split, D]
  KV* vs = ks + static_cast<size_t>(split) * D;      // [split, D]
  float* ksc = reinterpret_cast<float*>(vs + static_cast<size_t>(split) * D);
  float* vsc = ksc + (Sc::kScaled ? split : 0);
  float* ss = vsc + (Sc::kScaled ? split : 0);       // [G, split]
  float* red = ss + G * split;                       // [warps, G, D]
  float* hm = red + kDecodeWarps * G * D;            // [G] split max
  float* hd = hm + kDecodeMaxGroup;                  // [G] split sum

  // 1. the split's K/V in flight at once, then q while they land
  for (int e = tid; e < n * kChunks; e += kDecodeThreads) {
    const int p = e / kChunks, c = e % kChunks, t = s0 + p;
    const size_t a = rows.at(t / tile) +
                     static_cast<size_t>(t % tile) * rows.stride + c * kVec;
    const int o = p * D + c * kVec;
    cp_async16(smem_addr(ks + o), k + a);
    cp_async16(smem_addr(vs + o), v + a);
  }
  cp_async_commit();
  if constexpr (Sc::kScaled) {
    for (int p = tid; p < n; p += kDecodeThreads) {
      const int t = s0 + p;
      const float2 s = sc.load(t / tile, t % tile);
      ksc[p] = s.x;
      vsc[p] = s.y;
    }
  }
  float qr[kDecodeMaxGroup][kLaneDims];
#pragma unroll
  for (int g = 0; g < kDecodeMaxGroup; ++g) {
#pragma unroll
    for (int i = 0; i < kLaneDims; ++i)
      qr[g][i] = g < G ? to_f32(q[q0 + g * D + lane_dim<KV, D>(li, i)]) * scale
                       : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. scores [G, n]
  for (int p0 = warp * kPerWarp; p0 < n; p0 += kGroups) {  // warp-uniform
    const int p = p0 + sub;
    float x[kLaneDims];
    if (p < n) {
      lane_values<D>(ks + p * D, li, x);
      if constexpr (Sc::kScaled) {
#pragma unroll
        for (int i = 0; i < kLaneDims; ++i) x[i] *= ksc[p];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kLaneDims; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < kDecodeMaxGroup; ++g) {
      if (g >= G) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kLaneDims; ++i) s = fmaf(qr[g][i], x[i], s);
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (p < n && li == 0) ss[g * split + p] = s;
    }
  }
  __syncthreads();

  // 3. per head: the split's max, one expf a (head, position), their sum
  for (int g = warp; g < G; g += kDecodeWarps) {
    float* sg = ss + g * split;
    float m = REPRO_NEG_INF;
    for (int p = lane; p < n; p += 32) m = fmaxf(m, sg[p]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float d = 0.f;
    for (int p = lane; p < n; p += 32) {
      const float w = expf(sg[p] - m);
      sg[p] = w;
      d += w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    if (lane == 0) {
      hm[g] = m;
      hd[g] = d;
    }
  }
  __syncthreads();

  // 4. P·V: lanes over D, positions over the CTA's groups
  float acc[kDecodeMaxGroup][kLaneDims];
#pragma unroll
  for (int g = 0; g < kDecodeMaxGroup; ++g) {
#pragma unroll
    for (int i = 0; i < kLaneDims; ++i) acc[g][i] = 0.f;
  }
  for (int p = warp * kPerWarp + sub; p < n; p += kGroups) {
    float x[kLaneDims];
    lane_values<D>(vs + p * D, li, x);
    if constexpr (Sc::kScaled) {
#pragma unroll
      for (int i = 0; i < kLaneDims; ++i) x[i] *= vsc[p];
    }
#pragma unroll
    for (int g = 0; g < kDecodeMaxGroup; ++g) {
      if (g >= G) break;
      const float w = ss[g * split + p];
#pragma unroll
      for (int i = 0; i < kLaneDims; ++i) acc[g][i] = fmaf(w, x[i], acc[g][i]);
    }
  }
#pragma unroll
  for (int g = 0; g < kDecodeMaxGroup; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int i = 0; i < kLaneDims; ++i) {
#pragma unroll
      for (int off = kLanes; off < 32; off <<= 1)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
      if (sub == 0)
        red[(warp * G + g) * D + lane_dim<KV, D>(li, i)] = acc[g][i];
    }
  }
  __syncthreads();

  // 5. the split's partial: acc summed over the warps in order, (m, d);
  //    then the ticket, and the last live split merges
  const size_t part = blockIdx.x;
  for (int e = tid; e < G * D; e += kDecodeThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) a += red[w * G * D + e];
    part_acc[part * G * D + e] = a;
  }
  if (tid < G) part_md[part * G + tid] = make_float2(hm[tid], hd[tid]);
  __shared__ int last;
  const int live = (L + split - 1) / split;
  __threadfence();                  // the partial is visible before the ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                  // every other split's partial is visible
  decode_merge(part_acc, part_md, live, G, D, out + q0);
  if (tid == 0) *ticket = 0;        // every live split has taken its ticket
}

// The workspace of a decode call: part_acc [B, Hkv, splits, G, D] fp32, then
// part_md [B, Hkv, splits, G] float2 (m, d).  The ticket counters, B * Hkv
// ints, live apart: 0 before a call and 0 after it.
inline float2* decode_part_md(void* work, int B, int Hkv, int splits, int G,
                              int D) {
  return reinterpret_cast<float2*>(static_cast<float*>(work) +
                                   static_cast<size_t>(B) * Hkv * splits * G *
                                       D);
}

// Whether a decode call's geometry is one the kernels take: G query heads a
// KV head (at most kDecodeMaxGroup), a split of at least one position, and
// the split CTA's shared memory within the card's 227 KB.
inline bool decode_geometry_ok(int Hq, int Hkv, int split, int splits,
                               size_t smem) {
  return Hkv > 0 && Hq % Hkv == 0 && Hq / Hkv >= 1 &&
         Hq / Hkv <= kDecodeMaxGroup && split > 0 && splits > 0 &&
         smem <= 232448;
}

// Launch a split kernel over grid (splits, Hkv, B) with `smem` bytes of
// dynamic shared memory; its last live split of each (row, head) merges.
template <typename T, typename Kernel, typename... Args>
cudaError_t launch_decode(Kernel kernel, size_t smem, int B, int Hq, int Hkv,
                          int D, int split, int splits, void* out, void* work,
                          void* tickets, cudaStream_t stream, Args... args) {
  if (!decode_geometry_ok(Hq, Hkv, split, splits, smem))
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(splits, Hkv, B), kDecodeThreads, smem, stream>>>(
      args..., static_cast<float*>(work),
      decode_part_md(work, B, Hkv, splits, Hq / Hkv, D),
      static_cast<int*>(tickets), static_cast<T*>(out));
  return cudaGetLastError();
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
