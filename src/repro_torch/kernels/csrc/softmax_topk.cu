// Fused softmax + top-k over the rows of x [R, V]: the paper's Algorithm 4,
// in one launch.
//
// Replaces: src/repro/kernels/softmax_topk.py, softmax_topk_pallas (the
//   pallas_call at line 100; body _make_kernel:44, _select_topk:26).
// Bound on the H100: bytes.  Each logit is read once and only O(k) values
//   per row are written, so the floor is R*V*sizeof(x) over 3.35 TB/s; the
//   per-element work (a max, an exp, a compare) is far below the FLOP rate.
//   At the serving path's [8, 49152] the floor is 0.5 us: there the kernel
//   is bound by the latency of its dependent steps, not by either rate.
// Design: on the serving path R is the decode batch (4..8) and V = 49152, so
//   one CTA a row would leave most of the 132 SMs idle; the library also
//   takes thousands of rows.  softmax_topk.plan (kernels/softmax_topk.py), a
//   pure function of (R, V, k, dtype, SMs), gives S slices a row of sv
//   16-byte vectors each, the CTA's threads and the vectors a thread loads
//   at a time: S = 1 when the rows alone fill the card, else slices short
//   enough for about two CTAs an SM, one vector a thread where it can.
//   * grid (R rows, S slices), rows on grid.x so any R < 2^31 fits.  CTA
//     (r, s) streams body vectors [s * sv, (s + 1) * sv) of row r as 16-byte
//     loads, L (1 or 4) in flight a thread; slice 0 also takes the row's
//     scalar head (up to its first 16-byte boundary) and tail, so a row may
//     start anywhere and V need not be a multiple of the vector.  Each
//     thread keeps its (m, d); each warp keeps its best k entries as one
//     sorted list across its lanes (WarpTopK), whose k-th entry is a
//     threshold: a batch with no entry above it costs a compare an entry
//     and one vote.  (A sorted list a thread costs the whole warp an
//     insertion for almost every entry: some lane nearly always has one.)
//     The warp's first batch of up to 8 entries a lane fills the list by
//     sorting each lane's entries and popping the warp's best k; later
//     entries that beat the threshold are inserted by a ballot and a
//     shuffle.  A warp's arg-max is two redux.sync reductions on an
//     order-preserving key, not a tree of shuffles: with ~24 warps an SM
//     selecting at once, the SM's issue and shuffle throughput binds.
//   * (m, d) reduce max first, then each partial rescaled to it once and
//     summed, so no chain of exps waits on another.  The CTA meets once:
//     each warp leaves its (m, d) and its list in shared memory, and warp 0
//     takes the CTA's (m, d) and its top k (k rounds of a warp arg-max over
//     the warps' lists); the other warps are done.
//   * S == 1: warp 0 writes the row's outputs.  S > 1: warp 0 writes the
//     slice's partial (m, d, u[k], p[k]) and takes a ticket from its row's
//     counter (an acquire-release atomic; each counter on a 128-byte line
//     of its own, so the rows' CTAs do not queue on one line).  The row's
//     last warp 0 loads the S partials into shared memory in one round trip
//     (every load issued before any is used) and merges: (m, d) over
//     the slices in a fixed order (lane l takes slices l and l + 32), the
//     top k by k rounds of a warp arg-max over the slices' sorted lists
//     (S <= 64: lane l holds the heads of slices l and l + 32 in
//     registers).  It writes vals = exp(u - m) / d, the int32 indices and
//     lse = m + log d, and sets the counter back to 0.  The merge's order
//     is fixed by the slice index, so which CTA merges changes no bit.
//   Every comparison orders by (value descending, index ascending), so exact
//   ties, also across slice edges, resolve to the lowest index as
//   lax.top_k's do.  -inf logits (a padded vocabulary) leave d unchanged; a
//   slice that is all -inf contributes (-inf, 0) and its lowest indices as
//   -inf candidates, with no NaN.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxK = 32;
constexpr int kMaxSlices = 64;     // two slices' lists a lane in the merge
constexpr int kMaxFill = 8;        // entries a lane sorts in the first fill
constexpr int kTicketStride = 32;  // a row's ticket: a 128-byte line alone
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// An unsigned key that orders as the float does (-0 taken as +0, so it
// ties with +0 as the comparisons above do), and back.
__device__ __forceinline__ unsigned okey(float f) {
  const unsigned b = __float_as_uint(f + 0.f);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float ofloat(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

// The warp's best (v, i) by (value desc, index asc), to every lane: two
// hardware reductions (redux.sync), the max key, then the least index
// among the lanes that hold it.
__device__ __forceinline__ void warp_best(float& v, int& i) {
  const unsigned key = okey(v);
  const unsigned best = __reduce_max_sync(kFull, key);
  i = static_cast<int>(__reduce_min_sync(
      kFull, key == best ? static_cast<unsigned>(i) : 0xffffffffu));
  v = ofloat(best);
}

__device__ __forceinline__ void swap_if_better(float& a, int& ia, float& b,
                                               int& ib) {
  if (better(b, ib, a, ia)) {
    const float t = a;
    const int ti = ia;
    a = b;
    ia = ib;
    b = t;
    ib = ti;
  }
}

// The best k (value, index) pairs a warp has seen, best first, one a lane:
// lane l < k holds the l-th; the other lanes, and places not yet filled,
// hold the sentinel (-inf, INT_MAX), which loses to every entry.  Lane
// k - 1's pair is the threshold an entry must beat to enter; tv, its value,
// is what each lane compares a batch with.  Every member is
// warp-collective (all 32 lanes call it).
struct WarpTopK {
  float v, tv;
  int i, k;
  bool filled;  // the first batch has been taken (warp-uniform)

  __device__ __forceinline__ void init(int k_) {
    k = k_;
    v = tv = REPRO_NEG_INF;
    i = INT_MAX;
    filled = false;
  }
  // insert (wv, wi), which beats the threshold, keeping the lanes sorted
  __device__ __forceinline__ void insert(float wv, int wi) {
    const int lane = threadIdx.x & 31;
    const int pos =
        __popc(__ballot_sync(kFull, lane < k && better(v, i, wv, wi)));
    const float pv = __shfl_up_sync(kFull, v, 1);
    const int pi = __shfl_up_sync(kFull, i, 1);
    if (lane == pos) {
      v = wv;
      i = wi;
    } else if (lane > pos && lane < k) {
      v = pv;
      i = pi;
    }
  }
  // The first batch into the empty list: each lane sorts its E <= 8
  // entries (odd-even transposition), then k rounds of a warp arg-max over
  // the lanes' heads; round t's winner is the t-th best, lane t keeps it,
  // and the winning lane pops its head.
  template <int E>
  __device__ __forceinline__ void fill(float (&x)[E], int (&ix)[E]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int p = 0; p < E; ++p)
#pragma unroll
      for (int e = p & 1; e + 1 < E; e += 2)
        swap_if_better(x[e], ix[e], x[e + 1], ix[e + 1]);
    for (int t = 0; t < k; ++t) {
      float wv = x[0];
      int wi = ix[0];
      warp_best(wv, wi);
      if (lane == t) {
        v = wv;
        i = wi;
      }
      if (ix[0] == wi && x[0] == wv) {  // only the sentinel repeats
#pragma unroll
        for (int e = 0; e + 1 < E; ++e) {
          x[e] = x[e + 1];
          ix[e] = ix[e + 1];
        }
        x[E - 1] = REPRO_NEG_INF;
        ix[E - 1] = INT_MAX;
      }
    }
    tv = __shfl_sync(kFull, v, k - 1);
    filled = true;
  }
  // Alg. 4 lines 8-15 for a warp: each lane's E entries (x[e], ix[e]) are
  // offered (padding is (-inf, INT_MAX)).  The warp's first batch fills
  // the list when E <= 8.  Else a batch with no entry at or above tv costs
  // a compare an entry and one vote (most batches, once the list holds k
  // entries); otherwise, in rounds, each lane proposes its best entry below
  // the last one it gave, the warp takes the best proposal and, while it
  // beats the threshold (one ballot), inserts it.
  template <int E>
  __device__ __forceinline__ void take(float (&x)[E], int (&ix)[E]) {
    if constexpr (E <= kMaxFill) {
      if (!filled) {
        fill(x, ix);
        return;
      }
    }
    filled = true;
    bool any = false;
#pragma unroll
    for (int e = 0; e < E; ++e) any |= x[e] >= tv;
    if (!__any_sync(kFull, any)) return;
    const int lane = threadIdx.x & 31;
    float cv = CUDART_INF_F;  // the last entry this lane gave
    int ci = -1;
    while (true) {
      float bv = REPRO_NEG_INF;
      int bi = INT_MAX;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (better(cv, ci, x[e], ix[e]) && better(x[e], ix[e], bv, bi)) {
          bv = x[e];
          bi = ix[e];
        }
      }
      float wv = bv;
      int wi = bi;
      warp_best(wv, wi);
      if (!__any_sync(kFull, lane == k - 1 && better(wv, wi, v, i))) break;
      if (bi == wi) {  // this lane's entry won (indices unique)
        cv = bv;
        ci = bi;
      }
      insert(wv, wi);
    }
    tv = __shfl_sync(kFull, v, k - 1);
  }
};

// A batch of entries into the thread's (m, d) (Alg. 3 lines 4-5): one
// rescale for the batch's max, then exp(x - m) = exp2((x - m) log2 e) an
// entry (-inf entries add 0).
template <int E>
__device__ __forceinline__ void md_take(const float (&x)[E], float& m,
                                        float& d) {
  float bm = x[0];
#pragma unroll
  for (int e = 1; e < E; ++e) bm = fmaxf(bm, x[e]);
  if (bm > m) {
    d *= rescale(m, bm);
    m = bm;
  }
  if (m != REPRO_NEG_INF) {
#pragma unroll
    for (int e = 0; e < E; ++e) d += exp2f((x[e] - m) * kLog2e);
  }
}

// The warp's (m, d) from its lanes', to every lane: the max (redux.sync),
// then each lane's d rescaled to it and summed by a fixed shuffle tree.
__device__ __forceinline__ void warp_md(float& m, float& d) {
  const float wm = ofloat(__reduce_max_sync(kFull, okey(m)));
  d = wm == REPRO_NEG_INF ? 0.f : d * rescale(m, wm);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
  m = wm;
}

// A 16-byte vector of T as floats.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* v) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  } else {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);          // low bf16
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// Slice s of a row of V entries at `row`, by the whole CTA: the head
// scalars up to the first 16-byte boundary and the tail scalars after the
// last whole vector (slice 0, warp 0, when the row has any: lane t < kVec
// takes entry t of each), then body vectors [s * sv, (s + 1) * sv) in
// CTA-wide batches of L vectors a thread (a block-uniform trip count: take
// is warp-collective).
template <typename T, int L>
__device__ void scan(const T* __restrict__ row, int V, int s, int sv,
                     float& m, float& d, WarpTopK& w) {
  constexpr int W = kVec<T>;
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15) /
                  static_cast<int>(sizeof(T));
  const int head = min(off == 0 ? 0 : W - off, V);
  const int nv = (V - head) / W;
  const int tail = V - head - nv * W;
  const int tid = threadIdx.x;
  if (s == 0 && tid < 32 && head + tail > 0) {
    const int ti = head + nv * W + tid;
    float x[2] = {tid < head ? to_f32(row[tid]) : REPRO_NEG_INF,
                  tid < tail ? to_f32(row[ti]) : REPRO_NEG_INF};
    int ix[2] = {tid < head ? tid : INT_MAX, tid < tail ? ti : INT_MAX};
    md_take(x, m, d);
    w.take(x, ix);
  }
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  const int lo = s * sv, hi = min(nv, lo + sv), step = blockDim.x;
  for (int j0 = lo; j0 < hi; j0 += L * step) {
    // the L loads all issued before any is used (a vector past the slice
    // reads the slice's last, then counts as padding)
    uint4 raw[L];
#pragma unroll
    for (int u = 0; u < L; ++u)
      raw[u] = __ldcs(body + min(j0 + u * step + tid, hi - 1));  // read once
    float x[L * W];
    int ix[L * W];
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int jj = j0 + u * step + tid;
      unpack16<T>(raw[u], x + u * W);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        if (jj >= hi) x[u * W + e] = REPRO_NEG_INF;
        ix[u * W + e] = jj < hi ? head + jj * W + e : INT_MAX;
      }
    }
    md_take(x, m, d);
    w.take(x, ix);
  }
}

// Shared memory of the CTA's one meeting: each warp's (m, d) and list.
struct Meet {
  float wm[kMaxWarps], wd[kMaxWarps];
  float wu[kMaxWarps][kMaxK];
  int wp[kMaxWarps][kMaxK];
};

// Warp 0, after the meeting: the CTA's (m, d) (every lane: the warps'
// partials rescaled to their max and summed in warp order) and its top k
// (lane t < k holds the t-th in (u, p)): k rounds of a warp arg-max over
// the warps' sorted lists, lane w holding a cursor into warp w's.
__device__ void cta_result(const Meet& meet, int k, float& m, float& d,
                           float& u, int& p) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  m = REPRO_NEG_INF;
  for (int w = 0; w < nwarps; ++w) m = fmaxf(m, meet.wm[w]);
  d = 0.f;
  if (m != REPRO_NEG_INF)
    for (int w = 0; w < nwarps; ++w) d += meet.wd[w] * rescale(meet.wm[w], m);
  u = REPRO_NEG_INF;
  p = INT_MAX;
  int h = 0;
  for (int t = 0; t < k; ++t) {
    const bool mine = lane < nwarps && h < k;
    const float hv = mine ? meet.wu[lane][h] : REPRO_NEG_INF;
    const int hi = mine ? meet.wp[lane][h] : INT_MAX;
    float v = hv;
    int i = hi;
    warp_best(v, i);
    if (mine && hv == v && hi == i) ++h;  // only the sentinel repeats
    if (lane == t) {
      u = v;
      p = i;
    }
  }
}

// A ticket: the old count of an atomic add of 1 with acquire-release
// semantics at device scope, so the partial written before it is visible to
// the CTA that takes the last ticket, and the partials of all the others
// are visible to it after.
__device__ __forceinline__ int take_ticket(int* t) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(t)
               : "memory");
  return old;
}

// The row's outputs, by warp 0: lane t < k writes the t-th of the top k.
template <typename T>
__device__ __forceinline__ void write_row(size_t r, int k, float m, float d,
                                          float u, int p,
                                          T* __restrict__ vals,
                                          int* __restrict__ idx,
                                          float* __restrict__ lse) {
  const int lane = threadIdx.x & 31;
  if (lane < k) {
    vals[r * k + lane] = from_f32<T>(expf(u - m) / d);
    idx[r * k + lane] = p;
  }
  if (lane == 0) lse[r] = m + logf(d);
}

// The head of entry c of slice j's sorted list, or the sentinel past its
// k entries or past the S slices.
__device__ __forceinline__ void list_head(const float* cu, const int* cp,
                                          int j, int c, int S, int k,
                                          float& v, int& i) {
  const bool ok = j < S && c < k;
  v = ok ? cu[j * k + c] : REPRO_NEG_INF;
  i = ok ? cp[j * k + c] : INT_MAX;
}

// The row's last CTA, warp 0: the S partials into shared memory (one round
// trip), (m, d) over the slices (lane l: slices l and l + 32, rescaled to
// the row's max and summed in a fixed order), then the top k by k rounds
// of a warp arg-max over the slices' sorted lists, lane l holding the
// heads of slices l and l + 32 in registers.
template <typename T>
__device__ void merge_row(size_t r, int S, int k,
                          const float* __restrict__ part_md,
                          const float* __restrict__ part_u,
                          const int* __restrict__ part_p, float* cu,
                          T* __restrict__ vals, int* __restrict__ idx,
                          float* __restrict__ lse) {
  const int lane = threadIdx.x & 31, n = S * k;
  int* cp = reinterpret_cast<int*>(cu + n);
  float sm[2], sd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t j = r * S + min(lane + 32 * h, S - 1);
    sm[h] = __ldcg(part_md + 2 * j);
    sd[h] = __ldcg(part_md + 2 * j + 1);
    if (lane + 32 * h >= S) {
      sm[h] = REPRO_NEG_INF;
      sd[h] = 0.f;
    }
  }
  // kChunk loads a lane issued before any is used: no load waits behind a
  // select on the one before (indices past n read the last entry, unused)
  constexpr int kChunk = 8;
  for (int j0 = lane; j0 < n; j0 += 32 * kChunk) {
    float a[kChunk];
    int b[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const size_t j = r * n + min(j0 + 32 * c, n - 1);
      a[c] = __ldcg(part_u + j);
      b[c] = __ldcg(part_p + j);
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int j = j0 + 32 * c;
      if (j < n) {
        cu[j] = a[c];
        cp[j] = b[c];
      }
    }
  }
  __syncwarp();
  const float m = ofloat(__reduce_max_sync(kFull, okey(fmaxf(sm[0], sm[1]))));
  float d = 0.f;
  if (m != REPRO_NEG_INF)
    d = sd[0] * rescale(sm[0], m) + sd[1] * rescale(sm[1], m);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);

  int c0 = 0, c1 = 0;
  float h0v, h1v, u = REPRO_NEG_INF;
  int h0i, h1i, p = INT_MAX;
  list_head(cu, cp, lane, 0, S, k, h0v, h0i);
  list_head(cu, cp, lane + 32, 0, S, k, h1v, h1i);
  for (int t = 0; t < k; ++t) {
    const bool second = better(h1v, h1i, h0v, h0i);
    const float mv = second ? h1v : h0v;
    const int mi = second ? h1i : h0i;
    float v = mv;
    int i = mi;
    warp_best(v, i);
    if (lane == t) {
      u = v;
      p = i;
    }
    if (mi == i && mv == v && mi != INT_MAX) {  // this lane's head won
      if (second)
        list_head(cu, cp, lane + 32, ++c1, S, k, h1v, h1i);
      else
        list_head(cu, cp, lane, ++c0, S, k, h0v, h0i);
    }
  }
  write_row(r, k, m, d, u, p, vals, idx, lse);
}

// part_md [R, S, 2], part_u / part_p [R, S, k]; ticket [R * kTicketStride]
// (zero between calls; unused when S == 1); dynamic shared memory when S >
// 1: the S * k candidates (fp32 values, then int32 indices).
template <typename T, int L>
__global__ void __launch_bounds__(kMaxThreads)
    softmax_topk_kernel(const T* __restrict__ x, int V, int k, int sv,
                        T* __restrict__ vals, int* __restrict__ idx,
                        float* __restrict__ lse, float* __restrict__ part_md,
                        float* __restrict__ part_u, int* __restrict__ part_p,
                        int* __restrict__ ticket) {
  extern __shared__ __align__(16) float cand[];
  __shared__ Meet meet;
  const size_t r = blockIdx.x;
  const int s = blockIdx.y, S = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float m = REPRO_NEG_INF, d = 0.f;
  WarpTopK w;
  w.init(k);
  scan<T, L>(x + r * V, V, s, sv, m, d, w);
  warp_md(m, d);
  if (lane == 0) {
    meet.wm[warp] = m;
    meet.wd[warp] = d;
  }
  if (lane < k) {
    meet.wu[warp][lane] = w.v;
    meet.wp[warp][lane] = w.i;
  }
  __syncthreads();  // the CTA's one meeting
  if (warp != 0) return;
  float u;
  int p;
  cta_result(meet, k, m, d, u, p);
  if (S == 1) {
    write_row(r, k, m, d, u, p, vals, idx, lse);
    return;
  }

  // the slice's partial, then a ticket; the row's last CTA merges
  const size_t part = r * S + s;
  if (lane == 0) {
    part_md[2 * part] = m;
    part_md[2 * part + 1] = d;
  }
  if (lane < k) {
    part_u[part * k + lane] = u;
    part_p[part * k + lane] = p;
  }
  int* my_ticket = ticket + r * kTicketStride;
  __syncwarp();  // the lanes' writes are ordered before lane 0's ticket
  int last = 0;
  if (lane == 0) last = take_ticket(my_ticket) == S - 1;
  last = __shfl_sync(kFull, last, 0);
  __syncwarp();  // and the other slices' partials before every lane's loads
  if (!last) return;
  if (lane == 0) *my_ticket = 0;  // every slice has taken its ticket
  merge_row(r, S, k, part_md, part_u, part_p, cand, vals, idx, lse);
}

template <typename T, int L>
cudaError_t launch(const void* x, int R, int V, int k, int S, int sv,
                   int threads, int smem, void* vals, void* idx, void* lse,
                   void* part_f, void* part_i, void* ticket,
                   cudaStream_t stream) {
  float* part_md = static_cast<float*>(part_f);
  float* part_u = part_md + static_cast<size_t>(R) * S * 2;
  softmax_topk_kernel<T, L><<<dim3(R, S), threads, smem, stream>>>(
      static_cast<const T*>(x), V, k, sv, static_cast<T*>(vals),
      static_cast<int*>(idx), static_cast<float*>(lse), part_md, part_u,
      static_cast<int*>(part_i), static_cast<int*>(ticket));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_l(int loads, const void* x, int R, int V, int k, int S,
                     int sv, int threads, int smem, void* vals, void* idx,
                     void* lse, void* part_f, void* part_i, void* ticket,
                     cudaStream_t stream) {
  if (loads == 1)
    return launch<T, 1>(x, R, V, k, S, sv, threads, smem, vals, idx, lse,
                        part_f, part_i, ticket, stream);
  if (loads == 4)
    return launch<T, 4>(x, R, V, k, S, sv, threads, smem, vals, idx, lse,
                        part_f, part_i, ticket, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [R, V] rows contiguous (dtype code; any start), any R >= 1, 1 <= k <=
// 32; the plan's S <= 64 slices a row of sv 16-byte vectors, `threads` a
// CTA (a multiple of 32 up to 256), `loads` vectors a thread a batch (1 or
// 4) and `smem` bytes of dynamic shared memory (8 S k, 0 when S == 1);
// vals [R, k] (x's dtype), idx [R, k] int32, lse [R] float32; part_f holds
// R*S*(2+k) floats and part_i R*S*k ints, ticket R * 32 ints left zero
// (all three unused when S == 1).  Returns cudaGetLastError().
extern "C" int softmax_topk_launch(const void* x, int dtype, int R, int V,
                                   int k, int S, int sv, int threads,
                                   int loads, int smem, void* vals, void* idx,
                                   void* lse, void* part_f, void* part_i,
                                   void* ticket, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || threads < 32 || threads > kMaxThreads ||
      threads % 32 || S < 1 || S > kMaxSlices || sv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == kDtypeF32) {
    err = launch_l<float>(loads, x, R, V, k, S, sv, threads, smem, vals, idx,
                          lse, part_f, part_i, ticket, st);
  } else if (dtype == kDtypeBF16) {
    err = launch_l<__nv_bfloat16>(loads, x, R, V, k, S, sv, threads, smem,
                                  vals, idx, lse, part_f, part_i, ticket, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
