// Hopper tensor-core machinery of the bf16 attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu, flash_attention_offset.cu,
// flash_attention_paged.cu): cp.async copies into 128-byte-swizzled
// shared-memory tiles, the wgmma shared-memory descriptor, the m64n64k16 bf16
// products with the fp32 accumulator in registers, the
// accumulator-fragment-to-(row, column) map, and the forward's tile loop
// (attend), which the fresh and both cached-prefill forward kernels share,
// each giving it where its keys live (ContiguousKeys, PagedKeys).
//
// Tiles.  Every operand tile is [64 rows][64 bf16] (a row of head_dim 64 is
// 128 bytes): 8 KB, 1024-byte aligned, with 16-byte chunk c of row r stored
// at r * 128 + ((c ^ (r % 8)) * 16), the 128B swizzle that wgmma's
// SWIZZLE_128B mode reads.  The same tile serves two ways:
//   K-major  (the contraction runs along the row's 64 values: Q, K, dO, V
//            in S = Q·Kᵀ, dP = dO·Vᵀ and their transposes); k-step kk of 16
//            values starts 32 * kk bytes into the tile;
//   MN-major (the contraction runs across rows: V in P·V, K in dS·K, dO in
//            Pᵀ·dO, Q in dSᵀ·Q; wgmma's transposed-B form, allowed for
//            16-bit types); k-step kk of 16 rows starts 2048 * kk bytes in.
// Groups of 8 rows lie 1024 bytes apart in both readings, and a 64-wide
// operand is one swizzle atom wide, so the descriptor's two byte offsets
// are both 1024.
//
// Fragments.  A warpgroup (128 threads, warps w = 0..3) holds a 64 x 64 fp32
// accumulator as 32 floats a thread: float 4 * n + e sits at row
// 16 * w + lane / 4 + 8 * (e / 2) and column 8 * n + 2 * (lane % 4) + e % 2
// (n = 0..7, e = 0..3).  The register A operand of a k-step kk (16 columns)
// is the same thread's floats 8 * kk .. 8 * kk + 7 as four bf16 pairs, so a
// P or dS computed in the accumulator layout feeds the next product with no
// shuffle.
#pragma once

#include <cstdint>

#include "attention.cuh"

namespace wg {

constexpr int kRows = 64;                 // rows of a tile (wgmma M)
constexpr int kD = 64;                    // head_dim, 128 bytes of bf16
constexpr int kThreads = 128;             // one warpgroup
constexpr uint32_t kTileBytes = kRows * kD * 2;   // 8 KB

using ::smem_addr;

// The first 1024-byte boundary at or after the dynamic shared memory's start
// (the launcher asks for 1 KB more than the tiles need).
__device__ __forceinline__ uint32_t aligned_base(const void* smem) {
  return (smem_addr(smem) + 1023u) & ~1023u;
}

// ---- copies (cp.async helpers of common.cuh) -------------------------------
using ::cp_async16;
using ::cp_async_commit;
using ::cp_async_wait_all;

// Make this thread's generic-proxy writes (cp.async) visible to the async
// proxy wgmma reads shared memory through; the CTA barrier that follows
// publishes them to the other threads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [0, 64) of an operand into the swizzled tile at `dst`, by the 128
// threads of the warpgroup: row r's 64 values are contiguous from base +
// at(r) (elements); rows at or past `valid` are zero-filled without being
// read, and `at` is not asked for them.
template <typename At>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          const At& at, int valid) {
  const int tid = threadIdx.x % kThreads;
#pragma unroll
  for (int i = 0; i < kRows * 8 / kThreads; ++i) {
    const int e = tid + i * kThreads, r = e >> 3, c = e & 7;
    const bool ok = r < valid;
    const __nv_bfloat16* src = base + (ok ? at(r) : 0) + c * 8;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), src, ok);
  }
}

// The same for an operand whose row r starts at rows + r * stride.
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* rows,
                                          size_t stride, int valid) {
  load_rows(dst, rows, [stride](int r) { return r * stride; }, valid);
}

// K and V rows [0, 64) that share their addresses (one row address, two
// copies), into the tiles at dk and dv.
template <typename At>
__device__ __forceinline__ void load_kv_rows(uint32_t dk, uint32_t dv,
                                             const __nv_bfloat16* k,
                                             const __nv_bfloat16* v,
                                             const At& at, int valid) {
  const int tid = threadIdx.x % kThreads;
#pragma unroll
  for (int i = 0; i < kRows * 8 / kThreads; ++i) {
    const int e = tid + i * kThreads, r = e >> 3, c = e & 7;
    const bool ok = r < valid;
    const size_t a = (ok ? at(r) : 0) + c * 8;
    const uint32_t o = r * 128 + ((c ^ (r & 7)) << 4);
    cp_async16(dk + o, k + a, ok);
    cp_async16(dv + o, v + a, ok);
  }
}

// ---- descriptors -----------------------------------------------------------
// wgmma shared-memory descriptor of a 128B-swizzled tile starting at byte
// address `addr`: start >> 4 in bits 0-13, leading and stride byte offsets
// (1024 >> 4) in bits 16-29 and 32-45, base offset 0 (tiles are 1024-byte
// aligned), layout SWIZZLE_128B (1) in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// k-step kk of a tile read K-major / MN-major (see the header note).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + 32 * kk);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + 2048 * kk);
}

// ---- wgmma -----------------------------------------------------------------
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin the accumulator's registers around the asynchronous products, so no
// read or write of them moves across a fence or a wait.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_WG_ACC32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

#define REPRO_WG_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (+)= A·Bᵀ, m64n64k16, A and B from shared memory, both K-major;
// scale_d 0 overwrites d.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_WG_ACC32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A·B, m64n64k16, A from registers (four bf16 pairs, the fragment
// layout of the header note), B from shared memory MN-major (transposed).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef REPRO_WG_D32
#undef REPRO_WG_ACC32

// S (+)= A·Bᵀ over the 64 values of a row: four k-steps, both tiles K-major.
__device__ __forceinline__ void gemm_k(float (&d)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_ss(d, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// d += P·B with P [64, 64] in registers (frag, per k-step) and B MN-major.
__device__ __forceinline__ void gemm_rs(float (&d)[32],
                                        const uint32_t (&p)[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs(d, p[kk], desc_mn(b, kk));
}

// ---- fragments -------------------------------------------------------------
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 accumulator as four k-steps of register A operands, in bf16.
__device__ __forceinline__ void to_frag(const float (&d)[32],
                                        uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// The tile row (0..63) and column (0..63) of accumulator float i.
__device__ __forceinline__ int frag_row(int i) {
  const int w = (threadIdx.x % kThreads) >> 5, lane = threadIdx.x & 31;
  return 16 * w + (lane >> 2) + 8 * ((i & 3) >> 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// Sum / max over the four threads of a quad (the threads that share a row).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ---- the forward's tile loop -------------------------------------------------
// Dynamic shared memory of attend: Q, then two stages of (K, V), and the 1 KB
// the base is aligned up by.
constexpr int kAttendSmem = 5 * kTileBytes + 1024;

// Where attend finds its keys: at(j, r) is the offset (elements, from K's
// and V's base) of row r of 64-key tile j of one (batch row, KV head), in
// the two cache layouts of attention.cuh (position t at rows.at(t / tile) +
// (t % tile) * rows.stride).  stage(j, L) runs one tile ahead of the copies
// of tile j, in the same cp.async group as tile j - 1's.
//
// A cache in the model layout: ContiguousRows with tile 64 (step 64 * ss).
struct ContiguousKeys {
  static constexpr bool kStaged = false;
  ContiguousRows rows;
  __device__ __forceinline__ void stage(int, int) const {}
  __device__ __forceinline__ size_t at(int j, int r) const {
    return rows.at(j) + r * rows.stride;
  }
};

// Block pools [P, Hkv, BS, D] through a batch row's block table (PagedRows,
// tile BS; BS need not divide 64).  The table entries of tile j's pages, at
// most kSlot, are staged once a tile in slot j % 2 of shared memory by
// 4-byte cp.async copies, and at(j, r) reads them through a PagedRows whose
// table is that slot shifted back by tile j's first page.  Only pages that
// hold a position below L are staged, so a dead entry is never read.
struct PagedKeys {
  static constexpr bool kStaged = true;
  static constexpr int kSlot = kRows;  // pages a tile may span (BS 1)
  const int* table;   // the batch row's M entries (device memory)
  int* staged;        // [2][kSlot] (shared memory)
  size_t page;        // Hkv * BS * D
  size_t head;        // hk * BS * D
  int bs;
  __device__ __forceinline__ void stage(int j, int L) const {
    const int k0 = j * kRows, n = min(L - k0, kRows);
    if (n <= 0) return;
    const int first = k0 / bs, pages = (k0 + n - 1) / bs - first + 1;
    const int tid = threadIdx.x % kThreads;
    if (tid < pages)
      cp_async4(smem_addr(staged + (j & 1) * kSlot + tid),
                table + first + tid);
  }
  __device__ __forceinline__ size_t at(int j, int r) const {
    const int t = j * kRows + r;
    const PagedRows rows{staged + (j & 1) * kSlot - j * kRows / bs, page,
                         head, static_cast<size_t>(kD)};
    return rows.at(t / bs) + static_cast<size_t>(t % bs) * rows.stride;
  }
};

// Query rows [i0, i0 + 64) of one (query head, batch row) against keys
// [0, L) of its KV head, by one warpgroup, query row i at absolute position
// qo + i.  qb: the head's row 0 of q (rows qstride apart), ob the same of
// out; lb: its row 0 of lse (rows 1 apart); k, v and keys: where its KV
// head's keys live (ContiguousKeys, PagedKeys).  Q's tile is copied once; K
// and V tiles of 64 keys stream through a two-stage cp.async ring, so the
// copy of tile j + 1 overlaps the products of tile j (a paged cache's table
// entries of tile j + 2 ride along with it).  Per tile: S = Q·Kᵀ (four wgmma
// m64n64k16, fp32 accumulators in registers); the online (m, d) update in
// the accumulator layout: a row's max from its thread's 16 scores and two
// quad shuffles, each exponential taken once as exp2f with scale·log2(e)
// folded in, the rescale guard of common.cuh (m_old == m_new gives 1, so
// -inf/-inf gives no NaN), and d kept as per-thread partial sums,
// quad-reduced once at the end; then O += P·V with P converted to bf16 in
// registers as wgmma's register A operand and V read MN-major.  The tile
// loop stops at min(ceil(L / 64), (qo + last row) / 64 + 1) when causal;
// only tiles that cross L or the diagonal (k_pos <= qo + i) are masked.
// Keys at or past L are zero-filled without being read and score -inf;
// query rows past Tq are zero-filled and not written.  Epilogue: out = O / d
// in bf16, lse = m + log d; a row with no valid key gives 0 and -inf.
template <typename Keys>
__device__ __forceinline__ void attend(
    const __nv_bfloat16* __restrict__ qb, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const Keys& keys,
    __nv_bfloat16* __restrict__ ob, float* __restrict__ lb, size_t qstride,
    int i0, int Tq, int qo, int L, float scale, int causal,
    unsigned char* tiles) {
  const uint32_t sq = aligned_base(tiles);
  const uint32_t skv = sq + kTileBytes;  // stage s: K, then V
  constexpr int R = kRows;

  int nk = (L + R - 1) / R;
  if (causal) nk = min(nk, (qo + min(i0 + R, Tq) - 1) / R + 1);

  load_tile(sq, qb + i0 * qstride, qstride, Tq - i0);
  if constexpr (Keys::kStaged) {  // tile 0's table entries first
    keys.stage(0, L);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }
  load_kv_rows(skv, skv + kTileBytes, k, v,
               [&keys](int r) { return keys.at(0, r); }, L);
  if (1 < nk) keys.stage(1, L);
  cp_async_commit();

  const float sl2 = scale * 1.4426950408889634f;  // scale · log2(e)
  float o[32], s[32];
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = s[i] = 0.f;
  const int row0 = frag_row(0);  // this thread's rows: row0, row0 + 8

  for (int j = 0; j < nk; ++j) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile j landed; every thread is done with tile j - 1
    if (j + 1 < nk) {
      const uint32_t nxt = skv + ((j + 1) & 1) * 2 * kTileBytes;
      load_kv_rows(nxt, nxt + kTileBytes, k, v,
                   [&keys, j](int r) { return keys.at(j + 1, r); },
                   L - (j + 1) * R);
      if (j + 2 < nk) keys.stage(j + 2, L);  // slot j % 2: tile j's, done
    }
    cp_async_commit();
    const uint32_t ks = skv + (j & 1) * 2 * kTileBytes;
    const uint32_t vs = ks + kTileBytes;

    fence_acc(s);
    fence();
    gemm_k(s, sq, ks);  // S = Q·Kᵀ
    commit();
    wait_all();
    fence_acc(s);

    const int k0 = j * R;
    if (k0 + R > L || (causal && k0 + R - 1 > qo + i0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + frag_col(i), qp = qo + i0 + frag_row(i);
        if (kp >= L || (causal && kp > qp)) s[i] = REPRO_NEG_INF;
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
      mx[r] = quad_max(mx[r]);
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
    to_frag(s, p);
    fence_acc(o);
    fence();
    gemm_rs(o, p, vs);  // O += P·V
    commit();
    wait_all();
    fence_acc(o);
  }
  cp_async_wait_all();  // no copy outlives the CTA (nk == 0 issues some)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float d = quad_sum(l[r]);
    const int i = i0 + row0 + 8 * r;
    if (i >= Tq) continue;
    const float inv = 1.f / fmaxf(d, 1e-30f);
    __nv_bfloat16* orow = ob + i * qstride;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = frag_col(4 * n);
      *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
          o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
    if ((threadIdx.x & 3) == 0)
      lb[i] = d > 0.f ? m[r] * scale + logf(d) : REPRO_NEG_INF;
  }
}

}  // namespace wg
