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
//   ~295 flops/byte where the tensor cores would bind, so the kernels run on
//   the CUDA cores.  At serving sizes the bytes take well under a
//   microsecond: what costs is latency, so the design keeps the card full
//   and every load in flight.
// Design: the Pallas kernel walks the cache as a sequential grid axis; here
//   that axis becomes parallel CTAs whose partials the paper's ⊕ merges.
//   The wrapper's planner (kernels/flash_decode.py, decode_plan) cuts [0, S)
//   into splits of a whole number of 16-position tiles, enough to fill the
//   SMs twice where the cache is long enough, never under 32 positions.
//   decode_split_kernel runs one CTA of 128 threads per (split, KV head,
//   batch row) (attention.cuh, decode_split): it issues every K/V row of its
//   split as 16-byte cp.async copies at once, scores the G query heads of
//   the group against each position (the G heads share every row, so the
//   cache is read once per group), takes one expf per (head, position) and
//   writes its partial (m, d, acc) to the workspace; a CTA whose split
//   starts at or past vlen exits without reading.  The last live split of a
//   (row, head) to finish, found by a ticket counter that it then sets back
//   to 0, ⊕-merges the row's partials in split order and writes acc / d, so
//   the result does not depend on which CTA merges and a call is one
//   launch.  The cache stays in the model layout [B, S, Hkv, D] and is read
//   through the strides the wrapper passes: the reference's
//   ops.flash_decode transposed the whole cache to [B, Hkv, S, D] on every
//   call, which would move more bytes than the kernel reads.  Positions at
//   or past vlen are never read, so a row reads exactly its valid prefix;
//   vlen == 0 gives 0; idle slots arrive with vlen 1 and read position 0 of
//   their own slot.  Instances at D 64 and 128 (with_head_dim), as in
//   flash_decode_paged.cu.  The int8 form runs the same kernels; each position's
//   int8 K and V are dequantized in registers by their scales, read through
//   the scales' own strides.
// The lse form: given an lse buffer [B, Hq], the merging CTA also writes each
//   head's m + log d there, the statistic the sequence-sharded decode
//   (distributed/decode_attention.py) ⊕-merges across ranks (the reference
//   took it from _chunked_fwd_impl, distributed/decode_attention.py:63-68);
//   a row with vlen == 0, every rank's row that lies wholly past its length,
//   writes -inf beside its zeros.  The same launch, one more [B, Hq] store,
//   from an instance of its own (kLse): the plain form's code stays the one
//   without the lse (its register count and time moved with a runtime
//   null check, tools/decode_times.py).
#include "attention.cuh"

namespace {

// positions of one addressing tile: the cache is addressed position by
// position (ContiguousRows with tile 1, step ss); splits are whole numbers
// of the planner's 16-position tiles
constexpr int kPositionTile = 1;

// kLse: the lse form (an instance of its own, so the plain form's code is
// the one without the lse's stores and branches).  The q / out offset is
// spelled as before the lse came: another spelling of the same arithmetic
// changed the plain instance's register allocation and cost it 2-5 % of
// device time (tools/decode_times.py).
template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kDecodeThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ vlen, int Hq, int Hkv, int S, int split,
    int splits, long long sb, long long ss, long long sh, float scale,
    float* __restrict__ lse, float* __restrict__ part_acc,
    float2* __restrict__ part_md, int* __restrict__ tickets,
    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char decode_smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const ContiguousRows rows{static_cast<size_t>(b * sb + h * sh),
                            static_cast<size_t>(kPositionTile * ss),
                            static_cast<size_t>(ss)};
  const size_t pair = static_cast<size_t>(b) * Hkv + h;
  decode_split<T, D>(q, k, v, rows, kPositionTile, min(max(vlen[b], 0), S),
                     split, (static_cast<size_t>(b) * Hq + h * G) * D, G,
                     scale, part_acc + pair * splits * G * D,
                     part_md + pair * splits * G, tickets + pair, out,
                     decode_smem, NoScales(),
                     kLse ? lse + static_cast<size_t>(b) * Hq + h * G
                          : nullptr);
}

// The int8 form: k, v int8 with element strides (sb, ss, sh, 1); scales
// [B, S, Hkv] bf16 with strides (zb, zs, zh).
template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kDecodeThreads) decode_int8_split_kernel(
    const T* __restrict__ q, const signed char* __restrict__ k,
    const signed char* __restrict__ v,
    const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ vlen,
    int Hq, int Hkv, int S, int split, int splits, long long sb, long long ss,
    long long sh, long long zb, long long zs, long long zh, float scale,
    float* __restrict__ lse, float* __restrict__ part_acc,
    float2* __restrict__ part_md, int* __restrict__ tickets,
    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char decode_smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const ContiguousRows rows{static_cast<size_t>(b * sb + h * sh),
                            static_cast<size_t>(kPositionTile * ss),
                            static_cast<size_t>(ss)};
  const Scales<ContiguousRows> sc{
      k_scale, v_scale,
      ContiguousRows{static_cast<size_t>(b * zb + h * zh),
                     static_cast<size_t>(kPositionTile * zs),
                     static_cast<size_t>(zs)}};
  const size_t pair = static_cast<size_t>(b) * Hkv + h;
  decode_split<T, D>(q, k, v, rows, kPositionTile, min(max(vlen[b], 0), S),
                     split, (static_cast<size_t>(b) * Hq + h * G) * D, G,
                     scale, part_acc + pair * splits * G * D,
                     part_md + pair * splits * G, tickets + pair, out,
                     decode_smem, sc,
                     kLse ? lse + static_cast<size_t>(b) * Hq + h * G
                          : nullptr);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* vlen, void* out, void* work, void* tickets,
                   int B, int Hq, int Hkv, int S, int D, int split,
                   int splits, long long sb, long long ss, long long sh,
                   float scale, float* lse, cudaStream_t stream) {
  if (Hkv <= 0) return cudaErrorInvalidValue;
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const size_t smem = decode_split_smem(Hq / Hkv, kD, sizeof(T), split,
                                          false);
    const auto go = [&](auto with_lse) {
      constexpr bool kLse = decltype(with_lse)::value;
      return launch_decode<T, decode_split_kernel<T, kD, kLse>>(
          smem, B, Hq, Hkv, kD, split, splits, out,
          work, tickets, stream, static_cast<const T*>(q),
          static_cast<const T*>(k), static_cast<const T*>(v), vlen, Hq, Hkv,
          S, split, splits, sb, ss, sh, scale, lse);
    };
    return lse != nullptr ? go(std::true_type{}) : go(std::false_type{});
  });
}

template <typename T>
cudaError_t launch_int8(const void* q, const void* k, const void* v,
                        const void* k_scale, const void* v_scale,
                        const int* vlen, void* out, void* work,
                        void* tickets, int B, int Hq, int Hkv, int S, int D,
                        int split, int splits,
                        long long sb, long long ss, long long sh,
                        long long zb, long long zs, long long zh, float scale,
                        float* lse, cudaStream_t stream) {
  if (Hkv <= 0) return cudaErrorInvalidValue;
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const size_t smem = decode_split_smem(Hq / Hkv, kD, 1, split, true);
    const auto go = [&](auto with_lse) {
      constexpr bool kLse = decltype(with_lse)::value;
      return launch_decode<T, decode_int8_split_kernel<T, kD, kLse>>(
          smem, B, Hq, Hkv, kD, split, splits,
          out, work, tickets, stream, static_cast<const T*>(q),
          static_cast<const signed char*>(k),
          static_cast<const signed char*>(v),
          static_cast<const __nv_bfloat16*>(k_scale),
          static_cast<const __nv_bfloat16*>(v_scale), vlen, Hq, Hkv, S, split,
          splits, sb, ss, sh, zb, zs, zh, scale, lse);
    };
    return lse != nullptr ? go(std::true_type{}) : go(std::false_type{});
  });
}

}  // namespace

// q [B, Hq, D] and out [B, Hq, D] contiguous; k, v [B, S, Hkv, D] with
// element strides (sb, ss, sh, 1), the same for both, 16-byte aligned
// rows; vlen [B] int32; work: B * Hkv * splits * G * (D + 2) floats,
// G = Hq / Hkv <= 8; tickets: B * Hkv ints, 0 on entry (and left 0).
// Splits of `split` positions, splits * split >= S.  D is 64 or 128 (the
// instances of with_head_dim), any other D is refused.  One launch; returns
// cudaGetLastError().  lse, where not null: [B, Hq] fp32, contiguous, each
// head's log-sum-exp m + log d over its valid keys (-inf where vlen is 0),
// written by the merging CTA beside out.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* vlen, void* out,
                                   void* work, void* tickets, int dtype, int B,
                                   int Hq, int Hkv, int S, int D, int split,
                                   int splits, long long sb, long long ss,
                                   long long sh, float scale, void* lse,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(vlen);
  float* ls = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kDtypeF32) {
    err = launch<float>(q, k, v, vl, out, work, tickets, B, Hq, Hkv, S, D,
                        split, splits, sb, ss, sh, scale, ls, st);
  } else if (dtype == kDtypeBF16) {
    err = launch<__nv_bfloat16>(q, k, v, vl, out, work, tickets, B, Hq, Hkv,
                                S, D, split, splits, sb, ss, sh, scale, ls,
                                st);
  }
  return static_cast<int>(err);
}

// The int8 form: q and out as above (float or bf16, `dtype`); k, v
// [B, S, Hkv, D] int8 with element strides (sb, ss, sh, 1), the same for
// both; k_scale, v_scale [B, S, Hkv] bf16 with strides (zb, zs, zh), the
// same for both.  D is 64 or 128.  lse as above, from the dequantized
// scores.
extern "C" int flash_decode_int8_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* vlen, void* out, void* work,
    void* tickets, int dtype, int B, int Hq, int Hkv, int S, int D, int split,
    int splits, long long sb, long long ss, long long sh, long long zb,
    long long zs, long long zh, float scale, void* lse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(vlen);
  float* ls = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kDtypeF32) {
    err = launch_int8<float>(q, k, v, k_scale, v_scale, vl, out, work,
                             tickets, B, Hq, Hkv, S, D, split, splits, sb, ss,
                             sh, zb, zs, zh, scale, ls, st);
  } else if (dtype == kDtypeBF16) {
    err = launch_int8<__nv_bfloat16>(q, k, v, k_scale, v_scale, vl, out, work,
                                     tickets, B, Hq, Hkv, S, D, split, splits,
                                     sb, ss, sh, zb, zs, zh, scale, ls, st);
  }
  return static_cast<int>(err);
}
