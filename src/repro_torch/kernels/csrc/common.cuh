// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel accumulates in fp32 and reads its inputs as float or bf16
// (dtype code 0 = float32, 1 = bfloat16, as the Python wrappers pass it);
// the int8 attention forms read K/V as int8 and q as float or bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#define REPRO_NEG_INF (-CUDART_INF_F)

enum : int { kDtypeF32 = 0, kDtypeBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(signed char x) {  // int8 K/V
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// exp(m_old - m_new) with the -inf/-inf collision pinned to 1: the
// reference's ``_rescale`` guard, so the (-inf, 0) identity of the paper's
// ⊕ merges without producing NaN.
__device__ __forceinline__ float rescale(float m_old, float m_new) {
  return m_old == m_new ? 1.f : expf(m_old - m_new);
}

// (m, d) ⊕ (om, od): the paper's Eq. (4).
__device__ __forceinline__ void md_combine(float& m, float& d, float om,
                                           float od) {
  const float mn = fmaxf(m, om);
  d = d * rescale(m, mn) + od * rescale(om, mn);
  m = mn;
}

// (m, d) ⊕ (om, od) in fp32 with expf: the merge of the exact forms (row 1's
// softmax_topk and the exact online softmax).
struct ExactMerge {
  __device__ __forceinline__ static void combine(float& m, float& d, float om,
                                                 float od) {
    md_combine(m, d, om, od);
  }
};

// Block-wide (m, d) ⊕ reduction; every thread gets the result.  Each
// thread enters with its own partial (a thread holding none passes the
// identity (-inf, 0)); ``Merge::combine`` is the ⊕ of the caller's form.
template <typename Merge = ExactMerge>
__device__ void block_md(float& m, float& d, float* sm, float* sd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Merge::combine(m, d, __shfl_xor_sync(0xffffffffu, m, off),
                   __shfl_xor_sync(0xffffffffu, d, off));
  }
  if (lane == 0) {
    sm[warp] = m;
    sd[warp] = d;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < nwarps ? sm[lane] : REPRO_NEG_INF;
    d = lane < nwarps ? sd[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Merge::combine(m, d, __shfl_xor_sync(0xffffffffu, m, off),
                     __shfl_xor_sync(0xffffffffu, d, off));
    }
    if (lane == 0) {
      sm[0] = m;
      sd[0] = d;
    }
  }
  __syncthreads();
  m = sm[0];
  d = sd[0];
  __syncthreads();
}

// ---- cp.async: 16-byte copies from global into shared memory -------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src-size 0 (valid false) writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// one 4-byte word (a table entry), through L1
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
