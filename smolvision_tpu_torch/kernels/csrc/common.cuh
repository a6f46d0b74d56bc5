// Shared helpers of the attention kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sv {

// Same finite mask value and denominator floor as the Pallas kernels
// (smolvision_tpu/kernels/flash_attention.py): a query row with no key in
// range ends with l == 0 and returns acc / 1e-30 == 0.
constexpr float kNegInf = -1e30f;
constexpr float kDenomFloor = 1e-30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

// One step of the online softmax for a key with score s: rescale the running
// (m, l, acc) to the new max and add p = exp(s - m_new) with value row v.
template <int N>
__device__ __forceinline__ void online_update(float s, const float (&v)[N], float& m,
                                              float& l, float (&acc)[N]) {
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = fmaf(p, v[e], acc[e] * alpha);
    m = m_new;
}

}  // namespace sv
