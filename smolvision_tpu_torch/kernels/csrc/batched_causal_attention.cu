// Batched fresh-prefill causal attention (kernel B4) for Hopper.
//
// Replaces: smolvision_tpu/kernels/flash_attention.py:batched_causal_flash_attention
// (Pallas body _batched_causal_kernel): causal GQA self-attention of B fresh
// blocks (the whole context is the block; the cache starts empty).  In batch
// row b, query row r attends key column c iff kv_min[b] <= c <= r; the
// left-pad rows r < kv_min[b] attend nothing and return 0.  Online softmax
// in f32, scale 1/sqrt(D) on q.
//
// Bound on the card: bytes at the batched prefill shapes (B 6, T 320, H 16,
// KH 8, D 128: ~20 MB of q/k/v/out against ~2 GFLOP), but in f32 on the CUDA
// cores the products take the time.  One launch covers the whole batch: a
// block takes one (batch row, KV head) and 64 / G query rows of each of the
// G query heads of that KV head, so each K/V tile is loaded once for all G
// heads (the TPU kernel's per-head grid loads it G times).  Key tiles above
// the block's last query row or wholly below kv_min[b] are neither loaded
// nor computed (the TPU kernel's causal block skip), by the register-tiled
// core of tiled_attention.cuh.
//
// Layout: q [B, T, H, D], k / v [B, T, KH, D], out [B, T, H, D], all f32
// contiguous; kv_min [B] int32 on the device.  Grid (ceil(T / (64 / G)),
// B * KH), 256 threads, dynamic shared memory above the 48 KB static limit.

#include "tiled_attention.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(sv::kTileThreads)
batched_causal_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ kv_min,
                      float* __restrict__ out, int T, int H, int KH, int rows_per_head,
                      float scale) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
    const int G = H / KH;
    const long long q_row = (long long)H * D, kv_row = (long long)KH * D;
    const long long q_base = (long long)b * T * q_row + (long long)kh * G * D;
    const long long kv_base = (long long)b * T * kv_row + (long long)kh * D;
    const sv::TileRows rows{T, (int)blockIdx.x * rows_per_head, rows_per_head, G};

    sv::RowState<D> st;
    sv::begin_rows<D>(smem, st, rows, q + q_base, q_row, D, scale);
    int row_hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) row_hi[i] = rows.t(rows.mine(i)) + 1;
    const int lo = min(max(kv_min[b], 0), T);
    const int hi = min(rows.t0 + rows_per_head, T);
    sv::attend_tiles<D, float>(smem, st, k + kv_base, v + kv_base, kv_row, lo, hi, row_hi);
    sv::end_rows<D>(st, rows, out + q_base, q_row, D);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const int* kv_min, float* out, int B,
           int T, int H, int KH, float scale, cudaStream_t stream) {
    const size_t smem = sv::tiled_smem_bytes(D);
    cudaError_t e = cudaFuncSetAttribute(batched_causal_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int rows_per_head = sv::kTileRows / (H / KH);
    dim3 grid((T + rows_per_head - 1) / rows_per_head, B * KH);
    batched_causal_kernel<D><<<grid, sv::kTileThreads, smem, stream>>>(q, k, v, kv_min, out, T, H,
                                                                         KH, rows_per_head, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// G = H / KH must divide 64 (the wrapper checks); D 64 or 128.
extern "C" int sv_batched_causal_attention(const float* q, const float* k, const float* v,
                                           const int* kv_min, float* out, int B, int T, int H,
                                           int KH, int D, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 0 || T <= 0) return 0;
    if (KH <= 0 || H % KH != 0 || sv::kTileRows % (H / KH) != 0)
        return (int)cudaErrorInvalidValue;
    switch (D) {
        case 64: return launch<64>(q, k, v, kv_min, out, B, T, H, KH, scale, st);
        case 128: return launch<128>(q, k, v, kv_min, out, B, T, H, KH, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
