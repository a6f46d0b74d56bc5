// Batched fresh-prefill causal attention (kernel B4) for Hopper.
//
// Replaces: smolvision_tpu/kernels/flash_attention.py:batched_causal_flash_attention
// (Pallas body _batched_causal_kernel): causal GQA self-attention of B fresh
// blocks (the whole context is the block; the cache starts empty).  In batch
// row b, query row r attends key column c iff kv_min[b] <= c <= r; the
// left-pad rows r < kv_min[b] attend nothing and return 0.  Online softmax
// in f32, scale 1/sqrt(D) on q.
//
// Bound on the card: bytes at the batched prefill shape (B 6, T 320, H 16,
// KH 8, D 128: 47 MB of q/k/v/out against ~2 GFLOP, which the tensor cores
// take in a seventh of the bytes' time; in f32 on the CUDA cores the
// products took the time).  One launch covers the whole batch on the
// tensor-core core of mma_attention.cuh: a block takes one (batch row, KV
// head) and floor(64 / G) queries of each of the G query heads of that KV
// head (any G up to 64), so each K/V tile is loaded once for all G heads
// (the TPU kernel's per-head grid loads it G times).  K and V are f32 (the
// decoder's rms_norm and RoPE return f32), so the block walks one causal f32
// key segment from kv_min[b]: 32-key tiles split into bf16 hi / lo once per
// tile, three mma.sync per product.  Key tiles above the block's last query
// or below kv_min[b] are neither loaded nor computed (the TPU kernel's
// causal block skip); a block of left-pad rows only stores its zeros.  The
// blocks are numbered heaviest first (the late query tiles attend the most
// keys): at the -S 20 shape 10 query tiles x 6 rows x 8 KV heads = 480
// blocks, 3.6 waves on 132 SMs.
//
// Layout: q [B, T, H, D], k / v [B, T, KH, D], out [B, T, H, D], all f32
// contiguous, k / v 16-byte aligned; kv_min [B] int32 on the device.  Grid
// ceil(T / floor(64 / G)) * B * KH blocks of 256 threads, dynamic shared
// memory above the 48 KB static limit.

#include "mma_attention.cuh"

namespace {

// one warp group per block: the grid is several waves of short blocks, and
// two blocks per SM overlap one's loads with the other's products
constexpr int kGroups = 1;

template <int D>
__global__ void __launch_bounds__(128 * kGroups, 2)
batched_causal_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ kv_min,
                      float* __restrict__ out, int B, int T, int H, int KH, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int G = H / KH, P = sv::kMmaRows / G;
    const int n_qtiles = (T + P - 1) / P;
    const int qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x) / (B * KH);  // heaviest first
    const int b = (blockIdx.x / KH) % B, kh = blockIdx.x % KH;
    const long long q_base = ((long long)b * T * H + (long long)kh * G) * D;
    const long long kv_base = ((long long)b * T * KH + kh) * D;
    sv::MmaBlock<D> blk;
    sv::mma_begin<D, kGroups>(smem, blk, q + q_base, (long long)H * D, T, qtile * P, G, scale);
    const int lo = min(max(kv_min[b], 0), T);
    sv::mma_attend<D, kGroups>(smem, blk, sv::KeySegment<float>{k + kv_base, v + kv_base,
                                                       (long long)KH * D, lo, T, true, 0});
    sv::mma_end<D, kGroups>(smem, blk, out + q_base, (long long)H * D, G);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const int* kv_min, float* out, int B,
           int T, int H, int KH, float scale, cudaStream_t stream) {
    const size_t smem = sv::mma_smem_bytes(D, kGroups);
    cudaError_t e = cudaFuncSetAttribute(batched_causal_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int P = sv::kMmaRows / (H / KH);
    batched_causal_kernel<D><<<((T + P - 1) / P) * B * KH, 128 * kGroups, smem, stream>>>(
        q, k, v, kv_min, out, B, T, H, KH, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// 1 <= G = H / KH <= 64 (the wrapper checks); D 64 or 128.
extern "C" int sv_batched_causal_attention(const float* q, const float* k, const float* v,
                                           const int* kv_min, float* out, int B, int T, int H,
                                           int KH, int D, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 0 || T <= 0) return 0;
    if (KH <= 0 || H < KH || H % KH != 0 || H / KH > sv::kMmaRows)
        return (int)cudaErrorInvalidValue;
    switch (D) {
        case 64: return launch<64>(q, k, v, kv_min, out, B, T, H, KH, scale, st);
        case 128: return launch<128>(q, k, v, kv_min, out, B, T, H, KH, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
