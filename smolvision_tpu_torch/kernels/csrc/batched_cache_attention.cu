// Batched delta-prefill attention (kernel B5) for Hopper.
//
// Replaces: smolvision_tpu/kernels/flash_attention.py:batched_cache_flash_attention
// (Pallas body _batched_cache_kernel): a fresh query block of B rows at cache
// rows start + t attends (1) the batched cache's columns
//   [kv_min[b], start) ∩ ([0, prompt_max[b]) ∪ [region_start[b], K))
// (the natural-layout end-pad mask; without prompt_max every column of
// [kv_min[b], start) is live) and (2) its own fresh K/V, causally, at
// columns c with start + c >= kv_min[b].  The fresh rows are not in the
// cache yet.  One online softmax in f32 runs over both; a row that attends
// no key returns 0.  At start == 0 the cache is not read at all.
//
// Bound on the card: bytes at the serving shapes (the cache and the block
// are each read once per KV head; the products take the tensor cores a
// fraction of the bytes' time, where in f32 on the CUDA cores they took the
// time).  The TPU kernel folds the G query heads of a KV head into one row
// axis ([B, KH, G*T, D]) so that each K/V segment is fetched once per KV
// head; here a block of the tensor-core core of mma_attention.cuh takes one
// (batch row, KV head) and floor(64 / G) queries of each of its G heads (any
// G up to 64), which gives the same reuse from shared memory.  The masked
// cache window is at most two contiguous column ranges, [kv_min, min(start,
// prompt_max)) and [max(that, kv_min, region_start), start): the block walks
// each as a key segment of the cache's type (bf16: two mma.sync per
// product; f32: three), then the fresh f32 block as a causal segment, all in
// one online softmax.  Columns outside the ranges (end-pad junk, stale
// decode rows of other requests) are never loaded, so they never meet a
// product.  The blocks are numbered heaviest first (by query tile).
//
// Layout: q [B, T, H, D], k_new / v_new [B, T, KH, D], out [B, T, H, D], all
// f32 contiguous, k_new / v_new 16-byte aligned; the cache k / v is [B, KH,
// K, D] (bf16 or f32) with unit element stride and strides (cache_b,
// cache_h, cache_row) elements, 16-byte aligned rows: the views kv[l, 0] /
// kv[l, 1] of the [L, 2, B, KH, K, D] batched cache.  kv_min [B],
// prompt_max [B] (or null), region_start [B] (or null, then the scalar
// region_start_all) are int32 on the device.  Grid ceil(T / floor(64 / G))
// * B * KH blocks of 256 threads.

#include "mma_attention.cuh"

namespace {

// one warp group per block: the grid is several waves of short blocks, and
// two blocks per SM overlap one's loads with the other's products
constexpr int kGroups = 1;

// (..., 2): two blocks per SM, so that ptxas may take up to 255 registers;
// left to itself it held the D 64 bf16-cache instance at 128 and spilled
template <int D, typename KV>
__global__ void __launch_bounds__(128 * kGroups, 2)
batched_cache_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                     const float* __restrict__ v_new, const KV* __restrict__ k_cache,
                     const KV* __restrict__ v_cache, const int* __restrict__ kv_min,
                     const int* __restrict__ prompt_max, const int* __restrict__ region_start,
                     int region_start_all, float* __restrict__ out, int B, int T, int H, int KH,
                     long long cache_b, long long cache_h, long long cache_row, int start,
                     float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int G = H / KH, P = sv::kMmaRows / G;
    const int n_qtiles = (T + P - 1) / P;
    const int qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x) / (B * KH);  // heaviest first
    const int b = (blockIdx.x / KH) % B, kh = blockIdx.x % KH;
    const long long q_base = ((long long)b * T * H + (long long)kh * G) * D;
    const long long new_base = ((long long)b * T * KH + kh) * D;
    const int km = max(kv_min[b], 0);
    sv::MmaBlock<D> blk;
    sv::mma_begin<D, kGroups>(smem, blk, q + q_base, (long long)H * D, T, qtile * P, G, scale);

    if (start > 0) {  // (1) the cache window: every column is below every row
        const KV* kc = k_cache + b * cache_b + kh * cache_h;
        const KV* vc = v_cache + b * cache_b + kh * cache_h;
        int hi1 = start, lo2 = start;
        if (prompt_max != nullptr) {
            const int rs = region_start != nullptr ? region_start[b] : region_start_all;
            hi1 = max(km, min(start, prompt_max[b]));
            lo2 = max(hi1, max(km, rs));
        }
#pragma unroll 1
        for (int s = 0; s < 2; ++s)  // [km, hi1), then [lo2, start): one copy of the walk
            sv::mma_attend<D, kGroups>(smem, blk, sv::KeySegment<KV>{kc, vc, cache_row, s ? lo2 : km,
                                                            s ? start : hi1, false, 0});
    }

    // (2) the fresh block: row t attends c <= t with start + c >= kv_min[b]
    sv::mma_attend<D, kGroups>(smem, blk, sv::KeySegment<float>{k_new + new_base, v_new + new_base,
                                                       (long long)KH * D,
                                                       min(max(km - start, 0), T), T, true, 0});
    sv::mma_end<D, kGroups>(smem, blk, out + q_base, (long long)H * D, G);
}

template <int D, typename KV>
int launch(const float* q, const float* k_new, const float* v_new, const void* k_cache,
           const void* v_cache, const int* kv_min, const int* prompt_max,
           const int* region_start, int region_start_all, float* out, int B, int T, int H,
           int KH, long long cache_b, long long cache_h, long long cache_row, int start,
           float scale, cudaStream_t stream) {
    const size_t smem = sv::mma_smem_bytes(D, kGroups);
    cudaError_t e = cudaFuncSetAttribute(batched_cache_kernel<D, KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int P = sv::kMmaRows / (H / KH);
    batched_cache_kernel<D, KV><<<((T + P - 1) / P) * B * KH, 128 * kGroups, smem, stream>>>(
        q, k_new, v_new, static_cast<const KV*>(k_cache), static_cast<const KV*>(v_cache), kv_min,
        prompt_max, region_start, region_start_all, out, B, T, H, KH, cache_b, cache_h,
        cache_row, start, scale);
    return (int)cudaGetLastError();
}

template <typename KV>
int dispatch(const float* q, const float* k_new, const float* v_new, const void* k_cache,
             const void* v_cache, const int* kv_min, const int* prompt_max,
             const int* region_start, int region_start_all, float* out, int B, int T, int H,
             int KH, int D, long long cache_b, long long cache_h, long long cache_row, int start,
             float scale, cudaStream_t st) {
    switch (D) {
        case 64:
            return launch<64, KV>(q, k_new, v_new, k_cache, v_cache, kv_min, prompt_max,
                                  region_start, region_start_all, out, B, T, H, KH, cache_b,
                                  cache_h, cache_row, start, scale, st);
        case 128:
            return launch<128, KV>(q, k_new, v_new, k_cache, v_cache, kv_min, prompt_max,
                                   region_start, region_start_all, out, B, T, H, KH, cache_b,
                                   cache_h, cache_row, start, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// kv_bf16: 1 for a bf16 cache, 0 for f32.  1 <= G = H / KH <= 64.
extern "C" int sv_batched_cache_attention(const float* q, const float* k_new, const float* v_new,
                                          const void* k_cache, const void* v_cache,
                                          const int* kv_min, const int* prompt_max,
                                          const int* region_start, int region_start_all,
                                          float* out, int B, int T, int H, int KH, int D,
                                          long long cache_b, long long cache_h,
                                          long long cache_row, int start, int kv_bf16,
                                          float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 0 || T <= 0) return 0;
    if (KH <= 0 || H < KH || H % KH != 0 || H / KH > sv::kMmaRows)
        return (int)cudaErrorInvalidValue;
    if (kv_bf16)
        return dispatch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, kv_min, prompt_max,
                                       region_start, region_start_all, out, B, T, H, KH, D,
                                       cache_b, cache_h, cache_row, start, scale, st);
    return dispatch<float>(q, k_new, v_new, k_cache, v_cache, kv_min, prompt_max, region_start,
                           region_start_all, out, B, T, H, KH, D, cache_b, cache_h, cache_row,
                           start, scale, st);
}
