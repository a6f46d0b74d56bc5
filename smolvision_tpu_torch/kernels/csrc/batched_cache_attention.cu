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
// are each read once per KV head), but in f32 on the CUDA cores the
// products take the time.  The TPU kernel folds the G query heads of a KV
// head into one row axis ([B, KH, G*T, D]) so that each K/V segment is
// fetched once per KV head; here a block takes one (batch row, KV head) and
// 64 / G query rows of each of its G heads, which gives the same reuse from
// shared memory.  The masked cache window is at most two contiguous column
// ranges, [kv_min, min(start, prompt_max)) and [max(that, kv_min,
// region_start), start): the register-tiled core of tiled_attention.cuh
// walks each, then the fresh block up to the block's last query row.
// Columns outside the ranges (end-pad junk, stale decode rows of other
// requests) are never loaded, so they never meet a product.
//
// Layout: q [B, T, H, D], k_new / v_new [B, T, KH, D], out [B, T, H, D], all
// f32 contiguous; the cache k / v is [B, KH, K, D] (bf16 or f32) with unit
// element stride and strides (cache_b, cache_h, cache_row) elements: the
// views kv[l, 0] / kv[l, 1] of the [L, 2, B, KH, K, D] batched cache.
// kv_min [B], prompt_max [B] (or null), region_start [B] (or null, then the
// scalar region_start_all) are int32 on the device.  Grid (ceil(T / (64 /
// G)), B * KH), 256 threads.

#include "tiled_attention.cuh"

namespace {

template <int D, typename KV>
__global__ void __launch_bounds__(sv::kTileThreads)
batched_cache_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                     const float* __restrict__ v_new, const KV* __restrict__ k_cache,
                     const KV* __restrict__ v_cache, const int* __restrict__ kv_min,
                     const int* __restrict__ prompt_max, const int* __restrict__ region_start,
                     int region_start_all, float* __restrict__ out, int T, int H, int KH,
                     int rows_per_head, long long cache_b, long long cache_h,
                     long long cache_row, int start, float scale) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
    const int G = H / KH;
    const long long q_row = (long long)H * D, kv_row = (long long)KH * D;
    const long long q_base = (long long)b * T * q_row + (long long)kh * G * D;
    const long long new_base = (long long)b * T * kv_row + (long long)kh * D;
    const sv::TileRows rows{T, (int)blockIdx.x * rows_per_head, rows_per_head, G};
    const int km = max(kv_min[b], 0);

    sv::RowState<D> st;
    sv::begin_rows<D>(smem, st, rows, q + q_base, q_row, D, scale);

    if (start > 0) {  // (1) the cache window: every column is below every row
        const KV* kc = k_cache + b * cache_b + kh * cache_h;
        const KV* vc = v_cache + b * cache_b + kh * cache_h;
        const int all[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
        int hi1 = start, lo2 = start;
        if (prompt_max != nullptr) {
            const int rs = region_start != nullptr ? region_start[b] : region_start_all;
            hi1 = max(km, min(start, prompt_max[b]));
            lo2 = max(hi1, max(km, rs));
        }
        sv::attend_tiles<D, KV>(smem, st, kc, vc, cache_row, km, hi1, all);
        sv::attend_tiles<D, KV>(smem, st, kc, vc, cache_row, lo2, start, all);
    }

    // (2) the fresh block: row t attends c <= t with start + c >= kv_min[b]
    int row_hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) row_hi[i] = rows.t(rows.mine(i)) + 1;
    const int lo = min(max(km - start, 0), T);
    const int hi = min(rows.t0 + rows_per_head, T);
    sv::attend_tiles<D, float>(smem, st, k_new + new_base, v_new + new_base, kv_row, lo, hi,
                               row_hi);
    sv::end_rows<D>(st, rows, out + q_base, q_row, D);
}

template <int D, typename KV>
int launch(const float* q, const float* k_new, const float* v_new, const void* k_cache,
           const void* v_cache, const int* kv_min, const int* prompt_max,
           const int* region_start, int region_start_all, float* out, int B, int T, int H,
           int KH, long long cache_b, long long cache_h, long long cache_row, int start,
           float scale, cudaStream_t stream) {
    const size_t smem = sv::tiled_smem_bytes(D);
    cudaError_t e = cudaFuncSetAttribute(batched_cache_kernel<D, KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int rows_per_head = sv::kTileRows / (H / KH);
    dim3 grid((T + rows_per_head - 1) / rows_per_head, B * KH);
    batched_cache_kernel<D, KV><<<grid, sv::kTileThreads, smem, stream>>>(
        q, k_new, v_new, static_cast<const KV*>(k_cache), static_cast<const KV*>(v_cache), kv_min,
        prompt_max, region_start, region_start_all, out, T, H, KH, rows_per_head, cache_b,
        cache_h, cache_row, start, scale);
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

// kv_bf16: 1 for a bf16 cache, 0 for f32.  G = H / KH must divide 64.
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
    if (KH <= 0 || H % KH != 0 || sv::kTileRows % (H / KH) != 0)
        return (int)cudaErrorInvalidValue;
    if (kv_bf16)
        return dispatch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, kv_min, prompt_max,
                                       region_start, region_start_all, out, B, T, H, KH, D,
                                       cache_b, cache_h, cache_row, start, scale, st);
    return dispatch<float>(q, k_new, v_new, k_cache, v_cache, kv_min, prompt_max, region_start,
                           region_start_all, out, B, T, H, KH, D, cache_b, cache_h, cache_row,
                           start, scale, st);
}
