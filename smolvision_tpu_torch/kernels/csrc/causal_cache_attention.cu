// Decoder prefill attention (kernel B2) for Hopper.
//
// Replaces: smolvision_tpu/kernels/flash_attention.py:causal_cache_flash_attention
// (Pallas body _causal_kernel): causal GQA attention of a query block at
// cache rows start+t against a KV cache that already holds the block; key
// column c is attended by row r iff kv_min <= c <= r and c < kv_valid.
// Online softmax in f32; a row with no key in range returns 0.
//
// `start` and `kv_valid` are read from device memory, as the Pallas kernel
// takes them as scalar-prefetch operands: a prefill or the --spec verify
// keeps its start on the device, and one CUDA graph of it replays at every
// start (runtime/decode_graph.py).  The grid, ceil(T / P) x KH blocks,
// depends on T alone.
//
// Bound on the card: bytes at the 0.6B prefill shape (T 512, H 16, KH 8,
// D 128, bf16 cache: a few MB against ~0.9 GFLOP).  One route, on the
// tensor-core core of mma_attention.cuh: one causal key segment of the
// cache's type.  A block holds 64 rows, the G query heads of one KV head at
// floor(64 / G) queries each (any G up to 64), so each K/V tile read
// serves the whole group; S and P.V are bf16 mma.sync with f32
// accumulation on a hi / lo split of q and P -- two products on a bf16
// cache (every bf16 engine: offline prefill, sequential segments, the
// --spec verify), three on an f32 cache (the --f32 engine), whose K and V
// are split too -- which keeps the f32 contract to ~1e-5.  At T 512, G 2
// the grid is 16 query tiles x 8 KV heads = 128 blocks, under one wave of
// 132 SMs, and the causal triangle makes the late query tiles the longest:
// the blocks are numbered heaviest first, so that a larger grid (or a
// longer T) starts its long blocks before its short ones.  No tile outside
// [kv_min, min(start + last row + 1, kv_valid)) is read and tile rows past
// it are zero-filled, so the pad rows prefill wrote past kv_valid never
// meet a product.
//
// Layout: q [T, H, D] f32 contiguous; k/v cache [K, KH, D] (bf16 or f32) with
// unit element stride, head stride D and row stride `row_stride` elements;
// start and kv_valid one int32 each; out [T, H, D] f32.  1 <= G <= 64,
// 16-byte aligned rows.

#include "mma_attention.cuh"

namespace {

// warp groups per block: two split the key tiles
// (one wave of blocks at the prefill shape leaves one block per SM)
constexpr int kGroups = 2;

template <int D, typename KV>
__global__ void __launch_bounds__(128 * kGroups)
causal_cache_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, float* __restrict__ out, int T, int H, int KH,
                    long long row_stride, const int* __restrict__ start_ptr,
                    const int* __restrict__ kv_valid_ptr, int kv_min, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int start = __ldg(start_ptr), kv_valid = __ldg(kv_valid_ptr);
    const int G = H / KH, P = sv::kMmaRows / G;
    const int n_qtiles = (T + P - 1) / P;
    const int qtile = n_qtiles - 1 - static_cast<int>(blockIdx.x) / KH;  // heaviest first
    const int kvh = blockIdx.x % KH;
    const long long head = (long long)kvh * G * D, kv_head = (long long)kvh * D;
    sv::MmaBlock<D> blk;
    sv::mma_begin<D, kGroups>(smem, blk, q + head, (long long)H * D, T, qtile * P, G, scale);
    sv::mma_attend<D, kGroups>(smem, blk, sv::KeySegment<KV>{k + kv_head, v + kv_head,
                                                             row_stride, kv_min, kv_valid, true,
                                                             start});
    sv::mma_end<D, kGroups>(smem, blk, out + head, (long long)H * D, G);
}

template <int D, typename KV>
int launch(const float* q, const void* k, const void* v, float* out, int T, int H, int KH,
           long long row_stride, const int* start, const int* kv_valid, int kv_min,
           float scale, cudaStream_t stream) {
    const int G = H / KH;
    if (G < 1 || G > sv::kMmaRows) return (int)cudaErrorInvalidValue;
    const size_t smem = sv::mma_smem_bytes(D, kGroups);
    cudaError_t e = cudaFuncSetAttribute(causal_cache_kernel<D, KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int P = sv::kMmaRows / G;
    causal_cache_kernel<D, KV><<<((T + P - 1) / P) * KH, 128 * kGroups, smem, stream>>>(
        q, static_cast<const KV*>(k), static_cast<const KV*>(v), out, T, H, KH, row_stride,
        start, kv_valid, kv_min, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// kv_bf16: 1 for a bf16 cache (two products), 0 for f32 (three).
extern "C" int sv_causal_cache_attention(const float* q, const void* k, const void* v,
                                         float* out, int T, int H, int KH, int D,
                                         long long row_stride, const int* start,
                                         const int* kv_valid, int kv_min, int kv_bf16,
                                         float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T <= 0) return 0;
    switch ((kv_bf16 ? 1000 : 0) + D) {
        case 1064:
            return launch<64, __nv_bfloat16>(q, k, v, out, T, H, KH, row_stride, start, kv_valid,
                                             kv_min, scale, st);
        case 1128:
            return launch<128, __nv_bfloat16>(q, k, v, out, T, H, KH, row_stride, start,
                                              kv_valid, kv_min, scale, st);
        case 64:
            return launch<64, float>(q, k, v, out, T, H, KH, row_stride, start, kv_valid, kv_min,
                                     scale, st);
        case 128:
            return launch<128, float>(q, k, v, out, T, H, KH, row_stride, start, kv_valid, kv_min,
                                      scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
