// Decoder prefill attention (kernel B2) for Hopper.
//
// Replaces: smolvision_tpu/kernels/flash_attention.py:causal_cache_flash_attention
// (Pallas body _causal_kernel): causal GQA attention of a query block at
// cache rows start+t against a KV cache that already holds the block; key
// column c is attended by row r iff kv_min <= c <= r and c < kv_valid.
// Online softmax in f32; a row with no key in range returns 0.
//
// Bound on the card: bytes at the 0.6B prefill shape (T 512, H 16, KH 8,
// D 128, bf16 cache: a few MB against ~0.9 GFLOP), but in f32 on the CUDA
// cores the products take the time.  Each (query tile, head) is one causal
// problem for the register-tiled core of tiled_attention.cuh, reading the
// head's KV group h / G straight from the [K, KH, D] cache by stride.  The
// core never reads a tile outside [kv_min, min(start + last row + 1,
// kv_valid)) and zero-fills tile rows past it, so the pad rows prefill
// wrote past kv_valid never meet a product.
//
// Layout: q [T, H, D] f32 contiguous; k/v cache [K, KH, D] (bf16 or f32) with
// unit element stride, head stride D and row stride `row_stride` elements;
// out [T, H, D] f32.  Grid (ceil(T / 64), H), 256 threads.

#include "tiled_attention.cuh"

namespace {

template <int D, typename KV>
__global__ void __launch_bounds__(sv::kTileThreads)
causal_cache_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, float* __restrict__ out, int T, int H, int G,
                    long long row_stride, int start, int kv_valid, int kv_min, float scale) {
    extern __shared__ float4 smem4[];
    const int h = blockIdx.y;
    const long long head = (long long)h * D, kv_head = (long long)(h / G) * D;
    const long long row = (long long)H * D;
    sv::tiled_attention<D, KV>(reinterpret_cast<float*>(smem4), q + head, row, k + kv_head,
                               v + kv_head, row_stride, out + head, row, T,
                               blockIdx.x * sv::kTileRows, start, kv_valid, kv_min, scale);
}

template <int D, typename KV>
int launch(const float* q, const void* k, const void* v, float* out, int T, int H, int KH,
           long long row_stride, int start, int kv_valid, int kv_min, float scale,
           cudaStream_t stream) {
    const size_t smem = sv::tiled_smem_bytes(D);
    cudaError_t e = cudaFuncSetAttribute(causal_cache_kernel<D, KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((T + sv::kTileRows - 1) / sv::kTileRows, H);
    causal_cache_kernel<D, KV><<<grid, sv::kTileThreads, smem, stream>>>(
        q, static_cast<const KV*>(k), static_cast<const KV*>(v), out, T, H, H / KH, row_stride,
        start, kv_valid, kv_min, scale);
    return (int)cudaGetLastError();
}

template <typename KV>
int dispatch(const float* q, const void* k, const void* v, float* out, int T, int H, int KH,
             int D, long long row_stride, int start, int kv_valid, int kv_min, float scale,
             cudaStream_t st) {
    switch (D) {
        case 64:
            return launch<64, KV>(q, k, v, out, T, H, KH, row_stride, start, kv_valid, kv_min,
                                  scale, st);
        case 128:
            return launch<128, KV>(q, k, v, out, T, H, KH, row_stride, start, kv_valid, kv_min,
                                   scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// kv_bf16: 1 for a bf16 cache, 0 for f32.
extern "C" int sv_causal_cache_attention(const float* q, const void* k, const void* v,
                                         float* out, int T, int H, int KH, int D,
                                         long long row_stride, int start, int kv_valid,
                                         int kv_min, int kv_bf16, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T <= 0) return 0;
    if (kv_bf16)
        return dispatch<__nv_bfloat16>(q, k, v, out, T, H, KH, D, row_stride, start, kv_valid,
                                       kv_min, scale, st);
    return dispatch<float>(q, k, v, out, T, H, KH, D, row_stride, start, kv_valid, kv_min,
                           scale, st);
}
