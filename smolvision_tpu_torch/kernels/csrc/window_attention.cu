// Encoder window attention (kernel B1) for Hopper.
//
// Replaces: smolvision_tpu/kernels/flash_attention.py:window_flash_attention
// (Pallas body _window_kernel): bidirectional attention inside hard windows,
// keys >= kv_lens[w] masked, a window with no valid key returns 0, pad query
// rows attend the valid keys like any other row (finite garbage).
//
// Bound on the card: bytes at the 0.6B encoder shape (S 104, H 14, D 64:
// ~6 MB of q/k/v/out against ~0.1 GFLOP), but in f32 on the CUDA cores the
// products take the time.  Each (window, head) is one bidirectional problem
// for the register-tiled core of tiled_attention.cuh: rows [0, S), keys
// [0, kv_lens[w]).  Keys at or past kv_lens[w] are never loaded, so a
// whole pad window (the encoder pads to a power of 2 of windows) is exactly
// 0 with no 0 * v product.
//
// Layout: q, k, v, out are contiguous [W, S, H, D] f32; kv_lens [W] int32 on
// the device.  Grid (ceil(S / 64), W * H), 256 threads, dynamic shared
// memory above the 48 KB static limit.

#include "tiled_attention.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(sv::kTileThreads)
window_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ kv_lens,
                        float* __restrict__ out, int S, int H, float scale) {
    extern __shared__ float4 smem4[];
    const int w = blockIdx.y / H;
    const int h = blockIdx.y % H;
    const int len = min(max(kv_lens[w], 0), S);
    const long long row = (long long)H * D;
    const long long base = (long long)w * S * row + (long long)h * D;
    // bidirectional: row_start = len makes every row's limit len
    sv::tiled_attention<D, float>(reinterpret_cast<float*>(smem4), q + base, row, k + base,
                                  v + base, row, out + base, row, S, blockIdx.x * sv::kTileRows,
                                  len, len, 0, scale);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const int* kv_lens, float* out,
           int W, int S, int H, float scale, cudaStream_t stream) {
    const size_t smem = sv::tiled_smem_bytes(D);
    cudaError_t e = cudaFuncSetAttribute(window_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((S + sv::kTileRows - 1) / sv::kTileRows, W * H);
    window_attention_kernel<D><<<grid, sv::kTileThreads, smem, stream>>>(q, k, v, kv_lens, out,
                                                                          S, H, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sv_window_attention(const float* q, const float* k, const float* v,
                                   const int* kv_lens, float* out, int W, int S, int H, int D,
                                   float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 64: return launch<64>(q, k, v, kv_lens, out, W, S, H, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
