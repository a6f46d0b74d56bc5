// The two measurement probes (kernels K8 and K9) for Hopper.
//
// K8 read_all replaces tools/profile_decode3.py:read_all (body _read_kernel):
// max(f32(x)) + s over x [R, H] bf16, the read-bandwidth roofline: the least
// work that still reads every byte of a weight table once.  Bound: bytes
// (0.6B lm_head: 311 MB).  A grid-stride loop of 16-byte loads (8 bf16 per
// lane, neighbouring lanes on neighbouring addresses) keeps a per-thread
// max; warps and blocks reduce it, and each block folds its maximum into one
// global key with atomicMax on order-preserving float bits (max is exact, so
// the block order cannot change the result); a one-thread second kernel adds
// s.  A tail that is not a whole 16-byte vector is read one element at a
// time.
//
// K9 probe_mm replaces tools/probe_compile_cache.py:pallas_mm (body kern):
// x [M, K] @ y [K, N] in f32, there [256, 256] x2 in one block.  That probe
// asked whether a compiled kernel comes back from JAX's persistent cache; the
// port's counterpart is kernels/build.py's source-hash cache, which
// chip_smoke.py checks by loading this kernel in a fresh process without
// nvcc.  Bound: operations (2 M N K at the card's f32 rate).  A plain
// shared-memory tiled product: 16 x 16 output tiles, one output per thread,
// 16-deep slices of x and y staged in shared memory.

#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned int order_bits(float x) {
    const unsigned int u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned int k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

constexpr int kReadThreads = 256;

__global__ void __launch_bounds__(kReadThreads)
read_max_kernel(const __nv_bfloat16* __restrict__ x, long long n, unsigned int* __restrict__ key) {
    __shared__ float warp_max[kReadThreads / 32];
    float m = -3.4e38f;
    const long long n_vec = n / 8;
    const long long stride = static_cast<long long>(gridDim.x) * kReadThreads;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long i = static_cast<long long>(blockIdx.x) * kReadThreads + threadIdx.x; i < n_vec;
         i += stride) {
        const uint4 u = __ldg(xv + i);
        const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(b[j]);
            m = fmaxf(m, fmaxf(f.x, f.y));
        }
    }
    for (long long i = n_vec * 8 + static_cast<long long>(blockIdx.x) * kReadThreads + threadIdx.x;
         i < n; i += stride)
        m = fmaxf(m, __bfloat162float(x[i]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kReadThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
        atomicMax(key, order_bits(m));
    }
}

__global__ void read_finish_kernel(const unsigned int* __restrict__ key, float s,
                                   float* __restrict__ out) {
    out[0] = from_order_bits(key[0]) + s;
}

constexpr int kTile = 16;

__global__ void __launch_bounds__(kTile * kTile)
probe_mm_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out,
                int M, int N, int K) {
    __shared__ float xs[kTile][kTile];
    __shared__ float ys[kTile][kTile + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int row = blockIdx.y * kTile + ty, col = blockIdx.x * kTile + tx;
    float acc = 0.f;
    for (int k0 = 0; k0 < K; k0 += kTile) {
        xs[ty][tx] = (row < M && k0 + tx < K) ? x[static_cast<long long>(row) * K + k0 + tx] : 0.f;
        ys[ty][tx] = (k0 + ty < K && col < N) ? y[static_cast<long long>(k0 + ty) * N + col] : 0.f;
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kTile; ++k) acc = fmaf(xs[ty][k], ys[k][tx], acc);
        __syncthreads();
    }
    if (row < M && col < N) out[static_cast<long long>(row) * N + col] = acc;
}

}  // namespace

// x: n bf16 values (16-byte aligned); key: one u32 of scratch; out: one f32.
extern "C" int sv_read_all(const void* x, long long n, float s, unsigned int* key, float* out,
                           void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    cudaError_t e = cudaMemsetAsync(key, 0, sizeof(unsigned int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long want = (n / 8 + kReadThreads - 1) / kReadThreads;
    const int blocks = static_cast<int>(want < sms * 8LL ? (want > 0 ? want : 1) : sms * 8LL);
    read_max_kernel<<<blocks, kReadThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(x), n, key);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    read_finish_kernel<<<1, 1, 0, st>>>(key, s, out);
    return static_cast<int>(cudaGetLastError());
}

// x [M, K], y [K, N], out [M, N]: f32 row-major.
extern "C" int sv_probe_mm(const float* x, const float* y, float* out, int M, int N, int K,
                           void* stream) {
    const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    probe_mm_kernel<<<grid, dim3(kTile, kTile), 0, static_cast<cudaStream_t>(stream)>>>(
        x, y, out, M, N, K);
    return static_cast<int>(cudaGetLastError());
}
