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
// nvcc.  Bound: operations (2 M N K at the card's f32 rate), but at [256,
// 256] x2 the work is small enough that load latency and the number of
// busy SMs set the time.  Register-tiled f32 FMA on the CUDA cores (no
// TF32): 16 x 32 output tiles, so [256, 256] is 128 blocks on 132 SMs; each
// block's 8 warps split every 128-deep k tile of x and y (a two-stage
// cp.async ring, 16-byte copies when K and N are multiples of 4, else
// 4-byte; out-of-range elements zero-filled) into 16-deep slices, each lane
// keeps a 4 x 4 register tile (rows tm + 4 i, columns 4 tn + j: conflict-free
// 16-byte shared loads of x and y, 16 FMAs per 8 loads), and the 8 slices are
// summed in shared memory at the end in a fixed order.

#include "common.cuh"
#include "mma.cuh"

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

constexpr int kMmBM = 16, kMmBN = 32, kMmKT = 128;  // block tile and k tile
constexpr int kMmWarps = 8, kMmThreads = kMmWarps * 32, kMmStages = 2;
constexpr int kMmSlice = kMmKT / kMmWarps;           // k of a warp per tile
constexpr int kMmXStride = kMmKT + 4;                // padded x row (16-byte aligned)
constexpr int kMmStageFloats = kMmBM * kMmXStride + kMmKT * kMmBN;
constexpr int kMmSmem = kMmStages * kMmStageFloats * 4;

template <bool kVec>
__global__ void __launch_bounds__(kMmThreads)
probe_mm_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out,
                int M, int N, int K) {
    extern __shared__ __align__(16) float mm_smem[];
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int tm = lane % 4, tn = lane / 4;
    const int m0 = blockIdx.y * kMmBM, n0 = blockIdx.x * kMmBN;
    const int n_tiles = (K + kMmKT - 1) / kMmKT;

    auto fetch = [&](int t) {
        if (t < n_tiles) {
            float* xs = mm_smem + (t % kMmStages) * kMmStageFloats;
            float* ys = xs + kMmBM * kMmXStride;
            const int k0 = t * kMmKT;
            constexpr int w = kVec ? 4 : 1;  // floats per copy
            for (int c = tid; c < kMmBM * kMmKT / w; c += kMmThreads) {
                const int r = c / (kMmKT / w), kk = (c % (kMmKT / w)) * w;
                const bool ok = m0 + r < M && k0 + kk < K;
                const float* src = ok ? x + static_cast<long long>(m0 + r) * K + k0 + kk : x;
                if (kVec) sv::cp_async16(xs + r * kMmXStride + kk, src, ok);
                else sv::cp_async4(xs + r * kMmXStride + kk, src, ok);
            }
            for (int c = tid; c < kMmKT * kMmBN / w; c += kMmThreads) {
                const int r = c / (kMmBN / w), nn = (c % (kMmBN / w)) * w;
                const bool ok = k0 + r < K && n0 + nn < N;
                const float* src = ok ? y + static_cast<long long>(k0 + r) * N + n0 + nn : y;
                if (kVec) sv::cp_async16(ys + r * kMmBN + nn, src, ok);
                else sv::cp_async4(ys + r * kMmBN + nn, src, ok);
            }
        }
        sv::cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < kMmStages - 1; ++s) fetch(s);

    float acc[4][4] = {};
    for (int t = 0; t < n_tiles; ++t) {
        fetch(t + kMmStages - 1);
        sv::cp_async_wait<kMmStages - 1>();
        __syncthreads();
        const float* xs = mm_smem + (t % kMmStages) * kMmStageFloats;
        const float* ys = xs + kMmBM * kMmXStride;
#pragma unroll
        for (int kq = 0; kq < kMmSlice; kq += 4) {
            const int kk = warp * kMmSlice + kq;
            float4 xa[4], yb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                xa[i] = *reinterpret_cast<const float4*>(xs + (tm + 4 * i) * kMmXStride + kk);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                yb[j] = *reinterpret_cast<const float4*>(ys + (kk + j) * kMmBN + tn * 4);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float xv =
                        j == 0 ? xa[i].x : j == 1 ? xa[i].y : j == 2 ? xa[i].z : xa[i].w;
                    acc[i][0] = fmaf(xv, yb[j].x, acc[i][0]);
                    acc[i][1] = fmaf(xv, yb[j].y, acc[i][1]);
                    acc[i][2] = fmaf(xv, yb[j].z, acc[i][2]);
                    acc[i][3] = fmaf(xv, yb[j].w, acc[i][3]);
                }
            }
        }
        __syncthreads();  // the stage is free for tile t + kMmStages
    }
    sv::cp_async_wait<0>();

    // the warps' k slices summed in a fixed order (the ring is free now)
    float* red = mm_smem;  // [kMmWarps][kMmBM][kMmBN]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            red[(warp * kMmBM + tm + 4 * i) * kMmBN + tn * 4 + j] = acc[i][j];
    __syncthreads();
    for (int o = tid; o < kMmBM * kMmBN; o += kMmThreads) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kMmWarps; ++w) s += red[w * kMmBM * kMmBN + o];
        const int r = m0 + o / kMmBN, c = n0 + o % kMmBN;
        if (r < M && c < N) out[static_cast<long long>(r) * N + c] = s;
    }
}

template <bool kVec>
int launch_mm(const float* x, const float* y, float* out, int M, int N, int K,
              cudaStream_t stream) {
    static bool configured = false;
    if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            probe_mm_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmSmem);
        if (e != cudaSuccess) return static_cast<int>(e);
        configured = true;
    }
    const dim3 grid((N + kMmBN - 1) / kMmBN, (M + kMmBM - 1) / kMmBM);
    probe_mm_kernel<kVec><<<grid, kMmThreads, kMmSmem, stream>>>(x, y, out, M, N, K);
    return static_cast<int>(cudaGetLastError());
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

// x [M, K], y [K, N], out [M, N]: f32 row-major, M and N >= 1.
extern "C" int sv_probe_mm(const float* x, const float* y, float* out, int M, int N, int K,
                           void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = K % 4 == 0 && N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                     && reinterpret_cast<uintptr_t>(y) % 16 == 0;
    return vec ? launch_mm<true>(x, y, out, M, N, K, st) : launch_mm<false>(x, y, out, M, N, K, st);
}
