// Fused lm_head matvec + argmax (kernels K6 and K7) for Hopper.
//
// Replaces the three Pallas probes of the greedy decode head
// argmax(proj(rms_norm(h), lm_head)):
//   * tools/profile_decode2.py:pallas_argmax_matvec (body _argmax_kernel) and
//     tools/profile_decode3.py:mv_argmax (body _mv_kernel): bf16 weights;
//   * tools/probe_int8.py:mv_q8_argmax (body _mv_q8_kernel): int8 weights with
//     one f32 scale per vocabulary row.
// One source, three instantiations: bf16 (K6), f32 (the --f32 engine's head)
// and int8 + scale (K7).  For each of R hidden rows h_r it returns
//     argmax_v  (c(h_r) . W[v]) * s[v]      (s == 1 without scales)
// with f32 accumulation and the FIRST index on ties (jnp.argmax and the Pallas
// kernels' strict `>` merge), where c rounds h to bf16 unless W is f32, as the
// port's `linear` casts activations to the weight dtype.  The [R, V] logits
// never reach device memory.
//
// Bound on the card: bytes.  The weight table is read once per call (0.6B:
// 311 MB bf16, 156 MB int8 + 0.6 MB of scales, 622 MB f32) for 2 R flops per
// weight, far below the card's ops:byte balance.  The design reads every
// weight byte exactly once, in 16-byte coalesced loads, with enough blocks in
// flight to fill the memory system:
//   * the grid is one full wave of resident blocks (occupancy query), each a
//     contiguous slice of the vocabulary; a warp takes U = 2 or 4 whole
//     neighbouring rows of W per step (a lane loads 16 bytes per row and
//     chunk, the warp one contiguous 512-byte segment), so their loads are in
//     flight together; each row is a dot product in f32 finished by a
//     warp-shuffle reduction, then the int8 row scale;
//   * every block keeps the rows of h in shared memory (permuted so that
//     each 16-byte shared load of a warp is 512 contiguous bytes: no bank
//     conflict), and a warp folds each loaded weight chunk into G <= 8 rows
//     of h at a time, each h value read once for U weight rows; for R > 8
//     the next group re-reads the weight rows from L1.  All R rows are
//     staged at once when they fit in a block's shared memory (0.6B: up to
//     55 rows), so the table is read once per call; a larger R (a wide
//     serving batch) is taken in the fewest equal passes of rows that fit,
//     each pass re-staging h and reading the table again;
//   * blocks run in no order, so the result must not depend on order: each
//     candidate is a 64-bit key (order-preserving float bits << 32 | ~index),
//     whose maximum is the largest value and, among equal values, the lowest
//     index.  Blocks fold keys with a shared-memory atomicMax, then one
//     global atomicMax per row; a one-block second kernel turns the keys
//     into the int32 [R] result.  No (value, index) race, no float order.
//
// Layout: h [R, H] f32; W [V, H] row-major (bf16, f32 or int8), unpadded: the
// kernel masks its own ragged edge; scale [V] f32 (int8 only); keys [R] u64
// scratch; out [R] int32.  H must be a whole number of warp-wide chunks
// (32 lanes x 16 bytes of weights): 256 bf16, 128 f32 or 512 int8.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a Hopper block may use

// 16-byte loads of a weight row, widened to f32
template <typename W>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&o)[N]) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
        const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(b[i]);
            o[2 * i] = f.x;
            o[2 * i + 1] = f.y;
        }
    }
};

template <>
struct Vec<float> {
    static constexpr int N = 4;
    __device__ __forceinline__ static void load(const float* p, float (&o)[N]) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(p));
        o[0] = f.x;
        o[1] = f.y;
        o[2] = f.z;
        o[3] = f.w;
    }
};

template <>
struct Vec<int8_t> {
    static constexpr int N = 16;
    __device__ __forceinline__ static void load(const int8_t* p, float (&o)[N]) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
        const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
        for (int i = 0; i < N; ++i) o[i] = static_cast<float>(b[i]);
    }
};

// Larger key <=> larger value, then lower index.  -0 is folded into +0 so
// that equal values compare equal, as in argmax.
__device__ __forceinline__ unsigned long long pack(float value, int index) {
    unsigned int u = __float_as_uint(value == 0.f ? 0.f : value);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (static_cast<unsigned long long>(u) << 32) |
           static_cast<unsigned int>(~static_cast<unsigned int>(index));
}

template <typename W, int G, int U, bool kScaled>
__global__ void __launch_bounds__(kThreads)
argmax_matvec_kernel(const float* __restrict__ h, const W* __restrict__ w,
                     const float* __restrict__ scale, unsigned long long* __restrict__ keys,
                     int R, int H, int V, int rows_per_block, int rows_per_pass,
                     int round_bf16) {
    constexpr int N = Vec<W>::N;    // weights per 16-byte load
    constexpr int CH = 32 * N;      // weights per warp-wide chunk of a row
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned long long* best = reinterpret_cast<unsigned long long*>(smem);  // [rows_per_pass]
    float* hs = reinterpret_cast<float*>(smem + ((rows_per_pass * 8 + 15) / 16) * 16);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int v0 = blockIdx.x * rows_per_block;
    const int v1 = min(v0 + rows_per_block, V);
    const float4* hs4 = reinterpret_cast<const float4*>(hs);
    for (int p0 = 0; p0 < R; p0 += rows_per_pass) {
        const int P = min(rows_per_pass, R - p0);  // rows of h in this pass
        // Stage rows p0..p0+P of h in the order the lanes read them: in each
        // chunk, element e of lane l sits at float4 (e / 4) * 32 + l, so
        // every 16-byte shared load of a warp reads 512 contiguous bytes.
        const float* hp = h + static_cast<long long>(p0) * H;
        for (int i = threadIdx.x; i < P * H; i += kThreads) {
            const int x = i % H, c0 = x - x % CH, l = (x - c0) / N, e = (x - c0) % N;
            float v = hp[i];
            if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
            hs[i - x + c0 + (e / 4) * 128 + l * 4 + e % 4] = v;
        }
        for (int i = threadIdx.x; i < P; i += kThreads) best[i] = 0ull;
        __syncthreads();

        const int n_groups = (P + G - 1) / G;
        // a warp takes U neighbouring rows per step: their loads are in
        // flight together, and every h value read from shared memory serves
        // U rows
        for (int v = v0 + warp * U; v < v1; v += kWarps * U) {
            const W* wr[U];
            float sc[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int vu = min(v + u, v1 - 1);
                wr[u] = w + static_cast<long long>(vu) * H + lane * N;
                sc[u] = kScaled ? scale[vu] : 1.f;
            }
            for (int g = 0; g < n_groups; ++g) {
                // rows past P in the last group repeat row P-1; their sums
                // are dropped
                int hoff[G];
                float acc[U][G];
#pragma unroll
                for (int r = 0; r < G; ++r) {
                    hoff[r] = min(g * G + r, P - 1) * H / 4 + lane;
#pragma unroll
                    for (int u = 0; u < U; ++u) acc[u][r] = 0.f;
                }
#pragma unroll 2
                for (int c0 = 0; c0 < H; c0 += CH) {
                    float wv[U][N];
#pragma unroll
                    for (int u = 0; u < U; ++u) Vec<W>::load(wr[u] + c0, wv[u]);
#pragma unroll
                    for (int j = 0; j < N / 4; ++j) {
#pragma unroll
                        for (int r = 0; r < G; ++r) {
                            const float4 x = hs4[hoff[r] + c0 / 4 + j * 32];
#pragma unroll
                            for (int u = 0; u < U; ++u) {
                                acc[u][r] = fmaf(wv[u][4 * j], x.x, acc[u][r]);
                                acc[u][r] = fmaf(wv[u][4 * j + 1], x.y, acc[u][r]);
                                acc[u][r] = fmaf(wv[u][4 * j + 2], x.z, acc[u][r]);
                                acc[u][r] = fmaf(wv[u][4 * j + 3], x.w, acc[u][r]);
                            }
                        }
                    }
                }
                // lane r holds the U sums of row g*G + r; one atomic per step
                unsigned long long key = 0ull;
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    float mine = 0.f;
#pragma unroll
                    for (int r = 0; r < G; ++r) {
                        const float s = sv::warp_sum(acc[u][r]);
                        if (lane == r) mine = s;
                    }
                    if (v + u < v1) {
                        const unsigned long long k = pack(kScaled ? mine * sc[u] : mine, v + u);
                        key = k > key ? k : key;
                    }
                }
                const int row = g * G + lane;
                if (lane < G && row < P) atomicMax(&best[row], key);
            }
        }
        __syncthreads();
        for (int i = threadIdx.x; i < P; i += kThreads) atomicMax(&keys[p0 + i], best[i]);
        __syncthreads();  // the next pass overwrites best and hs
    }
}

__global__ void argmax_finish_kernel(const unsigned long long* __restrict__ keys,
                                     int* __restrict__ out, int R) {
    for (int i = threadIdx.x; i < R; i += blockDim.x)
        out[i] = static_cast<int>(~static_cast<unsigned int>(keys[i] & 0xffffffffull));
}

template <typename W, int G, bool kScaled>
int launch(const float* h, const void* w, const float* scale, unsigned long long* keys,
           int* out, int R, int H, int V, int round_bf16, cudaStream_t stream) {
    // more rows per warp step where few rows of h leave registers free
    constexpr int U = G <= 2 ? 4 : 2;
    auto kernel = argmax_matvec_kernel<W, G, U, kScaled>;
    // the fewest equal passes whose rows of h (plus their keys) fit in one
    // block's shared memory
    const int fit = (kMaxSmem - 16) / (H * static_cast<int>(sizeof(float)) + 8);
    if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int passes = (R + fit - 1) / fit;
    const int rows_per_pass = (R + passes - 1) / passes;
    const size_t smem = ((rows_per_pass * 8 + 15) / 16) * 16 +
                        static_cast<size_t>(rows_per_pass) * H * sizeof(float);
    cudaError_t e;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    // one full wave of resident blocks, each a contiguous slice of the rows
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = max(1, min(sms * max(per_sm, 1), (V + kWarps * U - 1) / (kWarps * U)));
    const int rows_per_block = (V + blocks - 1) / blocks;
    e = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * R, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<blocks, kThreads, smem, stream>>>(h, static_cast<const W*>(w), scale, keys, R, H, V,
                                               rows_per_block, rows_per_pass, round_bf16);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    argmax_finish_kernel<<<1, 128, 0, stream>>>(keys, out, R);
    return static_cast<int>(cudaGetLastError());
}

template <typename W, bool kScaled>
int by_group(const float* h, const void* w, const float* scale, unsigned long long* keys,
             int* out, int R, int H, int V, int round_bf16, cudaStream_t st) {
    switch (R < 8 ? R : 8) {
        case 1: return launch<W, 1, kScaled>(h, w, scale, keys, out, R, H, V, round_bf16, st);
        case 2: return launch<W, 2, kScaled>(h, w, scale, keys, out, R, H, V, round_bf16, st);
        case 3: return launch<W, 3, kScaled>(h, w, scale, keys, out, R, H, V, round_bf16, st);
        case 4: return launch<W, 4, kScaled>(h, w, scale, keys, out, R, H, V, round_bf16, st);
        case 5: return launch<W, 5, kScaled>(h, w, scale, keys, out, R, H, V, round_bf16, st);
        case 6: return launch<W, 6, kScaled>(h, w, scale, keys, out, R, H, V, round_bf16, st);
        case 7: return launch<W, 7, kScaled>(h, w, scale, keys, out, R, H, V, round_bf16, st);
        case 8: return launch<W, 8, kScaled>(h, w, scale, keys, out, R, H, V, round_bf16, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// w_kind: 0 bf16, 1 f32, 2 int8 (with `scale`).  h is rounded to bf16 first
// for bf16 and int8 weights.  keys: R u64 of scratch.  H must be a multiple
// of 256 (bf16), 128 (f32) or 512 (int8); any R >= 1.
extern "C" int sv_argmax_matvec(const float* h, const void* w, const float* scale,
                                unsigned long long* keys, int* out, int R, int H, int V,
                                int w_kind, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // whole chunks only: H a multiple of 32 lanes x one 16-byte load
    const int chunk = w_kind == 0 ? 256 : (w_kind == 1 ? 128 : 512);
    if (R < 1 || H < 1 || V < 1 || H % chunk != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    switch (w_kind) {
        case 0: return by_group<__nv_bfloat16, false>(h, w, nullptr, keys, out, R, H, V, 1, st);
        case 1: return by_group<float, false>(h, w, nullptr, keys, out, R, H, V, 0, st);
        case 2: return by_group<int8_t, true>(h, w, scale, keys, out, R, H, V, 1, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
