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
//
// Two routes, chosen by the caller (kernels/argmax_matvec.py head_route):
//   * sv_argmax_matvec, the CUDA-core matvec above, for few rows of h (R at
//     most R*, the crossover measured on the card; the constant and its
//     sweep are in argmax_matvec.py) and for every f32 table;
//   * sv_argmax_matvec_tc, a tensor-core tile product fused with the
//     argmax, for bf16 and int8 tables above R*.  The CUDA-core route's
//     f32 FMAs grow with R (2 R V H: 19.9 GFLOP at R 64, 0.3 ms at the
//     CUDA cores' 67 TFLOP/s even before its passes re-read the table),
//     while on the tensor cores the same products stay far below the
//     table's read time up to R ~ 300 (989 TFLOP/s; 295 flops per byte).
//     bf16 x bf16 products are exact in f32 and int8 -> bf16 is exact, so
//     mma.sync.m16n8k16 with f32 accumulation computes the same function;
//     only the summation order differs.  An f32 table has no such product
//     short of a 3xTF32 split, so it stays on the CUDA cores for every R.
//
// Tensor-core design (A = the weight table: M = vocabulary rows; B = h:
// N = R; K = H):
//   * h is rounded to bf16 once, into scratch [R, H] (`hb`), by a small
//     kernel; a pass takes up to 256 rows of h (R padded to 32, 64, 128 or
//     256 columns), so for any R <= 256 the table is read once per call;
//   * persistent blocks of 8 warps each walk tiles of 128 vocabulary rows,
//     every tile over H in runs of 128 bytes of each W row per stage (64
//     bf16 or 128 int8 weights), through a cp.async ring that carries on
//     from one tile into the next (3 stages for bf16; 2 for int8, where
//     more resident blocks beat a deeper ring); a stage holds the W chunk
//     (bf16 swizzled for conflict-free ldmatrix, or int8 rows padded to 144
//     bytes) and the matching [N, BK] chunk of hb, which L2 serves to every
//     block; rows past V and columns past R are zero-filled, never read;
//   * the 8 warps are 4 (M, 32 rows) x 2 (N, half the columns) for bf16 and
//     8 x 1 for int8, and keep their accumulators in registers; int8
//     weights are widened to bf16 in registers as the A fragments are
//     formed, each row by one warp only (exact: byte_perms and one
//     subtraction per weight, from one 4-byte shared load per row, since hb
//     is stored in the matching k order), the row scale is applied in the
//     epilogue;
//   * epilogue per tile: each column's best (value, row) of the tile as the
//     64-bit key below, reduced over the 8 lanes that share a column, folded
//     into a shared-memory atomicMax; once per block, one global atomicMax
//     per column; argmax_finish_kernel turns the keys into int32.  The [R, V]
//     logits never leave the registers.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// the tensor-core route
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;     // vocabulary rows per tile (BM)
constexpr int kTcRowBytes = 128; // bytes of each W row per pipeline stage: BK 64 bf16, 128 int8
constexpr int kTcMaxCols = 256;  // columns (rows of h) per pass

// hb = bf16(h).  With `permute` (the int8 table), each group of 16 along H
// is stored in the mma k order that lets a lane take its int8 A operands
// as one 4-byte word per row: logical k {2t, 2t+1, 2t+8, 2t+9} of lane t
// holds physical k 4t..4t+3 (a dot product does not depend on the order
// of its terms, so W's bytes keep their order).
__global__ void round_bf16_kernel(const float* __restrict__ h, __nv_bfloat16* __restrict__ hb,
                                  long long n, int permute) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        const int j = static_cast<int>(i % 16);
        const long long src = permute ? i - j + 4 * ((j % 8) / 2) + 2 * (j / 8) + j % 2 : i;
        hb[i] = __float2bfloat16_rn(h[src]);
    }
}

// bytes of one W row of a stage in shared memory
template <typename W>
struct TcW;

template <>
struct TcW<__nv_bfloat16> {
    static constexpr int kWarpsN = 2;           // warps along N (the rest along M)
    static constexpr int kStages = 3;           // depth of the cp.async ring
    static constexpr int kK = kTcRowBytes / 2;  // H per stage
    static constexpr int kRowBytes = kTcRowBytes;  // 8 swizzled 16-byte chunks
    __device__ __forceinline__ static int offset(int row, int chunk) {
        return sv::swz(row, chunk, kRowBytes / 16);
    }
    // A fragment of rows r0..r0+15, k kk*16..kk*16+15 of the stage
    __device__ __forceinline__ static void frag(const unsigned char* ws, int r0, int kk,
                                                unsigned (&a)[4]) {
        const int lane = threadIdx.x % 32;
        sv::ldmatrix_x4(a, ws + offset(r0 + (lane & 15), kk * 2 + (lane >> 4)));
    }
};

template <>
struct TcW<int8_t> {
    static constexpr int kWarpsN = 1;       // every warp widens only its own rows
    static constexpr int kStages = 2;       // more resident blocks beat a deeper ring
    static constexpr int kK = kTcRowBytes;  // H per stage
    static constexpr int kRowBytes = kTcRowBytes + 16;  // padded: no bank conflict
    __device__ __forceinline__ static int offset(int row, int chunk) {
        return row * kRowBytes + chunk * 16;
    }
    // four int8 -> two bf16x2, exactly: byte b + 128 becomes the mantissa of
    // 2^23 (one byte_perm), one f32 subtraction of 2^23 + 128 gives b, whose
    // f32 bits end in 16 zeros, so its upper half is bf16(b): one byte_perm
    // packs two (no conversion instruction)
    __device__ __forceinline__ static void widen4(unsigned word, unsigned& lo, unsigned& hi) {
        const unsigned x = word ^ 0x80808080u;
        unsigned f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            f[i] = __float_as_uint(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | i)) -
                                   8388736.f);
        lo = __byte_perm(f[0], f[1], 0x7632u);
        hi = __byte_perm(f[2], f[3], 0x7632u);
    }
    // with hb in the permuted k order (round_bf16_kernel), lane t's operands
    // of row r are the 4 bytes at k 4t..4t+3 of the 16-chunk
    __device__ __forceinline__ static void frag(const unsigned char* ws, int r0, int kk,
                                                unsigned (&a)[4]) {
        const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
        const unsigned char* p = ws + (r0 + g) * kRowBytes + kk * 16 + 4 * t;
        widen4(*reinterpret_cast<const unsigned*>(p), a[0], a[2]);
        widen4(*reinterpret_cast<const unsigned*>(p + 8 * kRowBytes), a[1], a[3]);
    }
};

// bytes of one pipeline stage and of the block's shared memory, at N columns
template <typename W, int N>
struct TcRing {
    static constexpr int kStage = kTcRows * TcW<W>::kRowBytes + N * TcW<W>::kK * 2;
    static constexpr int kBest = N * 8;  // the block's keys
    static constexpr int kStages = TcW<W>::kStages;
    static constexpr size_t kSmem = static_cast<size_t>(kStages) * kStage + kBest;
    static_assert(kSmem <= kMaxSmem, "the ring does not fit in a block's shared memory");
};

// N: columns of this pass (rows of h, padded); the 8 warps are WM x WN
// (M x N), each MT m-tiles of 16 rows by NT n-tiles of 8 columns
template <typename W, int N, bool kScaled>
__global__ void __launch_bounds__(kThreads)
argmax_mma_kernel(const __nv_bfloat16* __restrict__ hb, const W* __restrict__ w,
                  const float* __restrict__ scale, unsigned long long* __restrict__ keys,
                  int R, int H, int V, int col0, int n_tiles) {
    constexpr int WN = TcW<W>::kWarpsN, WM = kWarps / WN;
    constexpr int MT = kTcRows / (16 * WM), NT = N / (8 * WN);
    static_assert(NT % 2 == 0, "n-tiles are loaded in pairs");
    constexpr int BK = TcW<W>::kK;                   // H per stage
    constexpr int HC = BK * 2 / 16;                  // 16-byte chunks per hb row and stage
    constexpr int W_BYTES = kTcRows * TcW<W>::kRowBytes;
    constexpr int H_BYTES = N * BK * 2;
    constexpr int STAGE = W_BYTES + H_BYTES;
    constexpr int STAGES = TcRing<W, N>::kStages;
    static_assert(STAGE == TcRing<W, N>::kStage, "stage layout");
    constexpr int W_CHUNKS = kTcRowBytes / 16;       // 16-byte chunks per W row and stage
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned long long* best = reinterpret_cast<unsigned long long*>(smem + STAGES * STAGE);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int wm = warp % WM, wn = warp / WM;
    const int kc_n = H / BK;
    const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
    const int total = my_tiles * kc_n;

    for (int i = threadIdx.x; i < N; i += kThreads) best[i] = 0ull;

    auto load = [&](int s) {
        unsigned char* st = smem + (s % STAGES) * STAGE;
        const int tile = blockIdx.x + (s / kc_n) * gridDim.x;
        const int k0 = (s % kc_n) * BK;
        const int v0 = tile * kTcRows;
        for (int i = threadIdx.x; i < kTcRows * W_CHUNKS; i += kThreads) {
            const int r = i / W_CHUNKS, c = i % W_CHUNKS;
            const int v = v0 + r;
            const W* src = w + static_cast<long long>(min(v, V - 1)) * H + k0 +
                           c * (16 / static_cast<int>(sizeof(W)));
            sv::cp_async16(st + TcW<W>::offset(r, c), src, v < V);
        }
        unsigned char* hs = st + W_BYTES;
        for (int i = threadIdx.x; i < N * HC; i += kThreads) {
            const int n = i / HC, c = i % HC;
            const int row = col0 + n;
            const __nv_bfloat16* src = hb + static_cast<long long>(min(row, R - 1)) * H + k0 + c * 8;
            sv::cp_async16(hs + sv::swz(n, c, HC), src, row < R);
        }
    };

    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < total) load(s);
        sv::cp_async_commit();
    }
    for (int s = 0; s < total; ++s) {
        sv::cp_async_wait<STAGES - 2>();
        __syncthreads();  // stage s has landed; stage s - 1 is consumed by all
        if (s + STAGES - 1 < total) load(s + STAGES - 1);
        sv::cp_async_commit();

        const unsigned char* ws = smem + (s % STAGES) * STAGE;
        const unsigned char* hs = ws + W_BYTES;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            unsigned a[MT][4];
#pragma unroll
            for (int m = 0; m < MT; ++m) TcW<W>::frag(ws, (wm * MT + m) * 16, kk, a[m]);
#pragma unroll
            for (int jj = 0; jj < NT / 2; ++jj) {
                // n-tiles 2 jj and 2 jj + 1: matrices (n 0-7, k 0-7), (n 0-7,
                // k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
                const int mi = lane >> 3;
                const int n = wn * 8 * NT + jj * 16 + (mi >> 1) * 8 + (lane & 7);
                unsigned b[4];
                sv::ldmatrix_x4(b, hs + sv::swz(n, kk * 2 + (mi & 1), HC));
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                    sv::mma_bf16(acc[m][2 * jj], a[m], b[0], b[1]);
                    sv::mma_bf16(acc[m][2 * jj + 1], a[m], b[2], b[3]);
                }
            }
        }

        if (s % kc_n == kc_n - 1) {
            // epilogue of this tile: each column's best key over its 128 rows
            const int v0 = (blockIdx.x + (s / kc_n) * gridDim.x) * kTcRows + wm * MT * 16 + g;
            float sc[2 * MT];
#pragma unroll
            for (int i = 0; i < 2 * MT; ++i) {  // rows v0, v0 + 8, ...
                const int v = v0 + 8 * i;
                sc[i] = kScaled && v < V ? scale[v] : 1.f;
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    unsigned long long key = 0ull;
#pragma unroll
                    for (int i = 0; i < 2 * MT; ++i) {
                        const int v = v0 + 8 * i;
                        const float x = acc[i / 2][j][(i % 2) * 2 + e];
                        if (v < V) {
                            const unsigned long long k = pack(kScaled ? x * sc[i] : x, v);
                            key = k > key ? k : key;
                        }
                    }
#pragma unroll
                    for (int o = 4; o < 32; o <<= 1) {
                        const unsigned long long k = __shfl_xor_sync(0xffffffffu, key, o);
                        key = k > key ? k : key;
                    }
                    if (g == 0) atomicMax(&best[wn * 8 * NT + 8 * j + 2 * t + e], key);
                }
#pragma unroll
                for (int m = 0; m < MT; ++m)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < N; i += kThreads)
        if (col0 + i < R) atomicMax(&keys[col0 + i], best[i]);
}

template <typename W, int N, bool kScaled>
int launch_tc(const __nv_bfloat16* hb, const void* w, const float* scale,
              unsigned long long* keys, int R, int H, int V, int col0, cudaStream_t stream) {
    auto kernel = argmax_mma_kernel<W, N, kScaled>;
    const size_t smem = TcRing<W, N>::kSmem;
    cudaError_t e;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n_tiles = (V + kTcRows - 1) / kTcRows;
    const int blocks = max(1, min(n_tiles, sms * max(per_sm, 1)));
    kernel<<<blocks, kThreads, smem, stream>>>(hb, static_cast<const W*>(w), scale, keys, R, H,
                                               V, col0, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

template <typename W, bool kScaled>
int by_cols(const __nv_bfloat16* hb, const void* w, const float* scale,
            unsigned long long* keys, int R, int H, int V, cudaStream_t st) {
    for (int col0 = 0; col0 < R; col0 += kTcMaxCols) {
        const int n = min(R - col0, kTcMaxCols);
        const int rc =
            n <= 32 ? launch_tc<W, 32, kScaled>(hb, w, scale, keys, R, H, V, col0, st)
            : n <= 64 ? launch_tc<W, 64, kScaled>(hb, w, scale, keys, R, H, V, col0, st)
            : n <= 128 ? launch_tc<W, 128, kScaled>(hb, w, scale, keys, R, H, V, col0, st)
                       : launch_tc<W, 256, kScaled>(hb, w, scale, keys, R, H, V, col0, st);
        if (rc != 0) return rc;
    }
    return 0;
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

// The tensor-core route: w_kind 0 bf16 or 2 int8 (with `scale`); hb: R x H
// bf16 of scratch for the rounded h; keys: R u64 of scratch.  H must be a
// multiple of 128; any R >= 1 (the table is read once per 256 rows of h).
extern "C" int sv_argmax_matvec_tc(const float* h, const void* w, const float* scale, void* hb,
                                   unsigned long long* keys, int* out, int R, int H, int V,
                                   int w_kind, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (R < 1 || H < 1 || V < 1 || H % kTcRowBytes != 0 || (w_kind != 0 && w_kind != 2))
        return static_cast<int>(cudaErrorInvalidValue);
    __nv_bfloat16* hbf = static_cast<__nv_bfloat16*>(hb);
    cudaError_t e = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * R, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long n = static_cast<long long>(R) * H;
    const int blocks = static_cast<int>((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
    round_bf16_kernel<<<blocks, 256, 0, st>>>(h, hbf, n, w_kind == 2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int rc = w_kind == 0 ? by_cols<__nv_bfloat16, false>(hbf, w, nullptr, keys, R, H, V, st)
                               : by_cols<int8_t, true>(hbf, w, scale, keys, R, H, V, st);
    if (rc != 0) return rc;
    argmax_finish_kernel<<<1, 128, 0, st>>>(keys, out, R);
    return static_cast<int>(cudaGetLastError());
}
