// Encoder window attention (kernel B1) for Hopper.
//
// Replaces: smolvision_tpu/kernels/flash_attention.py:window_flash_attention
// (Pallas body _window_kernel): bidirectional attention inside hard windows,
// keys >= kv_lens[w] masked, a window with no valid key returns 0, pad query
// rows attend the valid keys like any other row (finite garbage).
//
// Bound on the card: bytes at every ported shape.  The encoder's windows
// (S 104, H 14, D 64) move 4.8 MB of q/k/v/out at the offline path's W 4,
// 29 MB at -S 20's W 24 and 39 MB at a --serve 64 encode group's W 32,
// against products that the tensor cores take in a fraction of that time
// (in f32 on the CUDA cores they took as long as the bytes, and the f32
// core this replaces took 11x the bound at W 4).  A window of up to 128
// rows fits one block whole, as it fits the TPU kernel's VMEM, so its keys
// need no online softmax:
//   * window-resident route (S <= 128): one block holds one (window, head).
//     It copies the window's K and V rows [0, len) once (cp.async, rows
//     zero-filled up to a multiple of 16 keys; no key at or past len is
//     read) and splits each once into bf16 hi and lo tiles in shared
//     memory; q comes straight from global memory into registers, scaled
//     and split into the staging area V has left.  Each warp owns 16 query
//     rows (rows past S are dead: they store nothing, and a block at small
//     S launches fewer warps), computes its 16 x len scores with three
//     mma.sync per product (hi.hi + lo.hi + hi.lo: the error budget of
//     mma_attention.cuh's f32 segment), takes one exact softmax in the
//     fragment layout (exp2 of scores in log2 units) and P.V with three
//     products again.  The products are instantiated per count of 16-key
//     tiles (1-8) and picked once per block: a branch per tile inside them
//     left each warp waiting on every mma's latency.  84 KB of shared
//     memory at S 104, so two blocks fit one SM.  A grid of W * H blocks
//     under one wave (the offline W 4: 56 blocks for 132 SMs) leaves most
//     SMs idle, so the host splits a window's warps over two blocks that
//     each load its K/V (the second time from L2) while the split grid
//     still fits one wave: `window_row_blocks` in kernels/flash_attention.py.
//     On an H100 80GB HBM3 at 700 W the split was faster at W 4 and slower
//     at W 24 and W 32 (chip_smoke.py's window split sweep; PERF.md);
//   * query-tiled route (S > 128, which no configuration reaches today):
//     blocks of 64 query rows walk the keys [0, len) as one non-causal f32
//     key segment of the tensor-core core (B4's route with G 1).
// Both count as one `window_attention` launch.  A window with len 0 loads
// no key and stores exactly 0.
//
// Layout: q, k, v, out are contiguous [W, S, H, D] f32 with 16-byte
// aligned rows; kv_lens [W] int32 on the device.  Grid (W * H, blocks per
// (window, head)); dynamic shared memory above the 48 KB static limit.

#include "mma_attention.cuh"

namespace {

constexpr int kD = 64;          // the head dim of every encoder in config.py
constexpr int kWinRows = 128;   // rows (and keys) one block of the resident route holds

// Dynamic shared memory of the resident route for windows of S rows and
// blocks of rb rows, nk = S rounded up to 16 bounding every window's keys:
// K hi and lo, region A (K's f32 staging tile, then V hi and lo), region B
// (V's f32 staging tile, then the block's Q hi and lo).
size_t resident_smem_bytes(int S, int rb) {
    const int nk = (S + 15) / 16 * 16;
    return (size_t)2 * nk * kD * 2 + (size_t)nk * kD * 4 + (size_t)(nk > rb ? nk : rb) * kD * 4;
}

constexpr float kLog2e = 1.4426950408889634f;

// The resident route's bf16 tiles in shared memory (swizzled rows of D / 8
// 16-byte chunks): the warp's 16 rows of Q hi / lo, the window's K and V hi
// / lo.
struct WindowTiles {
    const unsigned char *qh, *ql, *kh, *kl, *vh, *vl;
};

// The warp's 16 query rows against the window's first 16 * N16 keys, len
// of them valid: S = Q K^T, one exact softmax (scores in log2 units for
// exp2; masked p exactly 0), O = P V, three products each.  Stores rows r
// < n_rows at o_rows + r * row, normalised.  N16 is a constant, so each
// product is straight-line code (a branch per 16 keys left each warp
// waiting on every mma's latency).
template <int N16>
__device__ __forceinline__ void attend_rows(const WindowTiles& t, int len, float* o_rows,
                                            long long row, int n_rows) {
    constexpr int D = kD;
    const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
    float s[2 * N16][4];
#pragma unroll
    for (int j = 0; j < 2 * N16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    sv::mma_scores<D, 16 * N16, true>(s, t.qh, t.ql, t.kh, t.kl);

    float l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float mx = sv::kNegInf;
#pragma unroll
        for (int j = 0; j < 2 * N16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                if (8 * j + 2 * t4 + e < len) mx = fmaxf(mx, s[j][2 * i + e]);
        const float mb = sv::quad_max(mx) * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2 * N16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float p =
                    8 * j + 2 * t4 + e < len ? exp2f(fmaf(s[j][2 * i + e], kLog2e, -mb)) : 0.f;
                s[j][2 * i + e] = p;
                sum += p;
            }
        l[i] = sv::quad_sum(sum);
    }

    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    sv::mma_pv<D, 16 * N16, true>(o, s, t.vh, t.vl);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = g + 8 * i;
        if (r >= n_rows) continue;
        const float inv = 1.f / fmaxf(l[i], sv::kDenomFloor);
        float* op = o_rows + r * row + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<float2*>(op + 8 * j) = make_float2(o[j][2 * i] * inv,
                                                                 o[j][2 * i + 1] * inv);
    }
}

// (..., 2): two 8-warp blocks per SM, so that ptxas keeps to 128 registers
__global__ void __launch_bounds__(32 * (kWinRows / 16), 2)
window_resident_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int* __restrict__ kv_lens,
                       float* __restrict__ out, int S, int H, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int D = kD, DC = D / 8;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int warp = tid / 32, lane = tid % 32;
    const int w = blockIdx.x / H, h = blockIdx.x % H;
    const int rb = nthreads / 32 * 16;           // the block's rows
    const int t0 = blockIdx.y * rb + warp * 16;  // the warp's first row
    const long long row = (long long)H * D;
    const long long base = (long long)w * S * row + (long long)h * D;

    // the warp's 16 rows of q, in flight during the copies below: lane l
    // holds float4 l % 16 of rows t0 + 2 j + l / 16
    float4 xq[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int t = t0 + 2 * j + lane / 16;
        xq[j] = t < S ? __ldg(reinterpret_cast<const float4*>(q + base + (long long)t * row) +
                              lane % 16)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }

    const int len = min(max(kv_lens[w], 0), S);
    const int nk = (len + 15) / 16 * 16;         // keys held, zero-filled past len
    const int nk_cap = (S + 15) / 16 * 16;
    unsigned char* kh = smem;
    unsigned char* kl = kh + nk_cap * D * 2;
    unsigned char* ra = kl + nk_cap * D * 2;     // region A
    unsigned char* rbuf = ra + nk_cap * D * 4;   // region B
    unsigned char* vh = ra;
    unsigned char* vl = ra + nk_cap * D * 2;

    // K into region A and V into region B, rows [0, len), zero-filled to nk
    for (int i = tid; i < nk * D / 4; i += nthreads) {
        const int r = i / (D / 4), c = i % (D / 4);
        sv::cp_async16(ra + i * 16, k + base + (long long)(r < len ? r : 0) * row + c * 4,
                       r < len);
    }
    sv::cp_async_commit();
    for (int i = tid; i < nk * D / 4; i += nthreads) {
        const int r = i / (D / 4), c = i % (D / 4);
        sv::cp_async16(rbuf + i * 16, v + base + (long long)(r < len ? r : 0) * row + c * 4,
                       r < len);
    }
    sv::cp_async_commit();

    sv::cp_async_wait<1>();
    __syncthreads();  // K's f32 rows are in region A
    sv::split_tile<D>(ra, kh, kl, nk, tid, nthreads);
    sv::cp_async_wait<0>();
    __syncthreads();  // V's f32 rows are in region B; region A is read
    sv::split_tile<D>(rbuf, vh, vl, nk, tid, nthreads);
    __syncthreads();  // V hi / lo are written; region B is free
    if (t0 >= S) return;  // a dead warp (no barrier follows)

    float* o_rows = out + base + (long long)t0 * row;
    const int n_rows = min(S - t0, 16);
    if (nk == 0) {  // no valid key: exactly 0
        for (int i = lane; i < n_rows * D / 4; i += 32)
            *reinterpret_cast<float4*>(o_rows + (i / (D / 4)) * row + (i % (D / 4)) * 4) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        return;
    }

    // the warp's Q hi / lo rows into region B
    unsigned char* qh = rbuf + warp * 16 * D * 2;
    unsigned char* ql = rbuf + rb * D * 2 + warp * 16 * D * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int r = 2 * j + lane / 16, c = (lane % 16) / 2, half = lane % 2;
        uint2 hv, lv;
        sv::split_bf16x2(xq[j].x * scale, xq[j].y * scale, hv.x, lv.x);
        sv::split_bf16x2(xq[j].z * scale, xq[j].w * scale, hv.y, lv.y);
        *reinterpret_cast<uint2*>(qh + sv::swz(r, c, DC) + 8 * half) = hv;
        *reinterpret_cast<uint2*>(ql + sv::swz(r, c, DC) + 8 * half) = lv;
    }
    __syncwarp();

    const WindowTiles t{qh, ql, kh, kl, vh, vl};
    switch (nk / 16) {  // the same for the whole block
        case 1: attend_rows<1>(t, len, o_rows, row, n_rows); break;
        case 2: attend_rows<2>(t, len, o_rows, row, n_rows); break;
        case 3: attend_rows<3>(t, len, o_rows, row, n_rows); break;
        case 4: attend_rows<4>(t, len, o_rows, row, n_rows); break;
        case 5: attend_rows<5>(t, len, o_rows, row, n_rows); break;
        case 6: attend_rows<6>(t, len, o_rows, row, n_rows); break;
        case 7: attend_rows<7>(t, len, o_rows, row, n_rows); break;
        default: attend_rows<8>(t, len, o_rows, row, n_rows); break;
    }
}

// S > kWinRows: 64 query rows per block against the keys [0, len) as one
// non-causal f32 segment of the tensor-core core (B4's route, G 1)
__global__ void __launch_bounds__(128, 2)
window_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ kv_lens,
                    float* __restrict__ out, int S, int H, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int w = blockIdx.x / H, h = blockIdx.x % H;
    const int len = min(max(kv_lens[w], 0), S);
    const long long row = (long long)H * kD;
    const long long base = (long long)w * S * row + (long long)h * kD;
    sv::MmaBlock<kD> blk;
    sv::mma_begin<kD, 1>(smem, blk, q + base, row, S, blockIdx.y * sv::kMmaRows, 1, scale);
    sv::mma_attend<kD, 1>(smem, blk,
                          sv::KeySegment<float>{k + base, v + base, row, 0, len, false, 0});
    sv::mma_end<kD, 1>(smem, blk, out + base, row, 1);
}

int launch(const float* q, const float* k, const float* v, const int* kv_lens, float* out,
           int W, int S, int H, int row_blocks, float scale, cudaStream_t stream) {
    if (S > kWinRows) {
        const size_t smem = sv::mma_smem_bytes(kD, 1);
        cudaError_t e = cudaFuncSetAttribute(
            window_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        dim3 grid(W * H, (S + sv::kMmaRows - 1) / sv::kMmaRows);
        window_tiled_kernel<<<grid, 128, smem, stream>>>(q, k, v, kv_lens, out, S, H, scale);
        return (int)cudaGetLastError();
    }
    const int warps16 = (S + 15) / 16;  // 16-row warps a window needs
    const int warps = (warps16 + row_blocks - 1) / row_blocks;
    const size_t smem = resident_smem_bytes(S, 16 * warps);
    cudaError_t e = cudaFuncSetAttribute(window_resident_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(W * H, (warps16 + warps - 1) / warps);
    window_resident_kernel<<<grid, 32 * warps, smem, stream>>>(q, k, v, kv_lens, out, S, H,
                                                                scale);
    return (int)cudaGetLastError();
}

}  // namespace

// row_blocks: blocks per (window, head): 1 or 2 on the resident route,
// ceil(S / 64) on the query-tiled route above 128 rows.
extern "C" int sv_window_attention(const float* q, const float* k, const float* v,
                                   const int* kv_lens, float* out, int W, int S, int H, int D,
                                   int row_blocks, float scale, void* stream) {
    if (W <= 0 || S <= 0) return 0;
    if (D != kD || H <= 0) return (int)cudaErrorInvalidValue;
    if (S > kWinRows ? row_blocks != (S + sv::kMmaRows - 1) / sv::kMmaRows
                     : row_blocks < 1 || row_blocks > 2)
        return (int)cudaErrorInvalidValue;
    return launch(q, k, v, kv_lens, out, W, S, H, row_blocks, scale,
                  static_cast<cudaStream_t>(stream));
}
