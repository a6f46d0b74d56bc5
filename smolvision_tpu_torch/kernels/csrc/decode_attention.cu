// Single-token decode attention (kernel B3) for Hopper.
//
// Replaces: smolvision_tpu/kernels/flash_attention.py:decode_flash_attention
// (Pallas body _decode_kernel): one position's GQA attention over cache rows
// [kv_min, start) plus the fresh k/v row, which is not yet in the cache and
// is always attended (start == 0 gives self-attention only).  Rows at or
// past `start` are neither read nor computed, so the cost follows the live
// context, not the cache capacity.
//
// `start` and `kv_min` are read from device memory, as the Pallas kernel
// takes them as scalar-prefetch operands: the decode step keeps its
// position on the device, and one CUDA graph of the step replays at every
// position (runtime/decode_graph.py).  So the grid cannot follow the
// position either: it is fixed, and each block works out its own rows.
//
// Bound on the card: bytes.  Each cache row is read once for ~4 G D flops,
// orders of magnitude below the card's ops:byte balance, so the time is the
// live rows' bytes at the memory rate plus the latency of getting them in
// flight.  The design:
//   * one launch: a thread block cluster of kBlocks (8, the portable
//     cluster size) blocks per KV head, grid (kBlocks, KH).  Block r of the
//     cluster takes the live rows [kv_min + r chunk, kv_min + (r+1) chunk),
//     chunk = ceil((start - kv_min) / kBlocks), worked out in the kernel; a
//     block with no live row leaves an empty partial (m = -1e30, l = 0,
//     acc = 0), which the merge weighs by exp2(-1e30 - m) = 0.  Each block
//     leaves its partial (m, l, acc[G][D]) in its own shared memory; after
//     cluster.sync() the output's 4-column quads are dealt out over the
//     cluster's threads, and each reads every peer's (m, l, acc quad) at
//     once through distributed shared memory and folds in the fresh row
//     (its values fetched at the start, so the merge waits on no
//     device-memory load); a second cluster.sync() keeps each block's
//     shared memory alive until its peers have read it.  Nothing goes
//     through device memory between the blocks, so there is no scratch to
//     reset, and back-to-back calls and CUDA-graph replays need no memset.
//     8 blocks per KV head is what the host planner of the earlier design
//     picked at every live range above 112 rows, and 12 or 16 were slower
//     on the H100 at 315 and 4095 rows (PERF.md);
//   * every row in flight at once: a block's rows go in tiles of kTile rows
//     (K + V 4 KB) to its 8 warps in turn; each warp copies its own tiles
//     with 16-byte cp.async into a private ring of kStages tiles, so up to
//     kStages x 8 tiles (128 KB, 256 rows of bf16 D 128) per block are in
//     flight before any arithmetic waits, and no __syncthreads stands
//     between a tile's arrival and its use (a row of D 128 bf16 is 16
//     lanes: a warp moves two rows per instruction);
//   * arithmetic per tile, not per row: the scores of the tile's rows (q in
//     registers, one reduction over the kLpr lanes of a row: 4 shuffles for
//     bf16 D 128), then one max and one rescale per head, then P.V with each
//     lane adding its rows into its own 16-byte segment of acc (no
//     shuffle); the warps' partials meet once, in shared memory, at the end.
//     Scores are in log2 units, so each exponential is one exp2f.
// It stays on the CUDA cores in f32: at G <= 8 query rows per KV head a
// tensor-core product would be almost all padding.
//
// Layout: q [H, D] f32; k_new/v_new [KH, D] f32; k/v cache [K, KH, D] (bf16
// or f32) with unit element stride, head stride D, row stride `row_stride`
// (16-byte aligned rows); start and kv_min one int32 each (kv_min may be
// null: 0); out [H, D] f32.

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kBlocks = 8;              // blocks per cluster (one KV head)
constexpr int kWarpTileBytes = 4096;    // K + V of one warp tile
constexpr int kStages = 4;              // warp tiles in flight per warp
constexpr int kSmem = kWarps * kStages * kWarpTileBytes;

template <int D, typename KV>
struct Shape {
    static constexpr int kEpl = 16 / static_cast<int>(sizeof(KV));  // elements per 16 bytes
    static constexpr int kLpr = D / kEpl;                            // lanes per row
    static constexpr int kRpw = 32 / kLpr;                           // rows per warp step
    static constexpr int kTile = kWarpTileBytes / (2 * D * static_cast<int>(sizeof(KV)));
    static constexpr int kSteps = kTile / kRpw;                      // warp steps per tile
};

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 t = __bfloat1622float2(b[j]);
        f[2 * j] = t.x;
        f[2 * j + 1] = t.y;
    }
}

__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
}

// sum (or max) over the row groups of a warp: lanes l and l ^ o for o >= kLpr
template <int kLpr>
__device__ __forceinline__ float across_rows_sum(float x) {
#pragma unroll
    for (int o = 16; o >= kLpr; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

template <int kLpr>
__device__ __forceinline__ float across_rows_max(float x) {
#pragma unroll
    for (int o = 16; o >= kLpr; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// kG: G rounded up to a power of two (heads g >= G compute on zeros and
// are never read or written).
template <int D, typename KV, int kG>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
              const float* __restrict__ v_new, const KV* __restrict__ k,
              const KV* __restrict__ v, float* __restrict__ out, int G, long long row_stride,
              const int* __restrict__ start_at, const int* __restrict__ kv_min_at, float scale) {
    using S = Shape<D, KV>;
    constexpr int kEpl = S::kEpl, kLpr = S::kLpr, kRpw = S::kRpw, kTile = S::kTile;
    constexpr int kSteps = S::kSteps;
    constexpr int kQuads = D / 4;  // 4-column groups of one head's output

    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float4 part[kG * kQuads];   // this block's acc [G][D], read by its peers
    __shared__ float m_s[kG], l_s[kG];     // this block's (m, l), read by its peers
    __shared__ float self_s[kG];

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int kh = blockIdx.y;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    // the position from device memory; the block's share of the live rows
    const int start = *start_at;
    const int kv_min = kv_min_at != nullptr ? *kv_min_at : 0;
    const int chunk = (max(start - kv_min, 0) + kBlocks - 1) / kBlocks;
    const int lo = kv_min + rank * chunk;
    const int hi = min(lo + chunk, start);
    // the block's tiles of kTile rows go to the warps in turn
    const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
    const int n_mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
    const KV* kb = k + static_cast<long long>(kh) * D;
    const KV* vb = v + static_cast<long long>(kh) * D;
    KV* ring = reinterpret_cast<KV*>(smem + warp * kStages * kWarpTileBytes);

    // the warp's i-th tile into its stage i % kStages (K rows, then V
    // rows): the lane copies its own 16-byte segment of rows rl, rl + kRpw,
    // ... of K and of V, the rows it reads back below
    const int seg = (lane % kLpr) * kEpl, rl = lane / kLpr;
    auto fetch = [&](int i) {
        if (i < n_mine) {
            const int r0 = lo + (warp + i * kWarps) * kTile;
            const int nt = min(kTile, hi - r0);
            KV* ks = ring + (i % kStages) * 2 * kTile * D + seg;
            long long off = static_cast<long long>(r0 + rl) * row_stride + seg;
            for (int r = rl; r < nt; r += kRpw, off += kRpw * row_stride) {
                sv::cp_async16(ks + r * D, kb + off, true);
                sv::cp_async16(ks + (kTile + r) * D, vb + off, true);
            }
        }
        sv::cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) fetch(i);

    // q of this lane's 16-byte segment of a row, scaled, for each head.
    // Scores are kept in log2 units (q carries log2(e)), so every softmax
    // exponential is one exp2f (the hardware's ex2) instead of expf's
    // range reduction; the normalised result is the same.
    const float qscale = scale * 1.4426950408889634f;
    float qr[kG][kEpl], acc[kG][kEpl], m[kG], l[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int e = 0; e < kEpl; ++e) {
            qr[g][e] = g < G ? q[(kh * G + g) * D + seg + e] * qscale : 0.f;
            acc[g][e] = 0.f;
        }
        m[g] = sv::kNegInf;
        l[g] = 0.f;
    }
    // this thread's quad of the output (merged at the end, below) and the
    // fresh row's values there, fetched now so the merge waits on no load
    const int o = rank + tid * kBlocks;
    const int og = o / kQuads, od = (o % kQuads) * 4;
    float4 vn4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (o < G * kQuads) {
        const float* vn = v_new + kh * D + od;
        vn4 = make_float4(vn[0], vn[1], vn[2], vn[3]);
    }
    // the fresh row's score, folded in at the merge
    if (warp < G) {
        float s = 0.f;
        for (int d = lane; d < D; d += 32)
            s = fmaf(q[(kh * G + warp) * D + d] * qscale, k_new[kh * D + d], s);
        s = sv::warp_sum(s);
        if (lane == 0) self_s[warp] = s;
    }

    for (int i = 0; i < n_mine; ++i) {
        fetch(i + kStages - 1);
        sv::cp_async_wait<kStages - 1>();
        __syncwarp();
        const KV* ks = ring + (i % kStages) * 2 * kTile * D;
        const KV* vs = ks + kTile * D;
        const int nt = min(kTile, hi - (lo + (warp + i * kWarps) * kTile));

        // scores of the tile's rows: the kLpr lanes of a row hold one
        // 16-byte segment each and reduce over themselves (4 shuffles for
        // bf16 D 128); rows past nt hold stale data and score -inf
        float s[kSteps][kG], tmax[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) tmax[g] = sv::kNegInf;
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
            const int r = st * kRpw + rl;
            float kf[kEpl];
            load16(ks + r * D + seg, kf);
#pragma unroll
            for (int g = 0; g < kG; ++g) {
                float x = 0.f;
#pragma unroll
                for (int e = 0; e < kEpl; ++e) x = fmaf(qr[g][e], kf[e], x);
#pragma unroll
                for (int o = kLpr / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
                s[st][g] = r < nt ? x : sv::kNegInf;
                tmax[g] = fmaxf(tmax[g], s[st][g]);
            }
        }
        // one max and one rescale per head for the tile
#pragma unroll
        for (int g = 0; g < kG; ++g) {
            const float m_new = fmaxf(m[g], across_rows_max<kLpr>(tmax[g]));
            const float alpha = exp2f(m[g] - m_new);
            m[g] = m_new;
            l[g] *= alpha;
#pragma unroll
            for (int e = 0; e < kEpl; ++e) acc[g][e] *= alpha;
        }
        // P.V: each lane adds its rows into its own segment of acc
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
            const int r = st * kRpw + rl;
            if (r < nt) {
                float vf[kEpl];
                load16(vs + r * D + seg, vf);
#pragma unroll
                for (int g = 0; g < kG; ++g) {
                    const float p = exp2f(s[st][g] - m[g]);
                    l[g] += p;
#pragma unroll
                    for (int e = 0; e < kEpl; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
                }
            }
        }
        __syncwarp();  // the stage is free for tile i + kStages
    }
    sv::cp_async_wait<0>();

    // the warp's row groups share m: sum their l and acc
#pragma unroll
    for (int g = 0; g < kG; ++g) {
        l[g] = across_rows_sum<kLpr>(l[g]);
#pragma unroll
        for (int e = 0; e < kEpl; ++e) acc[g][e] = across_rows_sum<kLpr>(acc[g][e]);
    }
    __syncthreads();  // every warp is done with its ring: reuse it for the warps' partials
    float* wm = reinterpret_cast<float*>(smem);  // [kWarps][kG]
    float* wl = wm + kWarps * kG;                // [kWarps][kG]
    float* wacc = wl + kWarps * kG;              // [kWarps][kG][D]
    if (lane < kLpr) {
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
            for (int e = 0; e < kEpl; ++e) wacc[(warp * kG + g) * D + seg + e] = acc[g][e];
    }
    if (lane == 0) {
#pragma unroll
        for (int g = 0; g < kG; ++g) {
            wm[warp * kG + g] = m[g];
            wl[warp * kG + g] = l[g];
        }
    }
    __syncthreads();
    // the block's partial: the warps' partials at one max
    if (tid < kG * kQuads) {
        const int g = tid / kQuads, d = (tid % kQuads) * 4;
        float mb = sv::kNegInf;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wm[w * kG + g]);
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        float lb = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const float f = exp2f(wm[w * kG + g] - mb);
            const float4 x = *reinterpret_cast<const float4*>(wacc + (w * kG + g) * D + d);
            a = make_float4(fmaf(f, x.x, a.x), fmaf(f, x.y, a.y), fmaf(f, x.z, a.z),
                            fmaf(f, x.w, a.w));
            lb = fmaf(f, wl[w * kG + g], lb);
        }
        part[tid] = a;
        if (d == 0) {
            m_s[g] = mb;
            l_s[g] = lb;
        }
    }

    cluster.sync();  // every block's partial is in its shared memory
    // quad o of the group's output goes to rank o % kBlocks: its thread
    // reads every peer's (m, l, acc quad) at once through distributed
    // shared memory and folds in the fresh row
    if (o < G * kQuads) {
        float pm[kBlocks], pl[kBlocks];
        float4 x[kBlocks];
#pragma unroll
        for (int r = 0; r < kBlocks; ++r) {
            pm[r] = *cluster.map_shared_rank(&m_s[og], r);
            pl[r] = *cluster.map_shared_rank(&l_s[og], r);
            x[r] = *cluster.map_shared_rank(&part[o], r);
        }
        float mx = self_s[og];
#pragma unroll
        for (int r = 0; r < kBlocks; ++r) mx = fmaxf(mx, pm[r]);
        const float fs = exp2f(self_s[og] - mx);
        float lt = fs;
        float4 a = make_float4(fs * vn4.x, fs * vn4.y, fs * vn4.z, fs * vn4.w);
#pragma unroll
        for (int r = 0; r < kBlocks; ++r) {
            const float f = exp2f(pm[r] - mx);
            lt = fmaf(f, pl[r], lt);
            a = make_float4(fmaf(f, x[r].x, a.x), fmaf(f, x[r].y, a.y), fmaf(f, x[r].z, a.z),
                            fmaf(f, x[r].w, a.w));
        }
        const float inv = 1.f / fmaxf(lt, sv::kDenomFloor);
        float* dst = out + (kh * G + og) * D + od;
        dst[0] = a.x * inv;
        dst[1] = a.y * inv;
        dst[2] = a.z * inv;
        dst[3] = a.w * inv;
    }
    cluster.sync();  // the peers' shared memory stays until every block has read it
}

template <int D, typename KV, int kG>
int launch_g(const float* q, const float* k_new, const float* v_new, const void* k,
             const void* v, float* out, int H, int KH, long long row_stride, const int* start,
             const int* kv_min, float scale, cudaStream_t stream) {
    const int G = H / KH;
    auto* kernel = decode_kernel<D, KV, kG>;
    constexpr int smem = kSmem;
    static bool configured = false;
    if (!configured) {
        const cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        configured = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kBlocks, KH);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kBlocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, q, k_new, v_new,
                                             static_cast<const KV*>(k), static_cast<const KV*>(v),
                                             out, G, row_stride, start, kv_min, scale);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

template <int D, typename KV>
int launch(const float* q, const float* k_new, const float* v_new, const void* k,
           const void* v, float* out, int H, int KH, long long row_stride, const int* start,
           const int* kv_min, int n_blocks, float scale, cudaStream_t stream) {
    const int G = KH > 0 ? H / KH : 0;
    if (G < 1 || G > kMaxG || n_blocks != kBlocks || start == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (G == 1)
        return launch_g<D, KV, 1>(q, k_new, v_new, k, v, out, H, KH, row_stride, start, kv_min,
                                  scale, stream);
    if (G == 2)
        return launch_g<D, KV, 2>(q, k_new, v_new, k, v, out, H, KH, row_stride, start, kv_min,
                                  scale, stream);
    if (G <= 4)
        return launch_g<D, KV, 4>(q, k_new, v_new, k, v, out, H, KH, row_stride, start, kv_min,
                                  scale, stream);
    return launch_g<D, KV, 8>(q, k_new, v_new, k, v, out, H, KH, row_stride, start, kv_min,
                              scale, stream);
}

template <typename KV>
int dispatch(const float* q, const float* k_new, const float* v_new, const void* k,
             const void* v, float* out, int H, int KH, int D, long long row_stride,
             const int* start, const int* kv_min, int n_blocks, float scale, cudaStream_t st) {
    switch (D) {
        case 64:
            return launch<64, KV>(q, k_new, v_new, k, v, out, H, KH, row_stride, start, kv_min,
                                  n_blocks, scale, st);
        case 128:
            return launch<128, KV>(q, k_new, v_new, k, v, out, H, KH, row_stride, start, kv_min,
                                   n_blocks, scale, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// kv_bf16: 1 for a bf16 cache, 0 for f32.  start / kv_min: device pointers
// to one int32 each (kv_min may be null: 0), read by the kernel.  n_blocks
// must be kBlocks (8), the fixed cluster per KV head that the wrapper's
// DECODE_MAX_BLOCKS names.
extern "C" int sv_decode_attention(const float* q, const float* k_new, const float* v_new,
                                   const void* k, const void* v, float* out, int H, int KH, int D,
                                   long long row_stride, const int* start, const int* kv_min,
                                   int n_blocks, int kv_bf16, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kv_bf16)
        return dispatch<__nv_bfloat16>(q, k_new, v_new, k, v, out, H, KH, D, row_stride, start,
                                       kv_min, n_blocks, scale, st);
    return dispatch<float>(q, k_new, v_new, k, v, out, H, KH, D, row_stride, start, kv_min,
                           n_blocks, scale, st);
}
