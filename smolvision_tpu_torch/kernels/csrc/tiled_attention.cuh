// The f32 register-tiled attention core of kernels B1 (window_attention.cu)
// and B2 on an f32 cache (causal_cache_attention.cu; a bf16 cache, B4 and B5
// run on the tensor-core core of mma_attention.cuh).
//
// One block of 256 threads (16 x 16) holds a tile of 64 query rows [t0, t0
// + 64) of one head.  The keys of the range [lo, hi) are walked in BK = 64-row
// tiles (`attend_tiles`); the [rows, keys] scores never leave the SM, and
// each row carries its online softmax (m, l, acc) in registers.
//
// On the card this work is bounded by bytes at the path's shapes, but in f32
// on the CUDA cores the products take the time, so the core is shaped like a
// register-tiled matrix product.  Q (scaled), the K/V tile (widened to f32)
// and the tile's probabilities sit in shared memory, rows padded by 4 floats
// so that the 16-byte loads below are free of bank conflicts.  Each thread
// computes a 4 x 4 block of scores (rows ty + 16i, keys tx + 16j: 64 FMAs per
// 8 shared loads), takes one online-softmax step per row and tile (max and
// sum over the 16 threads of a row by shuffles), and accumulates a 4 x D/16
// block of the output (columns 64f + 4tx + 0..3).  Tiles wholly outside the
// key range are never read; tile rows past it are zero-filled instead of
// loaded, and masked probabilities are exactly 0, so stale rows (pad rows a
// caller wrote past kv_valid) contribute nothing.  A row that attends no key
// ends with l == 0 and stores 0.
#pragma once

#include "common.cuh"

namespace sv {

constexpr int kTileRows = 64;   // BQ: query rows per block
constexpr int kTileKeys = 64;   // BK: keys per tile
constexpr int kTileThreads = 256;
constexpr int kTilePad = 4;

// dynamic shared memory of one block, in bytes
constexpr size_t tiled_smem_bytes(int D) {
    return sizeof(float) *
           (size_t)((kTileRows + 2 * kTileKeys) * (D + kTilePad) + kTileRows * (kTileKeys + kTilePad));
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The queries of a tile: row r is query t0 + r of T.
struct TileRows {
    int T, t0;
    __device__ __forceinline__ int t(int r) const { return t0 + r; }
    __device__ __forceinline__ bool valid(int r) const { return t(r) < T; }
    // the thread's i-th row (of 4)
    __device__ __forceinline__ int mine(int i) const { return threadIdx.x / 16 + 16 * i; }
};

// The online-softmax state of a thread's 4 rows.
template <int D>
struct RowState {
    float m[4], l[4], o[4][D / 16];
};

// Load the block's 64 query rows, scaled, into shared memory and clear the
// row state.  Query t is at q + t * q_stride.
template <int D>
__device__ __forceinline__ void begin_rows(float* smem, RowState<D>& st, const TileRows& rows,
                                           const float* __restrict__ q, long long q_stride,
                                           float scale) {
    constexpr int LD = D + kTilePad;
    for (int i = threadIdx.x; i < kTileRows * D; i += kTileThreads) {
        const int r = i / D, c = i % D;
        smem[r * LD + c] = rows.valid(r) ? q[(long long)rows.t(r) * q_stride + c] * scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        st.m[i] = kNegInf;
        st.l[i] = 0.f;
#pragma unroll
        for (int e = 0; e < D / 16; ++e) st.o[i][e] = 0.f;
    }
}

// Attend the keys [lo, hi): key c at k + c * kv_stride (D contiguous
// elements).  The thread's row i attends key c iff c < row_hi[i].
template <int D, typename KV>
__device__ __forceinline__ void attend_tiles(float* smem, RowState<D>& st,
                                             const KV* __restrict__ k, const KV* __restrict__ v,
                                             long long kv_stride, int lo, int hi,
                                             const int (&row_hi)[4]) {
    static_assert(D % 64 == 0, "the thread layout covers 64 output columns per group");
    constexpr int LD = D + kTilePad;           // row length of the Q / K / V tiles
    constexpr int LDP = kTileKeys + kTilePad;  // row length of the probability tile
    constexpr int DG = D / 64;                 // float4 groups of output columns per thread
    const float* qs = smem;                    // [kTileRows][LD]
    float* ks = smem + kTileRows * LD;         // [kTileKeys][LD]
    float* vs = ks + kTileKeys * LD;           // [kTileKeys][LD]
    float* ps = vs + kTileKeys * LD;           // [kTileRows][LDP]
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    int lim[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lim[i] = min(row_hi[i], hi);

    for (int k0 = lo; k0 < hi; k0 += kTileKeys) {
        __syncthreads();  // the previous tile (and the Q tile on entry) is done
        for (int i = tid; i < kTileKeys * D; i += kTileThreads) {
            const int r = i / D, c = i % D;
            const int col = k0 + r;
            const long long off = (long long)col * kv_stride + c;
            ks[r * LD + c] = col < hi ? to_float(k[off]) : 0.f;
            vs[r * LD + c] = col < hi ? to_float(v[off]) : 0.f;
        }
        __syncthreads();

        // scores of rows ty + 16 i against keys tx + 16 j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            float4 a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = ld4(qs + (ty + 16 * i) * LD + d);
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = ld4(ks + (tx + 16 * j) * LD + d);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
                    s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
                    s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
                    s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
                }
        }

        // one online-softmax step per row for this tile
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (k0 + tx + 16 * j < lim[i]) mx = fmaxf(mx, s[i][j]);
            const float m_new = fmaxf(st.m[i], half_warp_max(mx));
            const float alpha = expf(st.m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = k0 + tx + 16 * j < lim[i] ? expf(s[i][j] - m_new) : 0.f;
                ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
                sum += p;
            }
            st.l[i] = st.l[i] * alpha + half_warp_sum(sum);
            st.m[i] = m_new;
#pragma unroll
            for (int e = 0; e < 4 * DG; ++e) st.o[i][e] *= alpha;
        }
        __syncthreads();

        // o[i] += P[row i] V over the tile
#pragma unroll 2
        for (int c = 0; c < kTileKeys; c += 4) {
            float4 p4[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p4[i] = ld4(ps + (ty + 16 * i) * LDP + c);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
                for (int f = 0; f < DG; ++f) {
                    const float4 vv = ld4(vs + (c + cc) * LD + 64 * f + 4 * tx);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float p = lane_of(p4[i], cc);
                        st.o[i][4 * f + 0] = fmaf(p, vv.x, st.o[i][4 * f + 0]);
                        st.o[i][4 * f + 1] = fmaf(p, vv.y, st.o[i][4 * f + 1]);
                        st.o[i][4 * f + 2] = fmaf(p, vv.z, st.o[i][4 * f + 2]);
                        st.o[i][4 * f + 3] = fmaf(p, vv.w, st.o[i][4 * f + 3]);
                    }
                }
            }
        }
    }
}

// Store the thread's valid rows, normalised: out like q in begin_rows.
template <int D>
__device__ __forceinline__ void end_rows(const RowState<D>& st, const TileRows& rows,
                                         float* __restrict__ out, long long out_stride) {
    constexpr int DG = D / 64;
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = rows.mine(i);
        if (rows.valid(r)) {
            const float inv = 1.f / fmaxf(st.l[i], kDenomFloor);
            float* op = out + (long long)rows.t(r) * out_stride + 4 * tx;
#pragma unroll
            for (int f = 0; f < DG; ++f)
                *reinterpret_cast<float4*>(op + 64 * f) =
                    make_float4(st.o[i][4 * f] * inv, st.o[i][4 * f + 1] * inv,
                                st.o[i][4 * f + 2] * inv, st.o[i][4 * f + 3] * inv);
        }
    }
}

// One head's 64 query rows [t0, t0 + 64) of T against the key columns
// [kv_min, hi): row t attends the columns c with kv_min <= c <
// min(row_start + t + 1, kv_valid) -- causal for B2 (row_start = its
// start_pos); a bidirectional caller passes row_start = kv_valid.  q: row 0
// of this head's queries (row t at q + t * q_stride); k / v: column 0 of
// this head's keys (key c at k + c * kv_stride); out: like q, with
// out_stride.  smem holds tiled_smem_bytes(D), 16-byte aligned.
template <int D, typename KV>
__device__ __forceinline__ void tiled_attention(
    float* smem, const float* __restrict__ q, long long q_stride, const KV* __restrict__ k,
    const KV* __restrict__ v, long long kv_stride, float* __restrict__ out,
    long long out_stride, int T, int t0, int row_start, int kv_valid, int kv_min,
    float scale) {
    const TileRows rows{T, t0};
    RowState<D> st;
    begin_rows<D>(smem, st, rows, q, q_stride, scale);
    int row_hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int t = rows.t(rows.mine(i));
        row_hi[i] = t < T ? min(row_start + t + 1, kv_valid) : kv_min;
    }
    const int t_last = min(t0 + kTileRows, T) - 1;
    attend_tiles<D, KV>(smem, st, k, v, kv_stride, kv_min,
                        min(row_start + t_last + 1, kv_valid), row_hi);
    end_rows<D>(st, rows, out, out_stride);
}

}  // namespace sv
