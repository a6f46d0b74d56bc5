// The tensor-core attention core of kernels B1 (window_attention.cu), B2
// (causal_cache_attention.cu), B4 (batched_causal_attention.cu) and B5
// (batched_cache_attention.cu).  B1's window-resident route takes only the
// fragment helpers (`split_tile`, `mma_scores`, `mma_pv`) and one exact
// softmax; its query-tiled route and the others walk key segments here.
//
// FlashAttention-2 shaped: a block holds 64 query rows of one KV head's
// group of G query heads, any G from 1 to 64: P = floor(64 / G) queries of
// each head, row r is query t0 + r % P of head r / P, so every K/V row the
// block loads serves all G heads.  Rows r >= G * P (G 3, 7, ... that do not
// divide 64) are dead: they load no q, attend no key and store nothing.  A
// block is NG warp groups of 4 warps, each warp 16 rows.  B2 takes NG 2:
// group 0 walks the key tiles 0, 2, 4, ... of a segment and group 1 the
// tiles 1, 3, ..., each with its own online softmax, merged once at the end
// (one wave of blocks at B2's prefill shape leaves one block per SM, and a
// single group's chain of dependent products per tile left the tensor cores
// mostly idle).  B4 and B5 take NG 1: their grids are several waves of
// short blocks, and two one-group blocks per SM (96 KB each at D 128)
// overlap one block's loads with the other's products, which measured
// faster at the paths' shapes on an H100 than one two-group block; under
// one wave (B5 at start 448, 64 blocks) two groups were faster.  Scores,
// the softmax state (m, l) and the output accumulator stay in registers in
// the mma fragment layout, and the probabilities go from the score
// fragments straight into the A fragments of the P.V product, never through
// shared memory.
//
// Key segments: one online softmax walks up to three segments of keys
// (`mma_attend`, once per segment).  A segment is a K and a V pointer with a
// row stride and an element type, a column range [lo, hi), and whether it
// is causal (query t also needs column c < t + off + 1).  B2 walks its
// cache (bf16 or f32), causal at start_pos; B4 its fresh f32 block, causal;
// B5 up to two ranges of its cache window (bf16 or f32, not causal: every
// cache column lies below every row) and then its fresh f32 block; B1 above
// 128 rows its window's f32 keys [0, len), not causal, at G 1.
//   * bf16 segment: 64-key tiles through a two-stage cp.async ring per group.
//   * f32 segment: 32-key tiles.  The group copies the f32 K and V tile into
//     a staging tile (cp.async) and its 128 threads split it once into bf16
//     hi and lo tiles, which the 4 warps read with ldmatrix; the next tile's
//     copy runs during this tile's products.  Staging plus hi / lo tiles take
//     the same shared memory as the bf16 ring (64-key tiles would need twice
//     that: 256 KB at D 128, over the 227 KB a block may use; a second
//     staging stage measured no faster).
//
// Accuracy: the contract is f32 attention (the TPU kernels compute S and
// P.V in f32).  q (f32, scaled by 1/sqrt(D)) and P are split into hi =
// bf16(x) and lo = bf16(x - hi); so is an f32 K or V.  A bf16 cache is exact
// in bf16, so each product is two bf16 mma.sync with f32 accumulation (q or
// P hi and lo); with f32 K or V it is three, hi.hi + lo.hi + hi.lo, dropping
// lo.lo (about 2^-18 relative).  What is left is each operand's rounding
// after ~16 significant bits, about 2^-17 |x| per term (at the 0.6B shapes
// about 1e-5 on the outputs with a bf16 cache, 3e-5 with f32 K/V), where
// one bf16 product would leave 2^-9.
//
// Masks: tiles are walked from a segment's lo, so no key below it is
// loaded; keys at or past the block's upper bound are zero-filled instead
// of read, and row r's masked scores give p exactly 0, so stale rows (pad
// rows prefill wrote past kv_valid, junk outside a cache window) contribute
// nothing; a row with no key ends with l == 0 and stores 0.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace sv {

constexpr int kMmaRows = 64;     // query rows per block (4 warps x 16, per group)
constexpr int kMmaKeys = 64;     // keys per tile of a bf16 segment
constexpr int kMmaKeysF32 = 32;  // keys per tile of an f32 segment

// one group's K/V region: two stages of 64-key bf16 K and V tiles, or a
// 32-key f32 staging tile of K and V with their bf16 hi and lo tiles
__host__ __device__ constexpr size_t mma_group_bytes(int D) {
    return sizeof(__nv_bfloat16) * (size_t)(2 * 2 * kMmaKeys * D);
}

// dynamic shared memory of a block of NG warp groups: Q hi and lo, then
// each group's K/V region (the merge reuses group 1's)
__host__ __device__ constexpr size_t mma_smem_bytes(int D, int NG) {
    return sizeof(__nv_bfloat16) * (size_t)(2 * kMmaRows * D) + NG * mma_group_bytes(D);
}

// Key column c of a segment at k + c * stride (D contiguous elements,
// 16-byte aligned); columns [lo, hi); causal: query t needs c < t + off + 1.
template <typename KV>
struct KeySegment {
    const KV* k;
    const KV* v;
    long long stride;
    int lo, hi;
    bool causal;
    int off;
};

// The block's last query, and the thread's two rows (warp * 16 + g and + 8
// of its group): their queries (-1 for a dead row or one past T) and online
// softmax state.
template <int D>
struct MmaBlock {
    int t_last;
    int t[2];
    float m[2], l[2];
    float o[D / 8][4];
};

// a barrier of one warp group's 128 threads (named barrier 1 + grp; 0 is
// __syncthreads'), so that each group walks its key tiles at its own pace
__device__ __forceinline__ void group_sync(int grp) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + grp) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Split `rows` f32 rows of D floats (src, unswizzled) times `scale` into
// the bf16 hi and lo tiles h and l (swizzled), thread `tid` of `nthreads`
// taking 4 floats (half a 16-byte chunk of each) per step: a warp reads 512
// contiguous bytes and writes two rows of chunks, free of bank conflicts.
template <int D>
__device__ __forceinline__ void split_tile(const unsigned char* src, unsigned char* h,
                                           unsigned char* l, int rows, int tid, int nthreads,
                                           float scale = 1.f) {
    constexpr int DC = D / 8;
    for (int i = tid; i < rows * D / 4; i += nthreads) {
        const int r = i / (D / 4), c = (i % (D / 4)) / 2, half = i % 2;
        const float4 x = *reinterpret_cast<const float4*>(src + i * 16);
        uint2 hv, lv;
        split_bf16x2(x.x * scale, x.y * scale, hv.x, lv.x);
        split_bf16x2(x.z * scale, x.w * scale, hv.y, lv.y);
        *reinterpret_cast<uint2*>(h + swz(r, c, DC) + 8 * half) = hv;
        *reinterpret_cast<uint2*>(l + swz(r, c, DC) + 8 * half) = lv;
    }
}

// Load the block's 64 rows of q (query t, head i at q + t * q_stride + i *
// D: head 0 of the group at query 0; 16-byte aligned rows), scaled and split
// into bf16 hi and lo (dead rows and rows past T are 0), and clear the
// state.  The f32 rows come through cp.async into the groups' K/V regions,
// free until the first segment, so that all of the block's copies are in
// flight at once (a loop of plain loads waited for each in turn).
template <int D, int NG>
__device__ __forceinline__ void mma_begin(unsigned char* smem, MmaBlock<D>& b,
                                          const float* __restrict__ q, long long q_stride, int T,
                                          int t0, int G, float scale) {
    unsigned char* qh = smem;
    unsigned char* ql = qh + kMmaRows * D * 2;
    unsigned char* stage = ql + kMmaRows * D * 2;  // 64 f32 rows: 256 D bytes
    const int P = kMmaRows / G;
    for (int i = threadIdx.x; i < kMmaRows * D / 4; i += 128 * NG) {
        const int r = i / (D / 4), c = i % (D / 4);
        const int t = t0 + r % P;
        const bool live = r < G * P && t < T;
        cp_async16(stage + i * 16, live ? q + t * q_stride + (r / P) * D + c * 4 : q, live);
    }
    cp_async_commit();
    const int gt = threadIdx.x % 128;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = (gt / 32) * 16 + (gt % 32) / 4 + 8 * i;
        const int t = t0 + r % P;
        b.t[i] = r < G * P && t < T ? t : -1;
        b.m[i] = kNegInf;
        b.l[i] = 0.f;
    }
    b.t_last = min(t0 + P, T) - 1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) b.o[j][e] = 0.f;
    cp_async_wait<0>();
    __syncthreads();  // every thread's rows are in the staging tile
    split_tile<D>(stage, qh, ql, kMmaRows, threadIdx.x, 128 * NG, scale);
    __syncthreads();  // Q hi / lo are in shared memory; the staging tile is free
}

// The segment's columns for this block, [lo, *hi), and each of the
// thread's rows' limit (a row attends c < row_hi; lo for a row with none).
template <int D, typename KV>
__device__ __forceinline__ void mma_range(const MmaBlock<D>& b, const KeySegment<KV>& seg,
                                          int& hi, int (&row_hi)[2]) {
    hi = seg.causal ? min(seg.hi, b.t_last + seg.off + 1) : seg.hi;
#pragma unroll
    for (int i = 0; i < 2; ++i)
        row_hi[i] = b.t[i] < 0 ? seg.lo : seg.causal ? min(b.t[i] + seg.off + 1, hi) : hi;
}

// S += Q K^T of a warp's 16 query rows against NK keys: qh / ql the
// warp's 16 rows of the Q hi and lo tiles, kh the bf16 K tile (swizzled,
// rows = keys); with LO, kl holds the lo half of an f32 K and each product
// takes a third mma (hi against lo).  NK is a constant so that the whole
// product is one straight-line block the compiler interleaves (a branch per
// 16 keys left each warp waiting on every mma's latency).
template <int D, int NK, bool LO>
__device__ __forceinline__ void mma_scores(float (&s)[NK / 8][4], const unsigned char* qh,
                                           const unsigned char* ql, const unsigned char* kh,
                                           const unsigned char* kl) {
    constexpr int DC = D / 8;
    const int lane = threadIdx.x % 32, mi = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        unsigned ah[4], al[4];
        const int qoff = swz(lane & 15, kk * 2 + (lane >> 4), DC);
        ldmatrix_x4(ah, qh + qoff);
        ldmatrix_x4(al, ql + qoff);
#pragma unroll
        for (int jj = 0; jj < NK / 16; ++jj) {
            const int koff = swz(jj * 16 + (mi >> 1) * 8 + (lane & 7), kk * 2 + (mi & 1), DC);
            unsigned bh[4];
            ldmatrix_x4(bh, kh + koff);
            mma_bf16(s[2 * jj], ah, bh[0], bh[1]);
            mma_bf16(s[2 * jj + 1], ah, bh[2], bh[3]);
            mma_bf16(s[2 * jj], al, bh[0], bh[1]);
            mma_bf16(s[2 * jj + 1], al, bh[2], bh[3]);
            if constexpr (LO) {
                unsigned bl[4];
                ldmatrix_x4(bl, kl + koff);
                mma_bf16(s[2 * jj], ah, bl[0], bl[1]);
                mma_bf16(s[2 * jj + 1], ah, bl[2], bl[3]);
            }
        }
    }
}

// O += P V over NK keys: p the probabilities in the score fragments'
// layout, split here into hi and lo straight into the A fragments; vh (and
// with LO vl) the bf16 V tiles as kh / kl above.
template <int D, int NK, bool LO>
__device__ __forceinline__ void mma_pv(float (&o)[D / 8][4], const float (&p)[NK / 8][4],
                                       const unsigned char* vh, const unsigned char* vl) {
    constexpr int DC = D / 8;
    const int lane = threadIdx.x % 32, mi = lane >> 3;
#pragma unroll
    for (int ks16 = 0; ks16 < NK / 16; ++ks16) {
        unsigned ph[4], pl[4];
        split_bf16x2(p[2 * ks16][0], p[2 * ks16][1], ph[0], pl[0]);
        split_bf16x2(p[2 * ks16][2], p[2 * ks16][3], ph[1], pl[1]);
        split_bf16x2(p[2 * ks16 + 1][0], p[2 * ks16 + 1][1], ph[2], pl[2]);
        split_bf16x2(p[2 * ks16 + 1][2], p[2 * ks16 + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dj = 0; dj < D / 16; ++dj) {
            const int voff = swz(ks16 * 16 + (mi & 1) * 8 + (lane & 7), dj * 2 + (mi >> 1), DC);
            unsigned bh[4];
            ldmatrix_x4_trans(bh, vh + voff);
            mma_bf16(o[2 * dj], ph, bh[0], bh[1]);
            mma_bf16(o[2 * dj + 1], ph, bh[2], bh[3]);
            mma_bf16(o[2 * dj], pl, bh[0], bh[1]);
            mma_bf16(o[2 * dj + 1], pl, bh[2], bh[3]);
            if constexpr (LO) {
                unsigned bl[4];
                ldmatrix_x4_trans(bl, vl + voff);
                mma_bf16(o[2 * dj], ph, bl[0], bl[1]);
                mma_bf16(o[2 * dj + 1], ph, bl[2], bl[3]);
            }
        }
    }
}

// One tile of NK keys from column k0 against the warp's 16 rows: S = Q K^T,
// one online-softmax step per row, O += P V.  kh / vh: the bf16 K and V
// tiles (swizzled, NK rows); with LO, kl / vl hold the lo halves of f32 K
// and V, and each product takes a third mma (hi against lo).
template <int D, int NK, bool LO>
__device__ __forceinline__ void mma_tile(MmaBlock<D>& b, const unsigned char* qh,
                                         const unsigned char* ql, const unsigned char* kh,
                                         const unsigned char* kl, const unsigned char* vh,
                                         const unsigned char* vl, int k0,
                                         const int (&row_hi)[2]) {
    const int warp = (threadIdx.x % 128) / 32, t4 = threadIdx.x % 4;
    const int qrows = warp * 16 * D * 2;  // the warp's 16 rows of the Q tiles

    // S = Q K^T over the tile: 16 rows x NK keys per warp
    float s[NK / 8][4];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_scores<D, NK, LO>(s, qh + qrows, ql + qrows, kh, kl);

    // one online-softmax step per row; masked p exactly 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                if (k0 + 8 * j + 2 * t4 + e < row_hi[i]) mx = fmaxf(mx, s[j][2 * i + e]);
        const float m_new = fmaxf(b.m[i], quad_max(mx));
        const float alpha = expf(b.m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float p = k0 + 8 * j + 2 * t4 + e < row_hi[i]
                                    ? expf(s[j][2 * i + e] - m_new) : 0.f;
                s[j][2 * i + e] = p;
                sum += p;
            }
        b.l[i] = b.l[i] * alpha + quad_sum(sum);
        b.m[i] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            b.o[j][2 * i] *= alpha;
            b.o[j][2 * i + 1] *= alpha;
        }
    }

    // O += P V, P split into hi and lo straight from the score fragments
    mma_pv<D, NK, LO>(b.o, s, vh, vl);
}

// The block's queries against a bf16 segment (exact in bf16: two products).
template <int D, int NG>
__device__ __forceinline__ void mma_attend(unsigned char* smem, MmaBlock<D>& b,
                                           const KeySegment<__nv_bfloat16>& seg) {
    constexpr int DC = D / 8;
    constexpr int TILE = kMmaKeys * D * 2;  // bytes of one K or V tile
    const unsigned char* qh = smem;
    const unsigned char* ql = qh + kMmaRows * D * 2;
    const int grp = threadIdx.x / 128, gt = threadIdx.x % 128;
    // this group's stage s: K at kv0 + 2 s TILE, V after it
    unsigned char* kv0 = smem + 2 * kMmaRows * D * 2 + grp * mma_group_bytes(D);
    int hi, row_hi[2];
    mma_range(b, seg, hi, row_hi);
    const int lo = seg.lo;
    const int n_tiles = hi > lo ? (hi - lo + kMmaKeys - 1) / kMmaKeys : 0;

    auto load_kv = [&](int stage, int k0) {
        unsigned char* ks = kv0 + 2 * stage * TILE;
        unsigned char* vs = ks + TILE;
        for (int i = gt; i < kMmaKeys * DC; i += 128) {
            const int r = i / DC, c = i % DC;
            const int col = k0 + r;
            const long long off = (long long)min(col, hi - 1) * seg.stride + c * 8;
            cp_async16(ks + swz(r, c, DC), seg.k + off, col < hi);
            cp_async16(vs + swz(r, c, DC), seg.v + off, col < hi);
        }
    };
    if (grp < n_tiles) load_kv(0, lo + grp * kMmaKeys);
    cp_async_commit();

    // group grp takes the tiles grp, grp + 2, ... through its own ring
    for (int tile = grp, it = 0; tile < n_tiles; tile += NG, ++it) {
        const int k0 = lo + tile * kMmaKeys;
        if (tile + NG < n_tiles) {
            load_kv((it + 1) & 1, k0 + NG * kMmaKeys);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        group_sync(grp);  // this tile's K and V are in shared memory
        const unsigned char* ks = kv0 + 2 * (it & 1) * TILE;
        mma_tile<D, kMmaKeys, false>(b, qh, ql, ks, nullptr, ks + TILE, nullptr, k0, row_hi);
        group_sync(grp);  // the next tile's loads overwrite this stage
    }
}

// The block's queries against an f32 segment (three products).
template <int D, int NG>
__device__ __forceinline__ void mma_attend(unsigned char* smem, MmaBlock<D>& b,
                                           const KeySegment<float>& seg) {
    constexpr int NK = kMmaKeysF32;
    constexpr int STAGE = NK * D * 4;  // bytes of one f32 staging tile
    constexpr int HALF = NK * D * 2;   // bytes of one bf16 hi or lo tile
    const unsigned char* qh = smem;
    const unsigned char* ql = qh + kMmaRows * D * 2;
    const int grp = threadIdx.x / 128, gt = threadIdx.x % 128;
    unsigned char* sk = smem + 2 * kMmaRows * D * 2 + grp * mma_group_bytes(D);
    unsigned char* sv = sk + STAGE;
    unsigned char* kh = sv + STAGE;
    unsigned char* kl = kh + HALF;
    unsigned char* vh = kl + HALF;
    unsigned char* vl = vh + HALF;
    int hi, row_hi[2];
    mma_range(b, seg, hi, row_hi);
    const int lo = seg.lo;
    const int n_tiles = hi > lo ? (hi - lo + NK - 1) / NK : 0;

    // the f32 tile of NK keys from k0 into the staging tiles (rows of D
    // floats, unswizzled), rows past hi zero-filled
    auto load = [&](int k0) {
        for (int i = gt; i < NK * D / 4; i += 128) {
            const int r = i / (D / 4), c = i % (D / 4);
            const int col = k0 + r;
            const long long off = (long long)min(col, hi - 1) * seg.stride + c * 4;
            cp_async16(sk + (r * D + c * 4) * 4, seg.k + off, col < hi);
            cp_async16(sv + (r * D + c * 4) * 4, seg.v + off, col < hi);
        }
        cp_async_commit();
    };
    if (grp < n_tiles) load(lo + grp * NK);

    // group grp takes the tiles grp, grp + 2, ...
    for (int tile = grp; tile < n_tiles; tile += NG) {
        const int k0 = lo + tile * NK;
        cp_async_wait<0>();
        group_sync(grp);  // this tile's f32 K and V are in the staging tiles;
                          // the last tile's hi / lo tiles are read
        split_tile<D>(sk, kh, kl, NK, gt, 128);
        split_tile<D>(sv, vh, vl, NK, gt, 128);
        group_sync(grp);  // hi / lo written; the staging tiles are free
        if (tile + NG < n_tiles) load(k0 + NG * NK);
        mma_tile<D, NK, true>(b, qh, ql, kh, kl, vh, vl, k0, row_hi);
    }
    group_sync(grp);  // the group's next segment reuses the region
}

// Merge the groups (with NG 2) and store the live rows, normalised: query
// t of head i at out + t * out_stride + i * D (like q in mma_begin).
template <int D, int NG>
__device__ __forceinline__ void mma_end(unsigned char* smem, MmaBlock<D>& b,
                                        float* __restrict__ out, long long out_stride, int G) {
    static_assert(NG == 1 || NG == 2, "one warp group, or two merged here");
    const int grp = threadIdx.x / 128, gt = threadIdx.x % 128;
    const int warp = gt / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
    // group 1 leaves (m, l, o) in its region, group 0 folds them in
    // (element-major, so that a warp's 32 lanes touch 32 banks)
    float* mb = reinterpret_cast<float*>(smem + 2 * kMmaRows * D * 2 + mma_group_bytes(D));
    float* ob = mb + 4 * 128;
    if constexpr (NG == 2) {
        if (grp == 1) {  // (every walk ends with its group's barrier)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mb[i * 128 + gt] = b.m[i];
                mb[(2 + i) * 128 + gt] = b.l[i];
            }
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) ob[(j * 4 + e) * 128 + gt] = b.o[j][e];
        }
        __syncthreads();
        if (grp == 1) return;
    }
    const int P = kMmaRows / G;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float a0 = 1.f, a1 = 0.f, l = b.l[i];
        if constexpr (NG == 2) {
            const float m1 = mb[i * 128 + gt], l1 = mb[(2 + i) * 128 + gt];
            const float mx = fmaxf(b.m[i], m1);
            a0 = expf(b.m[i] - mx);
            a1 = expf(m1 - mx);
            l = b.l[i] * a0 + l1 * a1;
        }
        if (b.t[i] < 0) continue;
        const float inv = 1.f / fmaxf(l, kDenomFloor);
        const int r = warp * 16 + g + 8 * i;
        float* op = out + b.t[i] * out_stride + (r / P) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            float x0 = b.o[j][2 * i] * a0, x1 = b.o[j][2 * i + 1] * a0;
            if constexpr (NG == 2) {
                x0 += ob[(j * 4 + 2 * i) * 128 + gt] * a1;
                x1 += ob[(j * 4 + 2 * i + 1) * 128 + gt] * a1;
            }
            *reinterpret_cast<float2*>(op + 8 * j) = make_float2(x0 * inv, x1 * inv);
        }
    }
}

}  // namespace sv
