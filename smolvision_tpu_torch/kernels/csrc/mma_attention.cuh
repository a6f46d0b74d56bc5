// The tensor-core attention core for a bf16 KV cache (kernel B2's bf16
// route, causal_cache_attention.cu; written so that B1, B4 and B5 can move
// onto it).  The f32 core of tiled_attention.cuh keeps the f32 caches.
//
// FlashAttention-2 shaped: a block holds 64 query rows; row r is query t0 +
// r % (64 / G) of head r / (64 / G) of one KV head's group of G query heads,
// so every K/V row the block loads serves all G heads.  The block's 8 warps
// are two groups of 4, each warp 16 rows: group 0 takes the key tiles 0, 2,
// 4, ... and group 1 the tiles 1, 3, ... (one wave of blocks at the prefill
// shape leaves one block per SM, and a single group's chain of dependent
// products per tile left the tensor cores mostly idle); each group has its
// own two-stage cp.async ring of 64-key K/V tiles and its own online
// softmax, merged once at the end.  Scores, the softmax state (m, l) and the
// output accumulator stay in registers in the mma fragment layout, and the
// probabilities go from the score fragments straight into the A fragments
// of the P.V product, never through shared memory.
//
// Accuracy: the contract is f32 attention (the TPU kernel computes S and
// P.V in f32).  The cache's K and V are exact in bf16; q (f32, scaled by
// 1/sqrt(D)) and P are not.  Each is split into hi = bf16(x) and lo =
// bf16(x - hi), and every product is two bf16 mma.sync with f32
// accumulation, hi and lo: what is left is x's rounding after ~16
// significant bits, about 2^-17 |x| per term (about 1e-5 on the scores at
// the 0.6B shape), where one bf16 product would leave 2^-9.
//
// Masks: tiles are walked from kv_min, so no key below it is loaded; keys
// at or past the block's upper bound are zero-filled instead of read, and
// row r's masked scores give p exactly 0, so stale rows (pad rows prefill
// wrote past kv_valid) contribute nothing; a row with no key ends with l ==
// 0 and stores 0.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace sv {

constexpr int kMmaRows = 64;     // query rows per block (4 warps x 16, per group)
constexpr int kMmaKeys = 64;     // keys per tile
constexpr int kMmaGroups = 2;    // warp groups splitting the key tiles
constexpr int kMmaThreads = 128 * kMmaGroups;

// dynamic shared memory of one block: Q hi and lo, and per group two stages
// of K and V (the merge reuses group 1's stages)
constexpr size_t mma_smem_bytes(int D) {
    return sizeof(__nv_bfloat16) *
           (size_t)(2 * kMmaRows * D + kMmaGroups * 2 * 2 * kMmaKeys * D);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 64 rows of G query heads against one KV head, causal from a cache.
// Row r of the block is head r / P (P = 64 / G) at query t0 + r % P of T;
// it attends key column c iff kv_min <= c < min(row_start + t + 1,
// kv_valid).  q: head 0 of the group at query 0 (query t, head i at q + t *
// q_stride + i * D); k / v: key 0 of the KV head (key c at k + c *
// kv_stride, D contiguous bf16, 16-byte aligned); out like q.
template <int D>
__device__ __forceinline__ void mma_causal_attention(
    unsigned char* smem, const float* __restrict__ q, long long q_stride,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    long long kv_stride, float* __restrict__ out, int T, int t0, int G, int row_start,
    int kv_valid, int kv_min, float scale) {
    static_assert(D % 64 == 0, "the swizzle wants rows of at least 8 16-byte chunks");
    constexpr int DC = D / 8;                    // 16-byte chunks per row
    constexpr int TILE = kMmaKeys * D * 2;       // bytes of one K or V tile
    unsigned char* qh = smem;
    unsigned char* ql = qh + kMmaRows * D * 2;
    const int tid = threadIdx.x, grp = tid / 128, gt = tid % 128;
    const int warp = gt / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    // this group's stage s: K at kv0 + 2 s TILE, V after it
    unsigned char* kv0 = ql + kMmaRows * D * 2 + grp * 4 * TILE;
    const int P = kMmaRows / G;

    // the block's key range [lo, hi); group grp takes tiles grp, grp + 2, ...
    const int t_last = min(t0 + P, T) - 1;
    const int lo = kv_min, hi = min(row_start + t_last + 1, kv_valid);
    const int n_tiles = hi > lo ? (hi - lo + kMmaKeys - 1) / kMmaKeys : 0;
    const int steps = (n_tiles + kMmaGroups - 1) / kMmaGroups;

    auto load_kv = [&](int stage, int k0) {
        unsigned char* ks = kv0 + 2 * stage * TILE;
        unsigned char* vs = ks + TILE;
        for (int i = gt; i < kMmaKeys * DC; i += 128) {
            const int r = i / DC, c = i % DC;
            const int col = k0 + r;
            const long long off = (long long)min(col, hi - 1) * kv_stride + c * 8;
            cp_async16(ks + swz(r, c, DC), k + off, col < hi);
            cp_async16(vs + swz(r, c, DC), v + off, col < hi);
        }
    };
    if (grp < n_tiles) load_kv(0, lo + grp * kMmaKeys);
    cp_async_commit();

    // Q, scaled, split into bf16 hi and lo (rows past T are 0)
    for (int i = tid; i < kMmaRows * D / 2; i += kMmaThreads) {
        const int r = i / (D / 2), d = 2 * (i % (D / 2));
        const int t = t0 + r % P;
        float2 x = make_float2(0.f, 0.f);
        if (t < T) x = *reinterpret_cast<const float2*>(q + t * q_stride + (r / P) * D + d);
        unsigned h, l;
        split_bf16x2(x.x * scale, x.y * scale, h, l);
        const int off = swz(r, d / 8, DC) + (d % 8) * 2;
        *reinterpret_cast<unsigned*>(qh + off) = h;
        *reinterpret_cast<unsigned*>(ql + off) = l;
    }

    // this thread's two rows: warp * 16 + g and + 8
    int row_hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int t = t0 + (warp * 16 + g + 8 * i) % P;
        row_hi[i] = t < T ? min(min(row_start + t + 1, kv_valid), hi) : lo;
    }
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

    // both groups step together (block-wide barriers); a group whose tile
    // is past the range only waits
    for (int it = 0; it < steps; ++it) {
        const int tile = it * kMmaGroups + grp;
        const int k0 = lo + tile * kMmaKeys;
        if (tile + kMmaGroups < n_tiles) {
            load_kv((it + 1) & 1, k0 + kMmaGroups * kMmaKeys);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // this step's tiles (and on entry Q) are in shared memory
        if (tile < n_tiles) {
            const unsigned char* ks = kv0 + 2 * (it & 1) * TILE;
            const unsigned char* vs = ks + TILE;

            // S = Q K^T over the tile: 16 rows x 64 keys per warp
            float s[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                unsigned ah[4], al[4];
                const int qoff = swz(warp * 16 + (lane & 15), kk * 2 + (lane >> 4), DC);
                ldmatrix_x4(ah, qh + qoff);
                ldmatrix_x4(al, ql + qoff);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    const int mi = lane >> 3;
                    unsigned b[4];
                    ldmatrix_x4(b, ks + swz(jj * 16 + (mi >> 1) * 8 + (lane & 7),
                                            kk * 2 + (mi & 1), DC));
                    mma_bf16(s[2 * jj], ah, b[0], b[1]);
                    mma_bf16(s[2 * jj + 1], ah, b[2], b[3]);
                    mma_bf16(s[2 * jj], al, b[0], b[1]);
                    mma_bf16(s[2 * jj + 1], al, b[2], b[3]);
                }
            }

            // one online-softmax step per row; masked p exactly 0
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                float mx = kNegInf;
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        if (k0 + 8 * j + 2 * t4 + e < row_hi[i]) mx = fmaxf(mx, s[j][2 * i + e]);
                const float m_new = fmaxf(m[i], quad_max(mx));
                const float alpha = expf(m[i] - m_new);
                float sum = 0.f;
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float p = k0 + 8 * j + 2 * t4 + e < row_hi[i]
                                            ? expf(s[j][2 * i + e] - m_new) : 0.f;
                        s[j][2 * i + e] = p;
                        sum += p;
                    }
                l[i] = l[i] * alpha + quad_sum(sum);
                m[i] = m_new;
#pragma unroll
                for (int j = 0; j < D / 8; ++j) {
                    o[j][2 * i] *= alpha;
                    o[j][2 * i + 1] *= alpha;
                }
            }

            // O += P V, P split into hi and lo straight from the score fragments
#pragma unroll
            for (int ks16 = 0; ks16 < kMmaKeys / 16; ++ks16) {
                unsigned ph[4], pl[4];
                split_bf16x2(s[2 * ks16][0], s[2 * ks16][1], ph[0], pl[0]);
                split_bf16x2(s[2 * ks16][2], s[2 * ks16][3], ph[1], pl[1]);
                split_bf16x2(s[2 * ks16 + 1][0], s[2 * ks16 + 1][1], ph[2], pl[2]);
                split_bf16x2(s[2 * ks16 + 1][2], s[2 * ks16 + 1][3], ph[3], pl[3]);
#pragma unroll
                for (int dj = 0; dj < D / 16; ++dj) {
                    const int mi = lane >> 3;
                    unsigned b[4];
                    ldmatrix_x4_trans(b, vs + swz(ks16 * 16 + (mi & 1) * 8 + (lane & 7),
                                                  dj * 2 + (mi >> 1), DC));
                    mma_bf16(o[2 * dj], ph, b[0], b[1]);
                    mma_bf16(o[2 * dj + 1], ph, b[2], b[3]);
                    mma_bf16(o[2 * dj], pl, b[0], b[1]);
                    mma_bf16(o[2 * dj + 1], pl, b[2], b[3]);
                }
            }
        }
        __syncthreads();  // the next step's loads overwrite these stages
    }

    // merge: group 1 leaves (m, l, o) in its stages, group 0 folds them in
    // (element-major, so that a warp's 32 lanes touch 32 banks)
    float* mb = reinterpret_cast<float*>(ql + kMmaRows * D * 2 + 4 * TILE);
    float* ob = mb + 4 * 128;
    if (grp == 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mb[i * 128 + gt] = m[i];
            mb[(2 + i) * 128 + gt] = l[i];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) ob[(j * 4 + e) * 128 + gt] = o[j][e];
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const float m1 = mb[i * 128 + gt], l1 = mb[(2 + i) * 128 + gt];
        const float mx = fmaxf(m[i], m1);
        const float a0 = expf(m[i] - mx), a1 = expf(m1 - mx);
        l[i] = l[i] * a0 + l1 * a1;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                o[j][2 * i + e] = o[j][2 * i + e] * a0 + ob[(j * 4 + 2 * i + e) * 128 + gt] * a1;
    }

    // store the valid rows, normalised
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
        const int t = t0 + r % P;
        if (t >= T) continue;
        const float inv = 1.f / fmaxf(l[i], kDenomFloor);
        float* op = out + t * q_stride + (r / P) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<float2*>(op + 8 * j) =
                make_float2(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    }
}

}  // namespace sv
