// Single-token decode attention (kernel B3) for Hopper.
//
// Replaces: smolvision_tpu/kernels/flash_attention.py:decode_flash_attention
// (Pallas body _decode_kernel): one position's GQA attention over cache rows
// [kv_min, start) plus the fresh k/v row, which is not yet in the cache and
// is always attended (start == 0 gives self-attention only).  Rows at or
// past `start` are neither read nor computed, so the cost follows the live
// context, not the cache capacity.
//
// Bound on the card: bytes.  Each cache row is read once for ~4 G D flops,
// orders of magnitude below the card's ops:byte balance, so the only lever
// is reading the live rows once, in wide coalesced loads, with enough
// blocks in flight to keep the memory system busy.  The design is split-K
// flash decoding: phase 1 runs a (KH, n_splits) grid; each block takes one
// KV head and a `chunk` of live rows, and its 4 warps stride over those rows
// (a lane reads D/32 contiguous elements of a row; the warp reads the row
// as one coalesced segment) carrying (m, l, acc) for all G query heads of
// the group, so every K/V row is read once per KV head, not once per query
// head.  The warps merge in shared memory and write one partial
// (acc[D], m, l) per (kh, split, g).  Phase 2 (one warp per query head)
// merges the partials and then the fresh row.
//
// Layout: q [H, D] f32; k_new/v_new [KH, D] f32; k/v cache [K, KH, D] (bf16
// or f32) with unit element stride, head stride D, row stride `row_stride`;
// part [KH, n_splits, G, D + 2] f32 scratch; out [H, D] f32.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;

template <int D, typename KV>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, float* __restrict__ part, int G,
                    long long row_stride, int kv_min, int start, int chunk, float scale) {
    constexpr int EPL = D / 32;
    __shared__ float sm_m[kWarps][kMaxG], sm_l[kWarps][kMaxG];
    __shared__ float sm_acc[kWarps][kMaxG][D];

    const int kh = blockIdx.x, split = blockIdx.y, n_splits = gridDim.y;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int lo = kv_min + split * chunk;
    const int hi = min(lo + chunk, start);

    float qr[kMaxG][EPL], acc[kMaxG][EPL], m[kMaxG], l[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
            qr[g][e] = g < G ? q[(kh * G + g) * D + lane * EPL + e] * scale : 0.f;
            acc[g][e] = 0.f;
        }
        m[g] = sv::kNegInf;
        l[g] = 0.f;
    }

    const KV* kb = k + (long long)kh * D + lane * EPL;
    const KV* vb = v + (long long)kh * D + lane * EPL;
    for (int j = lo + warp; j < hi; j += kWarps) {
        float kr[EPL], vr[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
            kr[e] = sv::to_float(kb[(long long)j * row_stride + e]);
            vr[e] = sv::to_float(vb[(long long)j * row_stride + e]);
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
                float s = 0.f;
#pragma unroll
                for (int e = 0; e < EPL; ++e) s = fmaf(qr[g][e], kr[e], s);
                s = sv::warp_sum(s);
                sv::online_update(s, vr, m[g], l[g], acc[g]);
            }
        }
    }

#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
            if (lane == 0) {
                sm_m[warp][g] = m[g];
                sm_l[warp][g] = l[g];
            }
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
        const int g = i / D, d = i % D;
        float mx = sv::kNegInf;
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
        float a = 0.f, ls = 0.f;
        for (int w = 0; w < kWarps; ++w) {
            const float f = expf(sm_m[w][g] - mx);
            a = fmaf(f, sm_acc[w][g][d], a);
            ls = fmaf(f, sm_l[w][g], ls);
        }
        float* p = part + (((long long)kh * n_splits + split) * G + g) * (D + 2);
        p[d] = a;
        if (d == 0) {
            p[D] = mx;
            p[D + 1] = ls;
        }
    }
}

template <int D>
__global__ void __launch_bounds__(32)
decode_merge_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                    const float* __restrict__ v_new, const float* __restrict__ part,
                    float* __restrict__ out, int G, int n_splits, float scale) {
    constexpr int EPL = D / 32;
    const int h = blockIdx.x, kh = h / G, g = h % G, lane = threadIdx.x;

    float mx = sv::kNegInf;
    for (int s = 0; s < n_splits; ++s)
        mx = fmaxf(mx, part[(((long long)kh * n_splits + s) * G + g) * (D + 2) + D]);
    float acc[EPL], l = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
    for (int s = 0; s < n_splits; ++s) {
        const float* p = part + (((long long)kh * n_splits + s) * G + g) * (D + 2);
        const float f = expf(p[D] - mx);
        l = fmaf(f, p[D + 1], l);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] = fmaf(f, p[lane * EPL + e], acc[e]);
    }

    // the fresh row, always attended
    float s = 0.f, vr[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
        s = fmaf(q[h * D + lane * EPL + e] * scale, k_new[kh * D + lane * EPL + e], s);
        vr[e] = v_new[kh * D + lane * EPL + e];
    }
    s = sv::warp_sum(s);
    sv::online_update(s, vr, mx, l, acc);

    const float inv = 1.f / fmaxf(l, sv::kDenomFloor);
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[h * D + lane * EPL + e] = acc[e] * inv;
}

template <int D, typename KV>
int launch(const float* q, const float* k_new, const float* v_new, const void* k,
           const void* v, float* part, float* out, int H, int KH, long long row_stride,
           int start, int kv_min, int n_splits, int chunk, float scale, cudaStream_t stream) {
    const int G = H / KH;
    if (G > kMaxG) return (int)cudaErrorInvalidValue;
    if (n_splits > 0) {
        decode_split_kernel<D, KV><<<dim3(KH, n_splits), kWarps * 32, 0, stream>>>(
            q, static_cast<const KV*>(k), static_cast<const KV*>(v), part, G, row_stride,
            kv_min, start, chunk, scale);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    decode_merge_kernel<D><<<H, 32, 0, stream>>>(q, k_new, v_new, part, out, G, n_splits,
                                                 scale);
    return (int)cudaGetLastError();
}

template <typename KV>
int dispatch(const float* q, const float* k_new, const float* v_new, const void* k,
             const void* v, float* part, float* out, int H, int KH, int D,
             long long row_stride, int start, int kv_min, int n_splits, int chunk, float scale,
             cudaStream_t st) {
    switch (D) {
        case 64:
            return launch<64, KV>(q, k_new, v_new, k, v, part, out, H, KH, row_stride, start,
                                  kv_min, n_splits, chunk, scale, st);
        case 128:
            return launch<128, KV>(q, k_new, v_new, k, v, part, out, H, KH, row_stride, start,
                                   kv_min, n_splits, chunk, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// kv_bf16: 1 for a bf16 cache, 0 for f32.  n_splits may be 0 (no live
// cache row): only the fresh row is attended.
extern "C" int sv_decode_attention(const float* q, const float* k_new, const float* v_new,
                                   const void* k, const void* v, float* part, float* out, int H,
                                   int KH, int D, long long row_stride, int start, int kv_min,
                                   int n_splits, int chunk, int kv_bf16, float scale,
                                   void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kv_bf16)
        return dispatch<__nv_bfloat16>(q, k_new, v_new, k, v, part, out, H, KH, D, row_stride,
                                       start, kv_min, n_splits, chunk, scale, st);
    return dispatch<float>(q, k_new, v_new, k, v, part, out, H, KH, D, row_stride, start,
                           kv_min, n_splits, chunk, scale, st);
}
