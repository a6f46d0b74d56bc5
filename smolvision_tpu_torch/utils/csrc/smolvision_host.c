/*
 * smolvision_host.c -- the host runtime library of smolvision_tpu_torch.
 *
 * The card runs the model; these are the host-side hot paths that the
 * reference implements natively and that stay on the CPU:
 *
 *   sv_resample_sinc    windowed-sinc resampler (Kaiser beta=6, 16
 *                       zero-crossings/side, cutoff at the lower Nyquist,
 *                       per-output coefficient normalization) -- the numpy
 *                       resampler of io/wav.py to ~1e-6.
 *   sv_bpe_encode       greedy lowest-rank byte-level BPE merge over token
 *                       ids (the whole input is one BPE word; merge table
 *                       pre-flattened to sorted (a<<32|b) keys).
 *   sv_silence_mask     adaptive RMS voice-activity mask used by
 *                       --skip-silence (10 ms windows, EMA smoothing,
 *                       25th-percentile noise floor).
 *   sv_expf_vec         libm's scalar expf per element (--sampler cref).
 *
 * Built at first use by utils/native.py (gcc -O3, no -ffast-math) and
 * loaded with ctypes; a failed build raises.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif
#ifndef INT32_MAX
#define INT32_MAX 2147483647
#endif

#define SV_EXPORT __attribute__((visibility("default")))

/* ------------------------------------------------------------------ */
/* Kaiser-windowed sinc resampler                                      */
/* ------------------------------------------------------------------ */

static double bessel_i0(double x) {
    double sum = 1.0, term = 1.0, xx = x * x;
    for (int k = 1; k <= 20; k++) {
        term *= xx / (4.0 * (double)k * (double)k);
        sum += term;
    }
    return sum;
}

SV_EXPORT long sv_resample_len(long n, long in_rate, long out_rate) {
    return (long)((long long)n * out_rate / in_rate);
}

SV_EXPORT void sv_resample_sinc(const float *in, long n, long in_rate,
                                long out_rate, float *out) {
    const int half = 16;          /* zero-crossings per side */
    const double beta = 6.0;
    double ratio = (double)out_rate / (double)in_rate;
    double cutoff = ratio < 1.0 ? ratio : 1.0;
    double inv_i0 = 1.0 / bessel_i0(beta);
    long new_n = sv_resample_len(n, in_rate, out_rate);

    for (long i = 0; i < new_n; i++) {
        double src_pos = (double)i / ratio;
        long center = (long)src_pos;
        double acc = 0.0, wsum = 0.0;
        for (long j = center - half + 1; j <= center + half; j++) {
            double d = (double)j - src_pos;
            double x = d * cutoff;
            double s = (fabs(x) < 1e-9) ? 1.0 : sin(M_PI * x) / (M_PI * x);
            double npos = d / half;
            double w = 0.0;
            if (npos > -1.0 && npos < 1.0)
                w = bessel_i0(beta * sqrt(1.0 - npos * npos)) * inv_i0;
            double coeff = s * w * cutoff;
            if (j >= 0 && j < n) acc += (double)in[j] * coeff;
            wsum += coeff;
        }
        out[i] = (wsum > 1e-9) ? (float)(acc / wsum) : 0.0f;
    }
}

/* ------------------------------------------------------------------ */
/* Byte-level BPE encode (greedy lowest-rank adjacent-pair merges)     */
/* ------------------------------------------------------------------ */

/* merge table: keys sorted ascending, key = (a << 32) | b */
static long find_merge(const int64_t *keys, long n_merges, int64_t key) {
    long lo = 0, hi = n_merges - 1;
    while (lo <= hi) {
        long mid = (lo + hi) / 2;
        if (keys[mid] < key) lo = mid + 1;
        else if (keys[mid] > key) hi = mid - 1;
        else return mid;
    }
    return -1;
}

/*
 * ids:         in/out buffer of current symbol ids (length *n in/out)
 * keys/ranks/results: flattened merge table (sorted by key)
 * Returns 0 on success.
 *
 * Greedy policy identical to the Python tokenizer: repeatedly merge the
 * lowest-rank adjacent pair, leftmost first among equals, until no pair is
 * mergeable.  (Equivalent to merge-all-occurrences because a merge creating
 * a symbol always precedes merges consuming it.)
 */
SV_EXPORT int sv_bpe_encode(int32_t *ids, long *n,
                            const int64_t *keys, const int32_t *ranks,
                            const int32_t *results, long n_merges) {
    long len = *n;
    if (len < 2 || n_merges == 0) return 0;

    /* doubly linked list over the buffer */
    long *next = (long *)malloc(sizeof(long) * (size_t)len);
    long *prev = (long *)malloc(sizeof(long) * (size_t)len);
    if (!next || !prev) { free(next); free(prev); return -1; }
    for (long i = 0; i < len; i++) { next[i] = i + 1; prev[i] = i - 1; }
    next[len - 1] = -1;

    for (;;) {
        /* scan for the lowest-rank adjacent pair */
        long best_i = -1, best_m = -1;
        int32_t best_rank = INT32_MAX;
        for (long i = 0; i != -1 && next[i] != -1; i = next[i]) {
            int64_t key = ((int64_t)ids[i] << 32) | (int64_t)(uint32_t)ids[next[i]];
            long m = find_merge(keys, n_merges, key);
            if (m >= 0 && ranks[m] < best_rank) {
                best_rank = ranks[m];
                best_i = i;
                best_m = m;
            }
        }
        if (best_i < 0) break;
        long j = next[best_i];
        ids[best_i] = results[best_m];
        next[best_i] = next[j];
        if (next[j] != -1) prev[next[j]] = best_i;
    }

    long out = 0;
    for (long i = 0; i != -1; i = next[i]) ids[out++] = ids[i];
    *n = out;
    free(next);
    free(prev);
    return 0;
}

/* ------------------------------------------------------------------ */
/* Adaptive RMS silence mask (--skip-silence)                          */
/* ------------------------------------------------------------------ */

static int cmp_f(const void *a, const void *b) {
    float fa = *(const float *)a, fb = *(const float *)b;
    return (fa > fb) - (fa < fb);
}

/*
 * Computes the per-10ms-window keep mask.  Parameters mirror the Python
 * implementation in runtime/segment.py (and the reference behavior):
 * EMA alpha 0.2, threshold = clamp(p25 * 1.8, 0.002, 0.025), reject voice
 * runs < 5 windows, pad 3 windows, keep first 60 windows of each silence.
 */
SV_EXPORT void sv_silence_mask(const float *samples, long n, uint8_t *keep) {
    const long win = 160;
    long n_win = (n + win - 1) / win;
    if (n_win <= 0) return;
    float *rms = (float *)malloc(sizeof(float) * (size_t)n_win);
    float *sorted = (float *)malloc(sizeof(float) * (size_t)n_win);
    uint8_t *voice = (uint8_t *)calloc((size_t)n_win, 1);
    uint8_t *padded = (uint8_t *)calloc((size_t)n_win, 1);
    if (!rms || !sorted || !voice || !padded) goto done;

    for (long w = 0; w < n_win; w++) {
        long s = w * win, e = s + win;
        if (e > n) e = n;
        /* f32 sequential accumulation — the reference's arithmetic family
         * (qwen_asr.c:461-472); double here could flip near-tie threshold
         * decisions vs the C engine */
        float energy = 0.0f;
        for (long i = s; i < e; i++) energy += samples[i] * samples[i];
        rms[w] = sqrtf(energy / (float)(e - s > 0 ? e - s : 1));
    }
    float sm = rms[0];
    for (long w = 0; w < n_win; w++) {
        sm = 0.8f * sm + 0.2f * rms[w];
        rms[w] = sm;  /* reuse as smoothed */
    }
    memcpy(sorted, rms, sizeof(float) * (size_t)n_win);
    qsort(sorted, (size_t)n_win, sizeof(float), cmp_f);
    float floor_v = sorted[(long)((n_win - 1) * 0.25f)];
    float thresh = floor_v * 1.8f;
    if (thresh < 0.002f) thresh = 0.002f;
    if (thresh > 0.025f) thresh = 0.025f;
    for (long w = 0; w < n_win; w++) voice[w] = rms[w] > thresh;

    for (long i = 0; i < n_win;) {
        if (!voice[i]) { i++; continue; }
        long j = i;
        while (j < n_win && voice[j]) j++;
        if (j - i < 5) memset(voice + i, 0, (size_t)(j - i));
        i = j;
    }
    for (long w = 0; w < n_win; w++) {
        if (!voice[w]) continue;
        long a = w - 3 < 0 ? 0 : w - 3;
        long b = w + 3 >= n_win ? n_win - 1 : w + 3;
        for (long k = a; k <= b; k++) padded[k] = 1;
    }
    long silence = 0;
    for (long w = 0; w < n_win; w++) {
        if (padded[w]) { keep[w] = 1; silence = 0; }
        else { silence++; keep[w] = silence <= 60; }
    }
done:
    free(rms); free(sorted); free(voice); free(padded);
}

/* ------------------------------------------------------------------------
 * sv_expf_vec — elementwise libc expf, in place.
 *
 * Exists for the sampled-mode C-parity sampler (runtime/sampling.CRefSampler):
 * the reference's qwen_softmax (qwen_asr_kernels.c:1012-1029) calls scalar
 * expf per element, and glibc's expf is NOT correctly rounded (~1 ULP off
 * on ~0.05% of inputs vs round-to-f32-of-f64-exp), so bit-exact parity
 * must route through the very same libc symbol.  Built WITHOUT -ffast-math
 * (utils/native.py CFLAGS) so the loop stays scalar expf calls, not libmvec.
 */
SV_EXPORT void sv_expf_vec(float *x, long n) {
    for (long i = 0; i < n; i++) x[i] = expf(x[i]);
}
