"""Token sampling for thinker mode: the host samplers and the device step's math.

Port of smolvision_tpu/runtime/sampling.py.  `Sampler`, `Drand48` and
`CRefSampler` are the JAX package's host samplers as they are (numpy):
repetition penalty over a 64-token window (divide positive / multiply
negative logits), temperature, top-k, softmax, multinomial draw, after
sample_token (qwen_asr.c:2250-2313), seeded deterministically.
`CRefSampler` replays the reference C engine's exact sampled stream
(--sampler cref); its `_libc_expf` is libm's scalar expf per element,
called from the host runtime library (utils/native.py `sv_expf_vec`);
`_libc_expf_ctypes`, one ctypes call per element, is its plain version.

`transform_logits` is the torch twin of `transform_logits_jnp`, the
logits transform of the device-side sampled step, in the same order;
`draw` is that step's draw: Gumbel-max (the family of
`jax.random.categorical`) over uniforms hashed from (seed, cache row,
vocab index) with integer ops alone.  It has no generator state, so an
eager step, a CUDA-graph replay of it and the CPU draw the same numbers by
construction, across chunks and cache growths; the numbers are not
`jax.random`'s, so sampled parity with the JAX package goes through
`CRefSampler`.
"""

from __future__ import annotations

import numpy as np
import torch

from smolvision_tpu_torch.utils import native

REP_WINDOW = 64


class Sampler:
    def __init__(self, temperature: float = 0.7, repetition_penalty: float = 1.1,
                 top_k: int = 40, seed: int = 0):
        self.temperature = float(temperature)
        self.repetition_penalty = float(repetition_penalty)
        self.top_k = int(top_k)
        self.rng = np.random.default_rng(seed)
        self.recent: list = []

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def observe(self, token: int) -> None:
        self.recent.append(token)
        if len(self.recent) > REP_WINDOW:
            self.recent = self.recent[-REP_WINDOW:]

    def transform(self, logits: np.ndarray) -> np.ndarray:
        """Repetition penalty + temperature + top-k (softmax-ready logits).
        Agrees with transform_logits below (tests/test_torch_sampling.py)."""
        logits = np.asarray(logits, dtype=np.float32).copy()
        vocab = logits.shape[0]

        if self.repetition_penalty != 1.0 and self.recent:
            ids = np.asarray([t for t in self.recent if 0 <= t < vocab], dtype=np.int64)
            if ids.size:
                # per occurrence, like the reference's loop (qwen_asr.c:2255-2263):
                # a token seen n times is penalized penalty^n (the sign never
                # flips, so the exponent form is exact), as the device step's counts
                uniq, counts = np.unique(ids, return_counts=True)
                factor = self.repetition_penalty ** counts.astype(np.float32)
                vals = logits[uniq]
                logits[uniq] = np.where(vals > 0.0, vals / factor, vals * factor)

        if self.temperature > 0.0 and self.temperature != 1.0:
            logits /= self.temperature

        if 0 < self.top_k < vocab:
            kth = np.partition(logits, -self.top_k)[-self.top_k]
            logits[logits < kth] = -1e30
        return logits

    def sample(self, logits: np.ndarray) -> int:
        logits = self.transform(logits)
        logits -= logits.max()
        probs = np.exp(logits)
        probs /= probs.sum()
        r = self.rng.random()
        cum = np.cumsum(probs)
        # f32 cum[-1] can round below r (~1e-7 per draw): clamp to the last
        # id, as the reference's fall-through does (qwen_asr.c:2304-2312)
        return min(int(np.searchsorted(cum, r, side="left")), len(probs) - 1)


class Drand48:
    """Exact twin of POSIX drand48(): the 48-bit LCG
    X_{n+1} = (0x5DEECE66D * X_n + 0xB) mod 2^48, seeded like srand48(s)
    (high 32 bits of X <- low 32 bits of s, low 16 bits <- 0x330E) and
    returning the new X / 2^48 as a double, both steps exact in Python
    integer / f64 arithmetic (48 mantissa bits fit in f64's 53).  Used by
    CRefSampler to replay the reference engine's sampling stream
    (qwen_asr.c:2306,2510) when its srand48 seed is pinned."""

    _A = 0x5DEECE66D
    _C = 0xB
    _MASK = (1 << 48) - 1

    def __init__(self, seed: int):
        self.x = ((int(seed) & 0xFFFFFFFF) << 16) | 0x330E

    def random(self) -> float:
        self.x = (self._A * self.x + self._C) & self._MASK
        return self.x / 281474976710656.0  # / 2^48, exact


class CRefSampler:
    """Arithmetic-family twin of the reference sample_token
    (qwen_asr.c:2250-2313) for cross-engine sampled parity: every float op
    replays the C engine's f32 / f64 sequence --

      * repetition penalty applied per occurrence in window order with a
        fresh sign test each time (a scalar f32 multiply chain by 1/p and
        p, as -freciprocal-math compiles v / p),
      * temperature as an elementwise f32 multiply by 1/temp,
      * top-k via the k-th largest value, strict `< kth` mask to -1e30f,
      * qwen_softmax's f32 family (qwen_asr_kernels.c:1012-1029): f32 max,
        libc expf (`_libc_expf`), sequential f32 sum, multiply by 1/sum,
      * the multinomial draw: double cumsum over the f32 probs against one
        drand48 double, first index with cum >= r, fall through to V - 1.

    Same host interface as Sampler."""

    def __init__(self, temperature: float = 0.7, repetition_penalty: float = 1.1,
                 top_k: int = 40, seed: int = 0):
        self.temperature = float(temperature)
        self.repetition_penalty = float(repetition_penalty)
        self.top_k = int(top_k)
        self.rng = Drand48(seed)
        self.recent: list = []

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def observe(self, token: int) -> None:
        self.recent.append(token)
        if len(self.recent) > REP_WINDOW:
            self.recent = self.recent[-REP_WINDOW:]

    def transform(self, logits: np.ndarray) -> np.ndarray:
        logits = np.asarray(logits, dtype=np.float32).copy()
        vocab = logits.shape[0]
        p = np.float32(self.repetition_penalty)
        if self.repetition_penalty != 1.0 and self.recent:
            rp = np.float32(1.0) / p
            for tid in self.recent:  # per occurrence, in window order
                if 0 <= tid < vocab:
                    v = logits[tid]
                    logits[tid] = v * rp if v > np.float32(0.0) else v * p
        if self.temperature > 0.0 and self.temperature != 1.0:
            logits *= np.float32(1.0) / np.float32(self.temperature)
        if 0 < self.top_k < vocab:
            kth = np.partition(logits, vocab - self.top_k)[vocab - self.top_k]
            logits[logits < kth] = np.float32(-1e30)
        return logits

    def sample(self, logits: np.ndarray) -> int:
        logits = self.transform(logits)
        vocab = logits.shape[0]
        m = logits.max()
        e = _libc_expf(logits - m)
        s = np.cumsum(e, dtype=np.float32)[-1]  # sequential f32 accumulation
        probs = e * (np.float32(1.0) / s)
        r = self.rng.random()
        cum = np.cumsum(probs.astype(np.float64))
        return min(int(np.searchsorted(cum, r, side="left")), vocab - 1)


_LIBM = None


def _libc_expf(x: np.ndarray) -> np.ndarray:
    """Elementwise f32 exp through libm's expf, the symbol the reference
    binary calls (qwen_softmax's per-element expf): glibc's expf is ~1 ULP
    off the correctly rounded f64-exp detour on ~0.05% of inputs, the drift
    a knife-edge multinomial draw could turn into another token.  One call
    into the host runtime library, whose loop calls expf per element (built
    without -ffast-math, so never a vector exp)."""
    return native.expf_vec(x)


def _libc_expf_ctypes(x: np.ndarray) -> np.ndarray:
    """`_libc_expf`'s plain version: one ctypes call of libm's expf per
    element (about 152k per token at full vocab)."""
    import ctypes
    import ctypes.util

    global _LIBM
    if _LIBM is None:
        _LIBM = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        _LIBM.expf.restype = ctypes.c_float
        _LIBM.expf.argtypes = [ctypes.c_float]
    out = np.ascontiguousarray(x, dtype=np.float32).copy()
    expf = _LIBM.expf
    for i in range(out.shape[0]):
        out[i] = expf(float(out[i]))
    return out


def transform_logits(logits: torch.Tensor, recent: torch.Tensor, n_recent: torch.Tensor,
                     penalty, temp, top_k: int) -> torch.Tensor:
    """Torch twin of `transform_logits_jnp` (the JAX package's
    runtime/sampling.py): repetition penalty over the recent ring buffer,
    temperature, top-k mask, in its order.  logits [V] f32; recent [REP]
    int ring buffer, the first n_recent entries valid (all once n_recent >=
    REP); penalty, temp f32 scalars (device tensors in the sampled step);
    top_k static.  Reads nothing back to the host, so a CUDA graph holds it.
    Returns the transformed logits (softmax-ready)."""
    V = logits.shape[0]
    REP = recent.shape[0]
    valid = torch.arange(REP, device=logits.device) < n_recent
    # out-of-range sentinel V: counted into an extra slot, then dropped
    ids = torch.where(valid, recent.long(), V)
    counts = torch.zeros(V + 1, dtype=torch.float32, device=logits.device)
    counts.index_add_(0, ids, torch.ones(REP, dtype=torch.float32, device=logits.device))
    factor = torch.pow(torch.as_tensor(penalty, dtype=torch.float32, device=logits.device),
                       counts[:V])
    logits = torch.where(logits > 0, logits / factor, logits * factor)
    logits = logits / torch.clamp(torch.as_tensor(temp, dtype=torch.float32,
                                                  device=logits.device), min=1e-6)
    if 0 < top_k < V:
        kth = torch.topk(logits, top_k).values[-1]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30), logits)
    return logits


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), in int64 arithmetic that
    never overflows: the constant is split in 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def draw_uniforms(seed, row, vocab: int, device) -> torch.Tensor:
    """Uniforms in (0, 1), f32 [vocab], hashed from (seed, cache row, vocab
    index): seed and row are ints or int64 device tensors ([1] or 0-dim).
    Integer ops alone, so the card, a CUDA graph of them and the CPU give
    the same bits."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(()) & _M32
    row = torch.as_tensor(row, dtype=torch.int64, device=device).reshape(()) & _M32
    key = _fmix32(seed ^ _fmix32(_mul32(row, 0x9E3779B9) ^ 0x7F4A7C15))
    idx = torch.arange(vocab, dtype=torch.int64, device=device)
    h = _fmix32((_mul32(idx, 0x9E3779B9) + key) & _M32)
    # the top 23 bits, centred in their interval: k + 0.5 is exact in f32 for
    # k < 2^23, so u is never 0 or 1 (24 bits would round the top one to 1,
    # whose Gumbel noise is +inf)
    return ((h >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def draw(logits: torch.Tensor, seed, row) -> torch.Tensor:
    """The sampled token of transformed logits [V] (softmax-ready, as
    `transform_logits` gives them): argmax(logits + Gumbel noise), the
    noise from `draw_uniforms(seed, row)`; int32 [1].  Exactly a draw from
    softmax(logits); top-k's -1e30 entries are never chosen."""
    u = draw_uniforms(seed, row, logits.shape[0], logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel).reshape(1).to(torch.int32)
