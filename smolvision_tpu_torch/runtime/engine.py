"""Engine: model loading, encode / prefill / decode primitives, one-segment ASR.

Port of the dense offline path of smolvision_tpu/runtime/engine.py (the
qwen_ctx_t + transcribe entry points of qwen_asr.c) and of the settings the
segmented, batched, serving and streaming modules read (runtime/segment.py,
runtime/batch_segments.py, runtime/serving.py, runtime/stream.py), with the
JAX engine's options --q8 (int8 decoder weights), --kv8 (int8 batched KV
cache), --spec (speculative decoding with an int8 draft) and
--enc-window-sec (the encoder's attention window), streaming's prefill
with KV reuse (`prefill_with_reuse`: kernel B2 at a start > 0), the
thinker (`thinker_generate`: free-form generation, greedy or sampled) and
the Qwen2.5-Omni family (its Conv1D audio tower, models/q25_encoder.py;
its decoder's QKV bias and untied lm_head) and MoE decoders (Qwen3-Omni-
30B-A3B: models/moe.py), resident (int8 experts under --q8 and in the
--spec draft) or with the experts left on the host (--moe-offload:
models/moe_offload.py, a per-token host loop with no CUDA graph).
The engine owns:
  * the parameter dictionaries on its device (bf16 weights by default),
  * the KV cache (grow-by-copy to pow2 buckets, as in the JAX engine),
  * host-side text logic (prompt tokens, <asr_text> gating, callbacks),
  * perf counters matching the reference's stderr contract.

PyTorch runs eagerly, so there are no jitted programs.  The reference's
compiled programs take the form the card offers (runtime/decode_graph.py):
greedy decode is one decode step captured as a CUDA graph and replayed per
token, the token, position and EOS flag on the device, one host read per
chunk of DECODE_CHUNK steps; --spec is one speculative iteration (draft
steps, verify, accept) captured and replayed the same way, and so is the
thinker's sampled step (logits, penalty, temperature, top-k and draw on
the device); a greedy prefill is captured per (cache, block bucket) on its
second call and replayed.  Phases are synchronised at their ends on the
card so the per-phase times are the device's, not the enqueue's.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from smolvision_tpu_torch.config import (
    EOS_TOKEN_IDS,
    SUPPORTED_LANGUAGES,
    TOKEN_ASR_TEXT,
    detect_config,
)
from smolvision_tpu_torch.device import resolve_device
from smolvision_tpu_torch.io.safetensors import MultiSafetensors
from smolvision_tpu_torch.models import moe_offload as off_mod
from smolvision_tpu_torch.models import params as params_mod
from smolvision_tpu_torch.models import q25_encoder as q25e
from smolvision_tpu_torch.models import qwen3_decoder as dec_mod
from smolvision_tpu_torch.models import qwen3_encoder as enc_mod
from smolvision_tpu_torch.ops.mel import log_mel
from smolvision_tpu_torch.ops.quant import embed_rows
from smolvision_tpu_torch.parallel.mesh import mesh_tp
from smolvision_tpu_torch.runtime import prompt as prompt_mod
from smolvision_tpu_torch.runtime.buckets import bucket, window_bucket
from smolvision_tpu_torch.runtime.decode_graph import (DECODE_CHUNK, DecodeLoop, PrefillGraph,
                                                       SampleLoop, SpecLoop)
from smolvision_tpu_torch.runtime.perf import PerfStats
from smolvision_tpu_torch.runtime.sampling import REP_WINDOW, CRefSampler, Sampler
from smolvision_tpu_torch.text.tokenizer import Tokenizer, load_tokenizer

KV_HEADROOM = 256
# speculative draft depth (--spec): int8 draft tokens verified per forward;
# tokens per verify <= SPEC_DRAFT + 1
SPEC_DRAFT = max(1, int(os.environ.get("SMOLVISION_SPEC_DRAFT", "4")))

TokenCallback = Callable[[bytes], None]


def _now_ms() -> float:
    return time.monotonic() * 1000.0


class Engine:
    """One loaded checkpoint on one device + generation settings."""

    def __init__(self, model_dir: str, param_dtype=torch.bfloat16, kv_dtype=torch.bfloat16,
                 enc_window_sec: Optional[float] = None, verbose: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 q8: bool = False, kv8: bool = False, spec: bool = False,
                 moe_offload: bool = False):
        self.device = resolve_device(device)
        self.model_dir = model_dir
        self.verbose = verbose
        self.reader = MultiSafetensors(model_dir)
        cfg = detect_config(model_dir, self.reader)
        if enc_window_sec is not None:
            frames = int(enc_window_sec * 100.0 + 0.5)
            frames = min(max(frames, 100), 800)
            cfg = dataclasses.replace(cfg, enc_n_window_infer=frames)
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.kv_dtype = kv_dtype

        if verbose >= 1:
            print(f"Detected: {cfg.name} ({cfg.family})", file=sys.stderr, flush=True)

        load_encoder = (params_mod.load_q25_encoder if cfg.family == "q25"
                        else params_mod.load_qwen3_encoder)
        self.enc_params = load_encoder(self.reader, cfg, param_dtype, self.device)
        # MoE host offload (--moe-offload): the experts stay in the
        # checkpoint's memory map (self.reader, kept open) and go to the
        # card per layer; every other weight is resident
        self.moe_offload = bool(moe_offload) and cfg.is_moe
        self.dec_params = params_mod.load_decoder(self.reader, cfg, param_dtype, self.device,
                                                  experts_on_host=self.moe_offload)
        # int8 KV cache (--kv8): batched paths only; the single-stream cache
        # keeps kv_dtype, as in the JAX engine
        self.kv8 = bool(kv8)
        if self.kv8 and verbose >= 1:
            print("int8 KV cache active (--kv8) on batched paths: output "
                  "may differ from the bf16 parity path", file=sys.stderr, flush=True)
        # int8 decoder weights (--q8), the resident experts too; the encoder
        # and host-offloaded experts keep their dtypes
        self.q8 = bool(q8)
        if self.q8:
            self.dec_params = params_mod.quantize_decoder(self.dec_params)
            if verbose >= 1:
                print("int8 decoder weights active (--q8): output may differ "
                      "from the bf16 parity path", file=sys.stderr, flush=True)
        # speculative int8-draft decoding (--spec): SPEC_DRAFT tokens drafted
        # with an int8 copy of the decoder, then verified in one forward of
        # the full-precision decoder, whose greedy choice decides every
        # emitted token; meaningless under --q8 and --moe-offload, where it
        # turns itself off.  An MoE draft gathers int8 experts
        self.spec = bool(spec) and not self.q8 and not self.moe_offload
        if spec and not self.spec:
            print("warning: --spec disabled (meaningless with --q8 / "
                  "--moe-offload); output follows the quantized/offload "
                  "path, NOT bit-exact bf16 greedy", file=sys.stderr, flush=True)
        self.dec_params_draft = None
        if self.spec:
            self.dec_params_draft = params_mod.quantize_decoder(self.dec_params)
            if verbose >= 1:
                print("speculative int8-draft decoding active (--spec): "
                      "tokens are the verify forward's greedy choices, exactly "
                      "the plain greedy sequence on f32 weights; on bf16 weights "
                      "on the card, up to near ties (the verify and the "
                      "one-token step round bf16 products differently)",
                      file=sys.stderr, flush=True)
        self.expert_store = None
        if self.moe_offload:
            self.expert_store = off_mod.HostExpertStore(self.reader, cfg, self.device)
            if verbose >= 1:
                print("MoE host-offload active: experts stream from host "
                      "mmap per layer", file=sys.stderr, flush=True)

        # ---- generation settings (defaults mirror qwen_asr.c:257-272) ----
        self.segment_sec = 0.0
        self.search_sec = 3.0
        self.stream_chunk_sec = 2.0
        self.stream_rollback = 5
        self.stream_unfixed_chunks = 2
        self.stream_max_new_tokens = 32
        self.past_text_conditioning = False
        self.skip_silence = False
        self.thinker_max_tokens = 2048
        self.temperature = 0.7
        self.repetition_penalty = 1.1
        self.top_k = 40
        self.seed = 0
        # "np": the reproducible default (the host Sampler's first token,
        # then device sampled chunks); "cref": the reference C engine's
        # exact sampled stream (CRefSampler) in a per-token host loop, the
        # sampled parity arm (CLI --sampler cref)
        self.sampler_mode = "np"
        self.max_tokens = 2048
        # decode independent -S segments as one batch (runtime/batch_segments.py);
        # the offload engine has no batched forward
        self.batch_segments = not self.moe_offload

        self.prompt_text: Optional[str] = None
        self.force_language: Optional[str] = None
        self._prompt_tokens: List[int] = []
        self._force_tokens: List[int] = []
        self._prompt_ready = False

        self.token_cb: Optional[TokenCallback] = None
        # --monitor: streaming heartbeat symbols on stderr (runtime/stream.py)
        self.monitor = False
        self.perf = PerfStats(self.device)
        self._tokenizer: Optional[Tokenizer] = None
        # the device mesh of the batched paths (parallel/mesh.shard_engine)
        # and the encoder's sequence parallelism of the batched group encode
        # (dp > 1)
        self.serving_mesh = None
        self._enc_sp_mesh = None

        self._kv: Optional[torch.Tensor] = None
        self._kv_cap = 0
        # the single-stream decode loop of the current cache (a SpecLoop
        # under --spec, a SampleLoop for the sampled thinker) and its greedy
        # prefills by block rows (their CUDA graphs hold the cache tensor):
        # dropped whenever the cache is
        self._loop: Optional[Union[DecodeLoop, SpecLoop, SampleLoop]] = None
        self._prefills: Dict[int, PrefillGraph] = {}

    @property
    def batched_kv_dtype(self) -> torch.dtype:
        """Cache dtype of the batched paths (segments, serving): int8 under
        --kv8, else kv_dtype."""
        return torch.int8 if self.kv8 else self.kv_dtype

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # tokenizer / prompt settings
    # ------------------------------------------------------------------

    @property
    def tokenizer(self) -> Tokenizer:
        if self._tokenizer is None:
            self._tokenizer = load_tokenizer(self.model_dir)
        return self._tokenizer

    def set_prompt(self, text: Optional[str]):
        self.prompt_text = text or None
        self._prompt_ready = False

    def set_force_language(self, language: Optional[str]) -> bool:
        """Normalize + validate like qwen_set_force_language (qwen_asr.c:98-120):
        byte-level per the C locale (C isspace trim, ASCII case-fold, 64-byte
        buffer cap), not Python's Unicode-semantic str methods."""
        if not language:
            self.force_language = None
            self._prompt_ready = False
            return True
        raw = language.encode("utf-8", errors="surrogateescape")
        b = raw.strip(b" \t\n\r\x0b\x0c")
        if not b or len(b) + 1 > 64:
            return False

        def up(c):  # ASCII-only, as C-locale toupper/tolower
            return c - 32 if 0x61 <= c <= 0x7A else c

        def lo(c):
            return c + 32 if 0x41 <= c <= 0x5A else c

        norm_b = bytes([up(b[0])]) + bytes(lo(c) for c in b[1:])
        for cand in SUPPORTED_LANGUAGES:
            if norm_b == cand.encode("ascii"):
                self.force_language = cand
                self._prompt_ready = False
                return True
        return False

    def prepare_prompt(self):
        """Tokenize --prompt / --language once (qwen_asr.c:563-607)."""
        if self._prompt_ready:
            return
        tok = self.tokenizer
        self._prompt_tokens = tok.encode(self.prompt_text) if self.prompt_text else []
        if self.force_language:
            self._force_tokens = tok.encode(f"language {self.force_language}") + [TOKEN_ASR_TEXT]
        else:
            self._force_tokens = []
        self._prompt_ready = True

    # ------------------------------------------------------------------
    # KV cache
    # ------------------------------------------------------------------

    def reset_kv(self):
        self._kv = None
        self._kv_cap = 0
        self._loop = None
        self._prefills = {}   # a new dict: a session view (multistream) shares none

    def _ensure_kv(self, needed: int) -> torch.Tensor:
        """Cache sized to a pow2 bucket; grows by copy when exceeded.  Every
        single-stream path starts here or at `_embeds`."""
        self._require_solo()
        cap = bucket(needed, 256)
        if self._kv is None:
            self._kv = dec_mod.make_kv_cache(self.cfg, cap, self.kv_dtype, self.device)
            self._kv_cap = cap
        elif cap > self._kv_cap:
            new = dec_mod.make_kv_cache(self.cfg, cap, self.kv_dtype, self.device)
            new[:, :, : self._kv_cap] = self._kv
            self._kv = new
            self._kv_cap = cap
            self._loop = None
            self._prefills = {}
        return self._kv

    # ------------------------------------------------------------------
    # encoder
    # ------------------------------------------------------------------

    def encode(self, samples: np.ndarray) -> Tuple[torch.Tensor, int]:
        """Audio samples -> (audio embeddings [Acap, dec_hidden], n_tokens)."""
        return self.encode_mel(log_mel(samples))

    def encode_mel(self, mel: np.ndarray) -> Tuple[torch.Tensor, int]:
        if self.cfg.family == "q25":
            return self._encode_mel_q25(mel)
        return self._encode_mel_qwen3(mel)

    @torch.inference_mode()
    def _encode_mel_qwen3(self, mel: np.ndarray) -> Tuple[torch.Tensor, int]:
        """Same bucketing as the JAX engine: full chunks padded to a pow2
        count (>= 4) in one stem call, the partial tail chunk at its true
        width, tokens padded to a pow2 number of attention windows."""
        cfg = self.cfg
        chunk = cfg.enc_chunk_size
        frames = mel.shape[1]
        n_full = frames // chunk
        rem = frames % chunk

        parts = []
        if n_full:
            ncap = bucket(n_full, 4)
            chunks = np.zeros((ncap, mel.shape[0], chunk), np.float32)
            chunks[:n_full] = mel[:, : n_full * chunk].reshape(
                mel.shape[0], n_full, chunk).transpose(1, 0, 2)
            full_tok = enc_mod.conv_stem(self.enc_params,
                                         torch.from_numpy(chunks).to(self.device), cfg)
            parts.append(full_tok[:n_full].reshape(n_full * cfg.tokens_per_chunk, -1))
        if rem:
            partial = np.ascontiguousarray(mel[:, n_full * chunk :], dtype=np.float32)[None]
            parts.append(enc_mod.conv_stem(self.enc_params,
                                           torch.from_numpy(partial).to(self.device), cfg)[0])

        x = torch.cat(parts, dim=0)
        n_tokens = x.shape[0]
        wts = cfg.window_token_size()
        tcap = window_bucket(n_tokens, wts)
        if tcap > n_tokens:
            x = torch.cat([x, x.new_zeros((tcap - n_tokens, x.shape[1]))])
        enc = enc_mod.encoder_transformer(self.enc_params, x, n_tokens, cfg, wts)
        self.perf.encodes += 1
        return enc, n_tokens

    @torch.inference_mode()
    def _encode_mel_q25(self, mel: np.ndarray) -> Tuple[torch.Tensor, int]:
        """The Qwen2.5-Omni tower: the Conv1D stem over the whole mel, tokens
        padded to a pow2 number of 100-token windows, then the learned bos /
        eos rows around the valid tokens (outside the padded bucket), the
        result padded to bucket(n + 2, 16) rows."""
        cfg = self.cfg
        x = q25e.q25_conv_stem(self.enc_params,
                               torch.from_numpy(np.asarray(mel, np.float32)).to(self.device), cfg)
        n_tokens = x.shape[0]
        tcap = window_bucket(n_tokens, cfg.q25_token_window)
        if tcap > n_tokens:
            x = torch.cat([x, x.new_zeros((tcap - n_tokens, x.shape[1]))])
        proj = q25e.q25_encoder_transformer(self.enc_params, x, n_tokens, cfg)
        self.perf.encodes += 1
        bos_eos = self.enc_params["audio_bos_eos"].float()
        out = torch.cat([bos_eos[0:1], proj[:n_tokens], bos_eos[1:2]])
        n_audio = n_tokens + 2
        acap = bucket(n_audio, 16)
        if acap > n_audio:
            out = torch.cat([out, out.new_zeros((acap - n_audio, out.shape[1]))])
        return out, n_audio

    # ------------------------------------------------------------------
    # decoder primitives
    # ------------------------------------------------------------------

    def _require_solo(self) -> None:
        """The single-stream paths are not tensor-parallel: a tp > 1 engine
        (parallel/mesh.shard_engine) refuses them with one line."""
        if mesh_tp(self.serving_mesh) > 1:
            raise ValueError("the single-stream paths are not tensor-parallel: on a tp > 1 "
                             "mesh use the batched paths (segments, serving, multistream)")

    def _embeds(self, ids: Sequence[int], tcap: int, audio: Optional[torch.Tensor],
                audio_start: int, n_audio: int) -> torch.Tensor:
        """Embeddings [tcap, H] of `ids` (zero ids past them) with the audio
        rows spliced in at audio_start."""
        self._require_solo()
        ids_arr = np.zeros(tcap, dtype=np.int64)
        ids_arr[:len(ids)] = np.asarray(ids, dtype=np.int64)
        if audio is None:
            audio = torch.zeros((16, self.cfg.dec_hidden), device=self.device)
            audio_start, n_audio = -1_000_000, 0
        return dec_mod.build_embeds(self.dec_params, torch.from_numpy(ids_arr).to(self.device),
                                    audio, audio_start, n_audio)

    def _prefill(self, embeds: torch.Tensor, start_pos: int, valid_len: int, greedy: bool):
        """Kernel B2 over `embeds` written into cache rows start_pos.. (the
        rows below start_pos are kept); the first token or logits.  A greedy
        prefill goes through the cache's PrefillGraph for its block rows
        (captured on its second call), the logits path runs eagerly, and so
        does every prefill of the host-offload engine."""
        T = embeds.shape[0]
        kv = self._ensure_kv(start_pos + T + KV_HEADROOM)
        if self.moe_offload:
            out = self._offload(embeds, start_pos, valid_len, greedy)
            self.perf.logits_prefills += int(not greedy)
        elif greedy:
            graph = self._prefills.get(T)
            if graph is None:
                p, cfg = self.dec_params, self.cfg
                graph = PrefillGraph(
                    lambda e, at, n, kv=kv: dec_mod.prefill(p, cfg, e, at, n, kv)[0],
                    embeds, self.perf)
                self._prefills[T] = graph
            out = graph.run(embeds, start_pos, valid_len)
        else:
            out, self._kv = dec_mod.prefill(self.dec_params, self.cfg, embeds, start_pos,
                                            valid_len, kv, greedy=False)
            self.perf.logits_prefills += 1
        self.perf.prefills += 1
        self.perf.reuse_prefills += int(start_pos > 0)
        return out

    @torch.inference_mode()
    def prefill_ids(self, ids: Sequence[int], audio: Optional[torch.Tensor],
                    audio_start: int, n_audio: int, start_pos: int = 0,
                    greedy: bool = True):
        """Embed + splice + prefill `ids` into cache rows start_pos.. (0: a
        fresh prompt; > 0: a delta after start_pos cached rows, which are
        kept).  Returns (token_or_logits, start_pos + len(ids))."""
        total = len(ids)
        embeds = self._embeds(ids, bucket(total, 64), audio, audio_start, n_audio)
        return self._prefill(embeds, start_pos, total, greedy), start_pos + total

    @torch.inference_mode()
    def prefill_with_reuse(self, ids: Sequence[int], audio: Optional[torch.Tensor],
                           audio_start: int, n_audio: int, reused: int,
                           greedy: bool = True):
        """Prefill only the delta of the FULL prompt `ids` past its first
        `reused` rows, which the cache already holds (streaming KV reuse,
        qwen_asr.c:1807-1831, keyed on a host-side prompt signature;
        runtime/stream.py).  reused is clamped to len(ids) - 1, so the last
        row is always recomputed.  Returns (token_or_logits, len(ids))."""
        total = len(ids)
        reused = max(0, min(reused, total - 1))
        delta_cap = bucket(total - reused, 64)
        # the embeds cover [reused, reused + delta_cap), so the slice of the
        # delta rows is never cut short at the end of the bucket
        tcap = bucket(max(total, reused + delta_cap), 64)
        embeds = self._embeds(ids, tcap, audio, audio_start, n_audio)
        delta = embeds[reused : reused + delta_cap]
        return self._prefill(delta, reused, total - reused, greedy), total

    def _offload(self, embeds: torch.Tensor, start_pos: int, valid_len: int, greedy: bool):
        """The host-offload forward (models/moe_offload.py) over `embeds` at
        cache row start_pos, then the greedy head (K6 / K7) or the logits of
        row valid_len - 1."""
        p, cfg = self.dec_params, self.cfg
        hidden = off_mod.offload_forward(p, self.expert_store, cfg, embeds, start_pos,
                                             valid_len, self._kv)
        if greedy:
            return dec_mod.greedy_head(p, cfg, dec_mod.last_row(hidden, valid_len))[0]
        return dec_mod.logits_at(p, cfg, hidden, valid_len - 1)

    @torch.inference_mode()
    def decode_step(self, token: int, pos: int, greedy: bool = True):
        """One decode step at cache row `pos` (grows the cache first if needed)."""
        kv = self._ensure_kv(pos + 1)
        if self.moe_offload:
            tok = torch.tensor([int(token)], dtype=torch.int64, device=self.device)
            out = self._offload(embed_rows(self.dec_params["embed"], tok), pos, 1, greedy)
        else:
            out, self._kv = dec_mod.decode_step(self.dec_params, self.cfg, token, pos, kv,
                                                greedy=greedy)
        self.perf.decode_steps += 1
        self.perf.logits_steps += int(not greedy)
        return out

    def _decode_loop(self, pos: int, steps: int) -> Union[DecodeLoop, SpecLoop]:
        """The decode loop of the cache a chunk of `steps` tokens at cache
        row `pos` needs (a SpecLoop under --spec, whose last verify block
        writes up to SPEC_DRAFT + 1 rows past the last accepted position,
        as the reference's sizing at :723-726), made anew when the cache
        or the mode changed."""
        kv = self._ensure_kv(pos + steps + 1 + (SPEC_DRAFT + 1 if self.spec else 0))
        loop = self._loop
        if self.spec:
            if not isinstance(loop, SpecLoop) or loop.n_draft != SPEC_DRAFT:
                p, pd, cfg = self.dec_params, self.dec_params_draft, self.cfg

                def verify(seq, at, kv=kv):
                    hidden, _ = dec_mod.decoder_forward(p, cfg, embed_rows(p["embed"], seq.long()),
                                                        at, seq.shape[0], kv)
                    return dec_mod.greedy_head(p, cfg, hidden)

                loop = SpecLoop(lambda tok, at, kv=kv: dec_mod.decode_step(pd, cfg, tok, at, kv)[0],
                                verify, SPEC_DRAFT, kv, self._kv_cap, self.device, self.perf)
        elif not isinstance(loop, DecodeLoop):
            p, cfg = self.dec_params, self.cfg
            loop = DecodeLoop(
                lambda tok, at, kv=kv: dec_mod.decode_step(p, cfg, tok, at, kv)[0].reshape(1),
                1, kv, self._kv_cap, self.device, self.perf)
        self._loop = loop
        return loop

    def decode_greedy(self, first_token, start_pos: int, max_tokens: int,
                      on_token: Callable[[int], bool]) -> int:
        """Greedy loop in device chunks of DECODE_CHUNK tokens (of
        speculative iterations under --spec).

        `on_token(tid) -> keep_going` sees every token in order (the prefill
        token first); EOS tokens end the loop before the callback, like the C
        loop (qwen_asr.c:788-818).  Returns the iteration count (C's
        n_generated).  A chunk runs on the device up to its first EOS and
        is read once; the callbacks follow.  Gating never alters the
        generated sequence, so running the model a chunk ahead of the host
        is exact."""
        if max_tokens <= 0:
            return 0
        cur = int(first_token)
        n = 1
        if cur in EOS_TOKEN_IDS or not on_token(cur) or n >= max_tokens:
            return n
        with self.perf.span("decode.loop", device=self.perf.decode_device):
            if self.moe_offload:
                return self._decode_greedy_offload(cur, start_pos, n, max_tokens, on_token)
            pos = start_pos
            while True:
                steps = min(DECODE_CHUNK, max_tokens - n)
                loop = self._decode_loop(pos, steps)
                buf, count, replays = loop.run(cur, pos, steps)
                if isinstance(loop, SpecLoop):
                    # only live iterations count; replays past the chunk's end
                    # are wasted_steps
                    self.perf.spec_iters += loop.iterations
                    self.perf.spec_tokens += count
                    self.perf.decode_steps += loop.n_draft * loop.iterations
                else:
                    self.perf.decode_steps += replays
                for t in buf[0].tolist():
                    n += 1
                    if t in EOS_TOKEN_IDS or not on_token(t) or n >= max_tokens:
                        return n
                if count == 0:
                    return n
                cur = int(buf[0, -1])
                pos += count

    def _decode_greedy_offload(self, cur: int, pos: int, n: int, max_tokens: int,
                               on_token: Callable[[int], bool]) -> int:
        """decode_greedy's loop on the host-offload engine: one step per
        token on the host (each step's expert gathers need the router scores
        there), with decode_greedy's callback, EOS and count."""
        while True:
            cur = int(self.decode_step(cur, pos))
            pos += 1
            n += 1
            if cur in EOS_TOKEN_IDS or not on_token(cur) or n >= max_tokens:
                return n

    # ------------------------------------------------------------------
    # segment transcription (the core ASR path)
    # ------------------------------------------------------------------

    def transcribe_segment(self, samples: np.ndarray,
                           past_tokens: Optional[Sequence[int]] = None) -> Tuple[str, int]:
        """One segment: mel -> encode -> prompt -> prefill -> greedy decode.
        Mirrors transcribe_segment (qwen_asr.c:649-842).  Returns
        (text, n_text_tokens); streams pieces via self.token_cb."""
        cfg = self.cfg
        seg_t0 = _now_ms()
        self.prepare_prompt()
        tok = self.tokenizer

        t0 = _now_ms()
        mel = log_mel(samples)
        mel_ms = _now_ms() - t0

        t0 = _now_ms()
        audio, n_audio = self.encode_mel(mel)
        self._sync()
        enc_ms = _now_ms() - t0

        ids, audio_start = prompt_mod.build_asr_prompt(
            cfg, n_audio, self._prompt_tokens, self._force_tokens, past_tokens)

        t0 = _now_ms()
        self.reset_kv()
        first, pos = self.prefill_ids(ids, audio, audio_start, n_audio)
        first = int(first)
        prefill_ms = _now_ms() - t0

        t0 = _now_ms()
        state = {
            "past_asr_text": bool(self._force_tokens) or bool(past_tokens),
            "pieces": [],
            "n_text": 0,
        }

        def on_token(tid: int) -> bool:
            if tid == TOKEN_ASR_TEXT:
                state["past_asr_text"] = True
            elif state["past_asr_text"]:
                piece = tok.decode_piece(tid)
                state["pieces"].append(piece)
                state["n_text"] += 1
                if self.token_cb:
                    self.token_cb(piece)
            return True

        self.decode_greedy(first, pos, self.max_tokens, on_token)
        decode_ms = _now_ms() - t0

        text = b"".join(state["pieces"]).decode("utf-8", errors="replace").strip()
        self.perf.total_ms += _now_ms() - seg_t0
        self.perf.text_tokens += state["n_text"]
        self.perf.mel_ms += mel_ms
        self.perf.encode_ms += mel_ms + enc_ms
        self.perf.prefill_ms += prefill_ms
        self.perf.decode_ms += prefill_ms + decode_ms
        if self.verbose >= 2:
            print(f"  Mel: {mel.shape[1]} frames ({mel_ms:.0f} ms); "
                  f"Encoder: {n_audio} tokens ({enc_ms:.0f} ms); "
                  f"Prefill: {len(ids)} tokens ({prefill_ms:.0f} ms); "
                  f"Decode: {state['n_text']} text tokens ({decode_ms:.0f} ms)",
                  file=sys.stderr, flush=True)
            if self.spec and self.perf.spec_iters:
                p = self.perf
                print(f"  Spec: {p.spec_tokens} tokens / {p.spec_iters} "
                      f"verify iters = {p.spec_tokens / p.spec_iters:.2f} "
                      f"tokens/iter (draft {SPEC_DRAFT}, max "
                      f"{SPEC_DRAFT + 1})", file=sys.stderr, flush=True)
        return text, state["n_text"]

    # ------------------------------------------------------------------
    # thinker mode
    # ------------------------------------------------------------------

    def _sample_loop(self, pos: int, steps: int) -> SampleLoop:
        """The sampled decode loop of the cache a chunk of `steps` steps at
        cache row `pos` needs, made anew when the cache, the mode or top_k
        changed."""
        kv = self._ensure_kv(pos + steps + 1)
        loop = self._loop
        if not isinstance(loop, SampleLoop) or loop.top_k != self.top_k:
            p, cfg = self.dec_params, self.cfg
            loop = SampleLoop(
                lambda tok, at, kv=kv: dec_mod.decode_step(p, cfg, tok, at, kv, greedy=False)[0],
                self.top_k, kv, self._kv_cap, self.device, self.perf)
        self._loop = loop
        return loop

    def thinker_generate(self, samples: Optional[np.ndarray],
                         user_text: Optional[str]) -> Optional[str]:
        """Free-form generation (qwen_asr.c:2319-2612): an audio or a text
        prompt, temperature / top-k / repetition-penalty sampling, no
        <asr_text> gate.  Greedy at temperature 0 (decode_greedy);
        --sampler cref: a per-token host loop of logits steps and
        CRefSampler; otherwise the host Sampler draws the first token and
        SampleLoop chunks the rest on the device."""
        if samples is None and not user_text:
            return None
        cfg = self.cfg
        self.perf.reset()
        total_t0 = _now_ms()
        self.prepare_prompt()
        tok = self.tokenizer
        self.perf.audio_ms = (len(samples) / 16.0) if samples is not None else 0.0

        enc_ms = 0.0
        if samples is not None and len(samples) > 0:
            t0 = _now_ms()
            audio, n_audio = self.encode(samples)
            self._sync()
            enc_ms = _now_ms() - t0
            ids, audio_start = prompt_mod.build_thinker_audio_prompt(
                cfg, n_audio, self._prompt_tokens)
        else:
            audio, n_audio, audio_start = None, 0, -1
            user_tokens = tok.encode(user_text or "")
            ids = prompt_mod.build_thinker_text_prompt(cfg, user_tokens, self._prompt_tokens)

        sampler_cls = CRefSampler if self.sampler_mode == "cref" else Sampler
        sampler = sampler_cls(self.temperature, self.repetition_penalty, self.top_k, self.seed)
        use_sampling = not sampler.greedy

        t0 = _now_ms()
        self.reset_kv()
        out, pos = self.prefill_ids(ids, audio, audio_start, n_audio, greedy=not use_sampling)
        if use_sampling:
            out = out.float().cpu().numpy()
        self._sync()
        prefill_ms = _now_ms() - t0

        pieces: List[bytes] = []
        n_text = 0

        def emit(tid: int) -> bool:
            nonlocal n_text
            piece = tok.decode_piece(tid)
            if piece:
                pieces.append(piece)
                n_text += 1
                if self.token_cb:
                    self.token_cb(piece)
            return True

        t0 = _now_ms()
        max_tokens = self.thinker_max_tokens
        if use_sampling and (self.sampler_mode == "cref" or self.moe_offload):
            # the parity arm: every logits vector comes to the host and
            # CRefSampler replays the C engine's sample_token arithmetic and
            # drand48 stream; the host-offload engine takes the same
            # per-token loop with the host Sampler (its steps cannot be a
            # device chunk)
            token = sampler.sample(out)
            n = 0
            while n < max_tokens:
                n += 1
                if token in EOS_TOKEN_IDS:
                    break
                emit(token)
                sampler.observe(token)
                logits = self.decode_step(token, pos, greedy=False)
                pos += 1
                token = sampler.sample(logits.float().cpu().numpy())
        elif use_sampling:
            # the first token drawn on the host (one logits read); the rest
            # in device chunks, one host read each
            token = sampler.sample(out)
            pending = [token]
            recent = torch.zeros(REP_WINDOW, dtype=torch.int32, device=self.device)
            n_recent = torch.zeros(1, dtype=torch.int64, device=self.device)
            cur = token
            n = 0
            while n < max_tokens:
                if not pending:
                    steps = min(DECODE_CHUNK, max_tokens - n)
                    loop = self._sample_loop(pos, steps)
                    buf, count, replays = loop.run(cur, pos, steps, recent, n_recent,
                                                   self.temperature, self.repetition_penalty,
                                                   self.seed)
                    self.perf.decode_steps += replays
                    self.perf.logits_steps += replays
                    if count == 0:
                        break
                    pos += count
                    pending = buf[0].tolist()
                    cur = pending[-1]
                tid = pending.pop(0)
                n += 1
                if tid in EOS_TOKEN_IDS:
                    break
                emit(tid)
        else:
            self.decode_greedy(out, pos, max_tokens, emit)
        self._sync()
        decode_ms = _now_ms() - t0

        self.perf.total_ms = _now_ms() - total_t0
        self.perf.text_tokens = n_text
        self.perf.encode_ms = enc_ms
        self.perf.prefill_ms = prefill_ms
        self.perf.decode_ms = prefill_ms + decode_ms
        if self.verbose >= 2:
            print(f"  Thinker: {len(ids)} prompt tokens ({prefill_ms:.0f} ms prefill); "
                  f"{n_text} text tokens ({decode_ms:.0f} ms decode)",
                  file=sys.stderr, flush=True)
        return b"".join(pieces).decode("utf-8", errors="replace")
