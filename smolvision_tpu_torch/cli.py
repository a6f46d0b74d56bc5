"""CLI — the JAX package's parser and stdout/stderr contract, on the port.

Port of smolvision_tpu/cli.py for the offline, streaming and thinker paths:
one file (`-i x.wav` or --stdin), whole or segmented (-S / -W / --past-text /
--skip-silence / --no-batch-segments), streamed (--stream, from a file or
live from stdin with --stdin; --stream-max-new-tokens, --monitor), several
-i files as one static batch, through the continuous scheduler (--serve
SLOTS [--serve-admit N]) or streamed as concurrent sessions (--stream:
multistream, runtime/multistream.py); with --silent / --language / --prompt /
--max-tokens / --f32 / --enc-window-sec / --profile DIR (a torch.profiler
trace of the transcription), and the decoder options --q8 / --kv8 /
--spec (or SMOLVISION_Q8=1 / SMOLVISION_KV8=1 / SMOLVISION_SPEC=1, as the
JAX CLI reads them); free-form generation from audio or --text under
--thinker (--max-tokens / --temperature / --repeat-penalty / --top-k /
--seed / --sampler), which is also where a Qwen2.5-Omni checkpoint's ASR
goes (with the default system prompt and temperature 0.7); an MoE
checkpoint's experts resident or on the host (--moe-offload, with
--moe-preload touching their pages first: one stream at a time, so several
-i files exit 1).  The transcript
goes to STDOUT
(tokens streamed as decoded in normal mode; one final line in --silent; one
line per file for several files); status/perf lines go to STDERR:
  Inference: ... ms, N text tokens (X tok/s, encoding: ...ms, decoding: ...ms)
  Audio: X s processed in Y s (Zx realtime)
  Batch: N files, X s audio in Y s (Zx realtime)      (several files)
  Streams: N sessions, X s audio in Y s (Zx realtime) (several files, --stream)
  Serve: ttft p50 ... / p99 ..., completion ...       (--serve)
Runs on the card; SMOLVISION_PLATFORM=cpu selects the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np

if TYPE_CHECKING:
    from smolvision_tpu_torch.runtime.engine import Engine

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="smolvision",
        description="smolvision_tpu_torch — Qwen3-ASR speech-to-text (PyTorch/CUDA)")
    p.add_argument("-d", dest="model_dir", required=True, help="model directory")
    p.add_argument("-i", dest="input_wav", nargs="+", metavar="WAV",
                   help="input WAV file(s); several files are transcribed as "
                        "one device batch (serving mode), one line each")
    p.add_argument("--stdin", action="store_true", help="read audio from stdin")
    p.add_argument("-t", dest="threads", type=int, default=0,
                   help="host threads (accepted for compatibility)")
    p.add_argument("-S", dest="segment_sec", type=float, default=-1,
                   help="segment target seconds (0 = full-audio decode)")
    p.add_argument("-W", dest="search_sec", type=float, default=-1,
                   help="segment-cut silence search window +/- seconds")
    p.add_argument("--stream", action="store_true", help="streaming mode")
    p.add_argument("--stream-max-new-tokens", type=int, default=-1)
    p.add_argument("--enc-window-sec", type=float, default=-1)
    p.add_argument("--past-text", choices=["yes", "no", "auto"], default="auto")
    p.add_argument("--skip-silence", action="store_true")
    p.add_argument("--prompt", default=None)
    p.add_argument("--language", default=None)
    p.add_argument("--thinker", action="store_true")
    p.add_argument("--text", dest="thinker_text", default=None)
    p.add_argument("--max-tokens", type=int, default=-1)
    p.add_argument("--temperature", "--temp", dest="temperature", type=float, default=-1.0)
    p.add_argument("--repeat-penalty", type=float, default=-1.0)
    p.add_argument("--top-k", type=int, default=-1)
    p.add_argument("--seed", type=int, default=0, help="sampling seed (thinker)")
    p.add_argument("--sampler", choices=["device", "cref"], default="device",
                   help="thinker sampling arm: device = sampled chunks on "
                        "device (fast, np-seeded); cref = per-token host "
                        "loop replaying the reference C engine's exact "
                        "drand48 sampler (cross-engine sampled parity)")
    p.add_argument("--moe-preload", action="store_true",
                   help="accepted for compatibility (weights are device-resident; "
                        "with --moe-offload: touch all expert pages up front)")
    p.add_argument("--moe-offload", action="store_true",
                   help="MoE experts stay on HOST and stream per layer "
                        "(runs checkpoints whose experts exceed device HBM, "
                        "e.g. 30B on one chip; docs/MOE_30B_PLAN.md Plan B)")
    p.add_argument("--monitor", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--silent", action="store_true")
    p.add_argument("--q8", action="store_true",
                   help="int8 decoder weights: ~1.7x decode speed, small "
                        "accuracy trade (outside the bf16 parity contract); "
                        "also SMOLVISION_Q8=1")
    p.add_argument("--spec", action="store_true",
                   help="speculative int8-draft decoding: draft tokens with "
                        "an int8 decoder copy, verify in one bf16 forward — "
                        "output stays BIT-EXACT bf16 greedy at near-int8 "
                        "decode speed; also SMOLVISION_SPEC=1")
    p.add_argument("--kv8", action="store_true",
                   help="int8 KV cache on the batched decode paths (serving/"
                        "multistream/batched segments): halves the dominant "
                        "KV-read bytes at B>=8 for a small accuracy trade; "
                        "also SMOLVISION_KV8=1")
    p.add_argument("--f32", action="store_true",
                   help="float32 weights AND KV cache (the C engine's exact "
                        "arithmetic family — its kv_cache_k/v are float*, "
                        "qwen_asr_decoder.c:171-172; parity runs, slower)")
    p.add_argument("--no-batch-segments", action="store_true",
                   help="decode -S segments sequentially like the reference")
    p.add_argument("--serve", type=int, metavar="SLOTS", default=0,
                   help="with several -i files: continuous-batching scheduler "
                        "(runtime/serving.py) with SLOTS rolling decode rows "
                        "instead of one static batch — rows admit as others "
                        "finish; best for many or mixed-length clips")
    p.add_argument("--serve-admit", type=int, metavar="N", default=0,
                   help="latency knob for --serve: admit at most N clips per "
                        "wave so the first clips start decoding without "
                        "waiting for the full SLOTS-wide prefill (measured: "
                        "admit->first-token p50 ~100 ms at N=16 vs ~1.2 s "
                        "full-wave, at ~47%% throughput cost)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the transcription to DIR "
                        "(DIR/trace.json)")
    return p


def run(argv=None) -> Tuple[int, Optional["Engine"]]:
    """`main`, also returning the Engine it ran (None when none was built)."""
    args = build_parser().parse_args(argv)

    if not args.thinker and not args.input_wav and not args.stdin:
        print("Error: need -i, --stdin, or --thinker --text", file=sys.stderr)
        return 1, None
    if args.thinker and not args.input_wav and not args.stdin and not args.thinker_text:
        print("Error: --thinker requires -i, --stdin, or --text", file=sys.stderr)
        return 1, None
    if args.input_wav and args.stdin:
        print("Error: -i and --stdin are mutually exclusive", file=sys.stderr)
        return 1, None
    if args.enc_window_sec >= 0 and not (1.0 <= args.enc_window_sec <= 8.0):
        print(f"Error: --enc-window-sec must be in [1, 8], got {args.enc_window_sec}",
              file=sys.stderr)
        return 1, None
    verbosity = 0 if args.silent else (2 if args.debug else 1)

    import torch

    from smolvision_tpu_torch.io.wav import load_wav, read_pcm_stdin
    from smolvision_tpu_torch.runtime.engine import Engine

    platform = os.environ.get("SMOLVISION_PLATFORM", "").strip().lower()
    try:
        eng = Engine(
            args.model_dir,
            param_dtype=torch.float32 if args.f32 else torch.bfloat16,
            # --f32 is f32 weights AND f32 KV, the C engine's arithmetic
            # family end to end (its kv_cache_k/v are float*)
            kv_dtype=torch.float32 if args.f32 else torch.bfloat16,
            enc_window_sec=args.enc_window_sec if args.enc_window_sec >= 0 else None,
            verbose=verbosity,
            device="cpu" if platform == "cpu" else None,
            q8=args.q8 or os.environ.get("SMOLVISION_Q8", "") == "1",
            kv8=args.kv8 or os.environ.get("SMOLVISION_KV8", "") == "1",
            spec=args.spec or os.environ.get("SMOLVISION_SPEC", "") == "1",
            moe_offload=args.moe_offload,
        )
    except Exception as e:
        # mirror the reference's one-line load failure (main.c:292-296)
        print(f"smolvision: failed to load model from {args.model_dir}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1, None
    eng.monitor = args.monitor
    if args.moe_offload and not eng.moe_offload and verbosity >= 1:
        print("--moe-offload: model is not MoE; ignored", file=sys.stderr)

    if args.segment_sec >= 0:
        eng.segment_sec = args.segment_sec
    if args.search_sec >= 0:
        eng.search_sec = args.search_sec
    if args.stream_max_new_tokens > 0:
        eng.stream_max_new_tokens = args.stream_max_new_tokens
    if args.past_text in ("yes", "no"):
        eng.past_text_conditioning = args.past_text == "yes"
    elif args.stream:
        # auto: streaming defaults to prefix conditioning (main.c:316-320)
        eng.past_text_conditioning = True
    if args.skip_silence:
        eng.skip_silence = True
    if args.max_tokens > 0:
        eng.thinker_max_tokens = args.max_tokens
        eng.max_tokens = args.max_tokens
    if args.temperature >= 0:
        eng.temperature = args.temperature
    if args.repeat_penalty >= 0:
        eng.repetition_penalty = args.repeat_penalty
    if args.top_k >= 0:
        eng.top_k = args.top_k
    eng.seed = args.seed
    if args.sampler == "cref":
        eng.sampler_mode = "cref"
    if args.no_batch_segments:
        eng.batch_segments = False
    if args.moe_preload:
        if eng.moe_offload:
            gb = eng.expert_store.preload() / 1e9
            if verbosity >= 1:
                # the reference's preload report (qwen_asr_decoder.c:354)
                print(f"MoE preload: touched {gb:.1f} GB of host expert pages",
                      file=sys.stderr)
        elif verbosity >= 1:
            note = ("MoE experts are device-resident (loaded at startup); "
                    "--moe-preload is implicit on the card"
                    if eng.cfg.is_moe else "--moe-preload: model is not MoE")
            print(note, file=sys.stderr)
    if args.prompt:
        eng.set_prompt(args.prompt)
    if args.language:
        if not eng.set_force_language(args.language):
            from smolvision_tpu_torch.config import SUPPORTED_LANGUAGES

            print(f"Unsupported language for --language: {args.language}", file=sys.stderr)
            print("Supported languages: " + ",".join(SUPPORTED_LANGUAGES), file=sys.stderr)
            return 1, eng

    emit_tokens = verbosity > 0

    def stream_token(piece: bytes):
        sys.stdout.buffer.write(piece)
        sys.stdout.flush()

    eng.token_cb = stream_token if emit_tokens else None

    if args.input_wav and len(args.input_wav) > 1:
        if args.thinker or eng.cfg.family == "q25":
            print("Error: multiple -i files only supported in plain Qwen3 ASR mode",
                  file=sys.stderr)
            return 1, eng
        if eng.moe_offload:
            # the batched forwards read the expert stacks, which stay on the host
            print("smolvision: --moe-offload decodes one stream at a time: several -i files "
                  "(a batch, --serve, multistream) are not supported with it", file=sys.stderr)
            return 1, eng
        return _run_several(args, eng, verbosity), eng

    # Qwen2.5-Omni has no <asr_text> ASR head: ASR requests go through the
    # thinker with a default system prompt (q25_transcribe_audio,
    # qwen25_omni.c:590-607), --stream included
    if eng.cfg.family == "q25" and not args.thinker:
        args.thinker = True
        if not eng.prompt_text:
            eng.set_prompt("You are a helpful assistant.")
        if args.temperature < 0:
            eng.temperature = 0.7

    from smolvision_tpu_torch.runtime import segment as segment_mod
    from smolvision_tpu_torch.runtime import stream as stream_mod

    live = None
    samples = None
    if args.stream and args.stdin and not args.thinker:
        from smolvision_tpu_torch.io.live import LiveAudio

        live = LiveAudio.start_stdin()
    elif args.input_wav or args.stdin:
        try:
            samples = load_wav(args.input_wav[0]) if args.input_wav else read_pcm_stdin()
        except (OSError, ValueError) as e:
            print(f"smolvision: cannot load audio: {e}", file=sys.stderr)
            # the reference goes on text-only when the audio fails to load
            # but --text is given (main.c:242-245)
            if not (args.thinker and args.thinker_text):
                return 1, eng
        if samples is not None:
            samples = np.asarray(samples, dtype=np.float32)

    try:
        with _profiled(args.profile, eng.device):
            if args.thinker:
                text = eng.thinker_generate(samples, args.thinker_text)
            elif live is not None:
                text = stream_mod.transcribe_stream_live(eng, live)
            elif args.stream:
                text = stream_mod.transcribe_stream(eng, samples)
            else:
                text = segment_mod.transcribe_audio(eng, samples)
    except ValueError as e:
        print(f"smolvision: {e}", file=sys.stderr)
        return 1, eng
    if text is None:
        print("Transcription failed", file=sys.stderr)
        return 1, eng

    if emit_tokens:
        sys.stdout.write("\n")
    else:
        sys.stdout.write(text + "\n")
    sys.stdout.flush()

    if verbosity >= 1:
        perf = eng.perf
        tok_s = (1000.0 * perf.text_tokens / perf.total_ms) if perf.total_ms > 0 else 0.0
        print(f"Inference: {perf.total_ms:.0f} ms, {perf.text_tokens} text tokens "
              f"({tok_s:.2f} tok/s, encoding: {perf.encode_ms:.0f}ms, "
              f"decoding: {perf.decode_ms:.0f}ms)", file=sys.stderr)
        if perf.audio_ms > 0 and perf.total_ms > 0:
            audio_s = perf.audio_ms / 1000.0
            infer_s = perf.total_ms / 1000.0
            print(f"Audio: {audio_s:.1f} s processed in {infer_s:.1f} s "
                  f"({audio_s / infer_s:.2f}x realtime)", file=sys.stderr)
    return 0, eng


@contextlib.contextmanager
def _profiled(trace_dir: Optional[str], device):
    """Under --profile DIR: a torch.profiler trace of the block (host, and
    the card's kernels when the engine runs there) written to
    DIR/trace.json, with the program's spans as `smolvision.*` ranges
    (runtime/perf.py).  Writing it is best-effort, as in the JAX CLI."""
    if not trace_dir:
        yield
        return
    import torch

    from smolvision_tpu_torch.runtime.perf import profile_ranges

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    ranges = profile_ranges(True)
    try:
        yield
    finally:
        profile_ranges(ranges)
        try:
            prof.stop()
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            print(f"profile trace written to {trace_dir}", file=sys.stderr)
        except Exception as e:  # profiling is best-effort
            print(f"smolvision: profiler stop failed: {e}", file=sys.stderr)


def _run_several(args, eng: "Engine", verbosity: int) -> int:
    """Several -i files: one static batch (runtime/batch_segments.py), the
    continuous scheduler under --serve (runtime/serving.py), or one
    streaming session per file under --stream (runtime/multistream.py);
    one line per file on stdout, in file order, once all are done."""
    import time

    from smolvision_tpu_torch.config import SAMPLE_RATE
    from smolvision_tpu_torch.io.wav import load_wav

    try:
        clips = [load_wav(f) for f in args.input_wav]
    except (OSError, ValueError) as e:
        print(f"smolvision: cannot load audio: {e}", file=sys.stderr)
        return 1
    # a clip shorter than one mel frame would fail inside the batch encode
    for f, c in zip(args.input_wav, clips):
        if len(c) < 160:
            print(f"smolvision: cannot load audio: {f}: too short ({len(c)} samples; "
                  "need at least one 10 ms mel frame)", file=sys.stderr)
            return 1
    perf = eng.perf
    perf.reset()
    perf.audio_ms = sum(1000.0 * len(c) / SAMPLE_RATE for c in clips)
    t0 = time.monotonic()
    if args.stream:
        from smolvision_tpu_torch.runtime.multistream import run_streams

        texts = [text or "" for text in run_streams(eng, clips)]
        perf.total_ms = (time.monotonic() - t0) * 1000.0
        for text in texts:
            sys.stdout.write(text + "\n")
        sys.stdout.flush()
        if verbosity >= 1:
            print(f"Streams: {len(clips)} sessions, {perf.audio_ms / 1000:.1f} s audio in "
                  f"{perf.total_ms / 1000:.1f} s "
                  f"({perf.audio_ms / max(perf.total_ms, 1):.2f}x realtime)", file=sys.stderr)
        return 0
    if args.serve > 0:
        from smolvision_tpu_torch.runtime.serving import serve_continuous

        texts = serve_continuous(eng, clips, slots=args.serve, admit_cap=args.serve_admit)
    else:
        from smolvision_tpu_torch.runtime.batch_segments import transcribe_segments_batched

        texts = transcribe_segments_batched(eng, clips)
    perf.total_ms = (time.monotonic() - t0) * 1000.0
    for text in texts:
        sys.stdout.write(text + "\n")
    sys.stdout.flush()
    if verbosity >= 1:
        print(f"Batch: {len(clips)} files, {perf.audio_ms / 1000:.1f} s audio "
              f"in {perf.total_ms / 1000:.1f} s "
              f"({perf.audio_ms / max(perf.total_ms, 1):.2f}x realtime)", file=sys.stderr)
        if args.serve > 0 and perf.serving_latency:
            lat = perf.serving_latency
            print(f"Serve: ttft p50 {lat['ttft_p50_ms']:.0f} ms / "
                  f"p99 {lat['ttft_p99_ms']:.0f} ms (admit->first p50 "
                  f"{lat['admit_ttft_p50_ms']:.0f} ms), completion p50 "
                  f"{lat['done_p50_ms']:.0f} ms / p99 {lat['done_p99_ms']:.0f} ms",
                  file=sys.stderr)
    return 0


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
