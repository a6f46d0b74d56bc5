"""Continuous serving: each call sends one queue of clips to
`runtime.serving.decode_continuous` with the mix's slots, and gets back
every clip's raw greedy token row."""

from __future__ import annotations

from portbench.reference import qwen3_asr as ref_mod


def prepare(run) -> None:
    run.engine.max_tokens = run.mix["max_tokens"]


def warmup(run) -> None:
    run.call(run.pool[0])


def call(run, req) -> dict:
    from smolvision_tpu_torch.runtime.serving import decode_continuous

    rows = decode_continuous(run.engine, req.clips, slots=run.mix["slots"])
    return {"req": req.index, "clips": req.clips, "rows": rows,
            "answers": [r is not None and len(r) > 0 for r in rows]}


def cases(run, records, ref, rng) -> list:
    """`check_clips` clips drawn from the window's queues, the longest among
    them."""
    pairs = [(k, i) for k, rec in enumerate(records) for i in range(len(rec["clips"]))]
    longest = max(pairs, key=lambda p: len(records[p[0]]["clips"][p[1]]))
    rest = [p for p in pairs if p != longest]
    n = min(run.mix["check_clips"], len(pairs)) - 1
    chosen = [longest] + [rest[j] for j in rng.choice(len(rest), size=n, replace=False)]
    out = []
    for k, i in chosen:
        clip, row = records[k]["clips"][i], records[k]["rows"][i]
        audio = ref.encode(clip)
        ids, start = ref_mod.asr_prompt(audio.shape[0])
        out.append(ref_mod.Case(ids, start, audio, row, tag=f"queue {k} clip {i}"))
    return out


def work(run, rec) -> list:
    """(audio samples, prompt tokens, generated tokens) per request."""
    out = []
    for clip, row in zip(rec["clips"], rec["rows"]):
        n_audio = ref_mod.audio_tokens(len(clip))
        out.append({"samples": [len(clip)], "prompt": len(ref_mod.asr_prompt(n_audio)[0]),
                    "generated": len(row)})
    return out
