"""CPU rehearsals of every cell at the tiny sizes: one valid result line,
correct on the program, not correct with the timed path broken."""

import json

import pytest

from portbench.tests.tiny import CELLS, bench, run_tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _valid(out, trace):
    assert KEYS <= set(out) and list(out)[-1] == "compared"
    json.dumps(out)
    cell_metrics = {m["name"] for m in bench()["per_layer" if trace else "end_to_end"]}
    assert set(out["metrics"]) <= cell_metrics
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearses_correct(cell):
    out = run_tiny(cell)
    _valid(out, 0)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert "setup_s" in out["metrics"] and "audio_s_per_s" in out["metrics"]


def test_traced_rehearsal_reports_per_layer_metrics():
    out = run_tiny("asr06b.serve", trace=1)
    _valid(out, 1)
    assert out["correct"]
    assert {"batch_step_ms", "model_mfu", "wave_dispatch_ms"} <= set(out["metrics"])
    assert set(out["audio_s_per_s_by_window"]) == {"untraced", "device_trace", "host_trace"}


def _altered_token(monkeypatch):
    """A token altered where it is produced: the greedy head's choice + 1."""
    from smolvision_tpu_torch.models import qwen3_decoder as dec

    head = dec.greedy_head
    monkeypatch.setattr(dec, "greedy_head", lambda *a, **k: (head(*a, **k) + 1) % 151000)


def _state_unchanged(monkeypatch):
    """A step that leaves its state unchanged: no K/V row is written to the
    cache (the batched paths' and the single stream's)."""
    from smolvision_tpu_torch.models import qwen3_decoder as dec

    monkeypatch.setattr(dec, "kv_write", lambda cache, *a, **k: None)
    block = dec._attn_block

    def frozen(lp, h, kv, layer, *a, **k):
        keep = kv[layer].clone()
        out = block(lp, h, kv, layer, *a, **k)
        kv[layer].copy_(keep)
        return out

    monkeypatch.setattr(dec, "_attn_block", frozen)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    """Each fault a cell of BENCHMARK.json can have, planted under a run
    that skips only the look for a card: `correct` comes out false."""
    fault(monkeypatch)
    out = run_tiny(cell)
    assert not out["correct"], out["compared"]
