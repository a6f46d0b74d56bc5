"""The seeded checkpoint: every tensor of the program's checkpoint layout,
at its shape, for every configuration; blocks drawn again bit for bit; the
program's loaders take it whole at the tiny sizes."""

import pytest
import torch

from portbench import harness, weights
from portbench.tests.tiny import tiny_conf

PRESET = {"qwen3-asr-0.6b": "0.6b"}


@pytest.mark.parametrize("config", sorted(PRESET))
def test_every_tensor_of_the_checkpoint_layout(config):
    from smolvision_tpu_torch.models import synthetic

    conf = harness.load_json(harness.HERE, "configs", config + ".json")
    want = {name: tuple(shape) for name, shape, _, _ in
            synthetic._specs(synthetic.PRESETS[PRESET[config]])}
    got = {name: b.shape for b in weights.blocks(conf["model"]) for name in b.names}
    assert got == want


def test_blocks_draw_again_bit_for_bit():
    model = tiny_conf("qwen3-asr-0.6b")["model"]
    a = weights.SeededCheckpoint(model, 2 ** 33 + 1, "cpu", keep=1)
    b = weights.SeededCheckpoint(model, 2 ** 33 + 1, "cpu", keep=1)
    c = weights.SeededCheckpoint(model, 2 ** 33 + 2, "cpu", keep=1)
    names = list(a.names())
    for name in (names[0], names[len(names) // 2], names[-1]):
        x = a.get(name)
        assert torch.equal(x, b.get(name))
        assert x.dtype == (torch.bfloat16 if x.dim() >= 2 else torch.float32)
    name = "thinker.model.layers.1.mlp.down_proj.weight"
    assert not torch.equal(a.get(name), c.get(name))
    assert torch.equal(a.get(name), b.get(name))


@pytest.mark.parametrize("config", sorted(PRESET))
def test_the_programs_loaders_take_every_tensor(config):
    from smolvision_tpu_torch.config import detect_config
    from smolvision_tpu_torch.models import params

    conf = tiny_conf(config)
    ckpt = weights.SeededCheckpoint(conf["model"], 99, "cpu")
    cfg = detect_config(harness.model_dir(conf), ckpt)
    asked = set()
    get = ckpt.get

    def seen(name):
        asked.add(name)
        return get(name)

    ckpt.get = seen
    params.load_qwen3_encoder(ckpt, cfg, torch.bfloat16, "cpu")
    dec = params.load_decoder(ckpt, cfg, torch.bfloat16, "cpu")
    assert asked == set(ckpt.names())
    assert not dec.get("moe_layers")
