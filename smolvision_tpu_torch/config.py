"""Model configuration and variant detection.

The reference hard-codes per-variant hyperparameters and detects the variant
by probing tensor names in the safetensors header (qwen_asr.c:135-215,
main.c:205-215).  We keep that probe (it works on checkpoints without a
usable config.json) but prefer reading config.json when present, matching the
official layout (python_simple_implementation.py:35-85).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

SAMPLE_RATE = 16000
NUM_MEL_BINS = 128
HOP_LENGTH = 160
N_FFT = 400
CONV_HIDDEN = 480  # Conv2D stem channel count (Qwen3 family)

# Special token ids (MODEL.md:231-242)
TOKEN_ENDOFTEXT = 151643
TOKEN_IM_START = 151644
TOKEN_IM_END = 151645
TOKEN_AUDIO_START = 151669
TOKEN_AUDIO_END = 151670
TOKEN_AUDIO_PAD = 151676
TOKEN_ASR_TEXT = 151704

# Qwen2.5-Omni family token ids (qwen25_omni.h:31-37)
Q25_AUDIO_START = 151647
Q25_AUDIO_END = 151648
Q25_AUDIO_TOKEN = 151646
Q25_VOCAB_SIZE = 152064

EOS_TOKEN_IDS = (TOKEN_ENDOFTEXT, TOKEN_IM_END)

SUPPORTED_LANGUAGES = (
    "Chinese", "English", "Cantonese", "Arabic", "German", "French",
    "Spanish", "Portuguese", "Indonesian", "Italian", "Korean", "Russian",
    "Thai", "Vietnamese", "Japanese", "Turkish", "Hindi", "Malay", "Dutch",
    "Swedish", "Danish", "Finnish", "Polish", "Czech", "Filipino",
    "Persian", "Greek", "Romanian", "Hungarian", "Macedonian",
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Frozen hyperparameter set for one checkpoint.

    Mirrors qwen_config_t (qwen_asr.h) + q25_config_t (qwen25_omni.h) merged
    into one structure; `family` selects the architecture deltas.
    """

    name: str = "qwen3-asr-0.6b"
    family: str = "qwen3"  # "qwen3" | "q25"

    # --- audio encoder ---
    enc_d_model: int = 896
    enc_layers: int = 18
    enc_heads: int = 14
    enc_ffn_dim: int = 3584
    enc_output_dim: int = 1024
    enc_n_window: int = 50          # chunk = 2*n_window mel frames (qwen3)
    enc_n_window_infer: int = 800   # attention window in mel frames (qwen3)
    enc_conv_hidden: int = CONV_HIDDEN
    # q25: fixed 100-token attention windows (qwen25_omni_encoder.c:221-227)
    q25_token_window: int = 100

    # --- decoder ---
    dec_hidden: int = 1024
    dec_layers: int = 28
    dec_heads: int = 16
    dec_kv_heads: int = 8
    dec_head_dim: int = 128
    dec_intermediate: int = 3072
    vocab_size: int = 151936
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    tied_embeddings: bool = True
    dec_qkv_bias: bool = False      # q25: True
    dec_qk_norm: bool = True        # q25: False

    # --- MoE (30B) ---
    is_moe: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate: int = 0
    norm_topk_prob: bool = False
    decoder_sparse_step: int = 1

    @property
    def enc_head_dim(self) -> int:
        return self.enc_d_model // self.enc_heads

    @property
    def enc_chunk_size(self) -> int:
        """Mel frames per Conv2D chunk (100)."""
        return self.enc_n_window * 2

    @property
    def enc_conv_proj_dim(self) -> int:
        """Flattened conv output feature dim fed to conv_out (480*16=7680)."""
        return self.enc_conv_hidden * 16

    @property
    def tokens_per_chunk(self) -> int:
        """Encoder tokens produced by one full 100-frame chunk (13)."""
        return conv_out_width(conv_out_width(conv_out_width(self.enc_chunk_size)))

    def window_token_size(self, n_window_infer: Optional[int] = None) -> int:
        """Attention window size in encoder tokens.

        qwen_asr_encoder.c:291-297: tokens_per_chunk * (n_window_infer // 100).
        """
        nwi = self.enc_n_window_infer if n_window_infer is None else n_window_infer
        return self.tokens_per_chunk * (nwi // self.enc_chunk_size)

    @property
    def audio_pad_token(self) -> int:
        return Q25_AUDIO_TOKEN if self.family == "q25" else TOKEN_AUDIO_PAD


def conv_out_width(w: int, kernel: int = 3, stride: int = 2, pad: int = 1) -> int:
    """Output width of one conv layer; matches the C integer arithmetic
    (qwen_asr_encoder.c:204-213): (w + 2*pad - kernel)//stride + 1."""
    return (w + 2 * pad - kernel) // stride + 1


# ---------------------------------------------------------------------------
# Hard-coded variants (qwen_asr.c:146-215, qwen25_omni.c)
# ---------------------------------------------------------------------------

QWEN3_ASR_06B = ModelConfig(
    name="qwen3-asr-0.6b", family="qwen3",
    enc_d_model=896, enc_layers=18, enc_heads=14, enc_ffn_dim=3584,
    enc_output_dim=1024,
    dec_hidden=1024, dec_layers=28, dec_heads=16, dec_kv_heads=8,
    dec_head_dim=128, dec_intermediate=3072,
)

QWEN3_ASR_17B = ModelConfig(
    name="qwen3-asr-1.7b", family="qwen3",
    enc_d_model=1024, enc_layers=24, enc_heads=16, enc_ffn_dim=4096,
    enc_output_dim=2048,
    dec_hidden=2048, dec_layers=28, dec_heads=16, dec_kv_heads=8,
    dec_head_dim=128, dec_intermediate=6144,
)

QWEN3_OMNI_30B = ModelConfig(
    name="qwen3-omni-30b", family="qwen3",
    enc_d_model=1280, enc_layers=32, enc_heads=20, enc_ffn_dim=5120,
    enc_output_dim=2048,
    dec_hidden=2048, dec_layers=48, dec_heads=32, dec_kv_heads=4,
    dec_head_dim=128, dec_intermediate=768,
    is_moe=True, num_experts=128, num_experts_per_tok=8,
    moe_intermediate=768, norm_topk_prob=True,
)

QWEN25_OMNI_7B = ModelConfig(
    name="qwen2.5-omni-7b", family="q25",
    enc_d_model=1280, enc_layers=32, enc_heads=20, enc_ffn_dim=5120,
    enc_output_dim=3584,
    dec_hidden=3584, dec_layers=28, dec_heads=28, dec_kv_heads=4,
    dec_head_dim=128, dec_intermediate=18944,
    vocab_size=Q25_VOCAB_SIZE, tied_embeddings=False,
    dec_qkv_bias=True, dec_qk_norm=False,
)


def _config_from_json(model_dir: str) -> Optional[ModelConfig]:
    """Build a ModelConfig from config.json if it has the thinker layout."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            cfg = json.load(f)
        tc = cfg.get("thinker_config", cfg)
        ac = tc["audio_config"]
        txc = tc["text_config"]
    except (KeyError, ValueError, OSError):
        return None

    num_experts = txc.get("num_experts", 0) or 0
    is_moe = num_experts > 0
    family = "q25" if str(cfg.get("model_type", "")).startswith("qwen2_5") else "qwen3"
    return ModelConfig(
        name=str(cfg.get("model_type", "custom")),
        family=family,
        enc_d_model=ac["d_model"],
        enc_layers=ac["encoder_layers"],
        enc_heads=ac["encoder_attention_heads"],
        enc_ffn_dim=ac["encoder_ffn_dim"],
        enc_output_dim=ac["output_dim"],
        enc_n_window=ac.get("n_window", 50),
        enc_n_window_infer=ac.get("n_window_infer", 800),
        enc_conv_hidden=ac.get("downsample_hidden_size", CONV_HIDDEN),
        dec_hidden=txc["hidden_size"],
        dec_layers=txc["num_hidden_layers"],
        dec_heads=txc["num_attention_heads"],
        dec_kv_heads=txc["num_key_value_heads"],
        dec_head_dim=txc["head_dim"],
        dec_intermediate=txc["intermediate_size"],
        vocab_size=txc["vocab_size"],
        rms_norm_eps=txc.get("rms_norm_eps", 1e-6),
        rope_theta=txc.get("rope_theta", 1e6),
        tied_embeddings=txc.get("tie_word_embeddings", True),
        dec_qkv_bias=txc.get("attention_bias", False),
        dec_qk_norm=txc.get("qk_norm", not txc.get("attention_bias", False)),
        is_moe=is_moe,
        num_experts=num_experts,
        num_experts_per_tok=txc.get("num_experts_per_tok", 0) or 0,
        moe_intermediate=txc.get("moe_intermediate_size", 0) or 0,
        norm_topk_prob=bool(txc.get("norm_topk_prob", False)),
        decoder_sparse_step=txc.get("decoder_sparse_step", 1) or 1,
    )


def detect_config(model_dir: str, reader=None) -> ModelConfig:
    """Detect the model variant.

    Order: (1) config.json with the official thinker layout, (2) tensor-name
    probe identical to the reference (qwen_asr.c:142-150, main.c:208-215).
    `reader` is an optional already-open safetensors reader (duck-typed:
    needs .has(name)).
    """
    cfg = _config_from_json(model_dir)
    if cfg is not None:
        return cfg

    from smolvision_tpu_torch.io.safetensors import MultiSafetensors

    close = False
    if reader is None:
        reader = MultiSafetensors(model_dir)
        close = True
    try:
        if reader.has("thinker.audio_tower.audio_bos_eos_token.weight"):
            return QWEN25_OMNI_7B
        if reader.has("thinker.audio_tower.layers.31.self_attn.q_proj.weight"):
            return QWEN3_OMNI_30B
        if reader.has("thinker.audio_tower.layers.18.self_attn.q_proj.weight"):
            return QWEN3_ASR_17B
        return QWEN3_ASR_06B
    finally:
        if close:
            reader.close()
