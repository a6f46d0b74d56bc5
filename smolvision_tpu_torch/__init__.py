"""smolvision_tpu_torch — the PyTorch/CUDA port of smolvision_tpu.

Same pipeline as the JAX package, run eagerly by PyTorch on an NVIDIA
Hopper card:

  WAV -> 16 kHz mono f32 -> log-mel (128 bins) -> Conv2D stem (8x downsample)
  -> windowed bidirectional transformer encoder -> proj1/proj2 -> audio
  embeddings spliced into a chat-template prompt -> Qwen3 decoder prefill
  -> greedy decode over a KV cache -> BPE detokenize.

Drivers: one clip (runtime.engine), segmented (runtime.segment), a static
batch of segments or files (runtime.batch_segments) and continuous batching
(runtime.serving).  The attention kernels are hand-written CUDA C++ for
sm_90a (kernels/csrc/), built at first use; every other op is plain torch.
Entry points (`runtime.engine.Engine`, `cli.main`) run on the card unless
the caller asks for the CPU (`device="cpu"`, or SMOLVISION_PLATFORM=cpu for
the CLI); without a card they raise.

This package imports torch and numpy only — never jax, and nothing of
smolvision_tpu: the host modules it needs are its own copies.
"""

__version__ = "0.1.0"

from smolvision_tpu_torch.config import ModelConfig, detect_config  # noqa: F401
