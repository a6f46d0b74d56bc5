"""Device choice for the port's entry points.

The card is the default: `resolve_device(None)` is `cuda`, and it raises
when no card is present instead of continuing on the CPU.  The CPU runs
only when the caller names it (`device="cpu"`; the CLI maps
SMOLVISION_PLATFORM=cpu to that).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(SMOLVISION_PLATFORM=cpu for the CLI) to run on the CPU")
        # f32 matmuls and the conv stem stay full f32 on the card, as on the
        # CPU and in the JAX package: cuDNN convolutions default to TF32
        # (~3 decimal digits), which would drift the encoder by ~1e-3.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
