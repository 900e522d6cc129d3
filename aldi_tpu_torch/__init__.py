"""PyTorch/CUDA port of ``aldi_tpu`` for NVIDIA Hopper.

Module names mirror ``aldi_tpu`` so each counterpart is easy to find. The
package imports ``torch`` and never ``jax``, ``flax`` or ``aldi_tpu``. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; without a
GPU the default raises instead of running on the CPU.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, defaulting to ``cuda``. Raises when
    CUDA is asked for (explicitly or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return dev
