"""Device resolution and matmul precision for the PyTorch port.

Entry points take `device=` (default "cuda").  A request for CUDA on a
machine without a usable GPU raises: the port never falls back to the CPU
on its own; callers that want the CPU (the tests) ask for it.

Matmul precision: the JAX package runs every product at
`Precision.HIGHEST`; the port's counterpart is full-precision float32 and
complex64 matmuls on the card.  TF32 would cap every residual near 1e-3
relative, so importing the package turns it off for CUDA matmuls
(`torch.backends.cuda.matmul.allow_tf32 = False`) and sets float32
matmul precision to "highest".  No convolution is used, so cuDNN's
setting is left alone.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "feast_tpu_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices name the same one ("cuda" is the current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """numpy array / tensor / scalar -> tensor of `dtype` on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
