"""Full float32 precision for every compute entry point.

The JAX package pins ``jax.default_matmul_precision("highest")`` on its
compute entry points (ops/gem.py, ops/wiener.py, tf/stft.py): reduced
precision products destroy the E-step reductions and the IS-NMF update
ratios. On Hopper the reduced format is TF32, which PyTorch may use for
float32 matrix products and cuDNN convolutions. ``highest_precision`` turns
it off for the duration of the call and restores the caller's settings.
"""
from __future__ import annotations

import functools

import torch


def highest_precision(fn):
    """Decorator: no TF32 in matrix products or convolutions inside fn."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev[0]
            torch.backends.cudnn.allow_tf32 = prev[1]
            torch.set_float32_matmul_precision(prev[2])
    return wrapper
