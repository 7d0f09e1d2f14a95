"""Where the reference rounds: the stated precision and the control's.

``bf16`` is the configuration's recipe: a weight product casts both
operands to bfloat16 and returns bfloat16. ``fp8`` is the control, the
next precision down: both operands are first rounded to float8 e4m3 with
a scale per row of the activations and per output column of the weights
(the finest scaling an fp8 product takes, so the control is the most
accurate fp8 a later change could ship), then multiplied as ``bf16``.
The rounding passes gradients straight through.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    tf = t.float()
    scale = tf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    q = (tf / scale).to(torch.float8_e4m3fn).float() * scale
    return tf + (q - tf).detach()


class Precision:
    def __init__(self, name: str = "bf16"):
        if name not in ("bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.act = torch.bfloat16

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for activations (..., k) and a weight (k, n)."""
        if self.name == "fp8":
            x = _fp8_round(x, dim=-1)
            w = _fp8_round(w, dim=0)
        return torch.matmul(x.to(self.act), w.to(self.act))
