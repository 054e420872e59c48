"""Decoders (counterpart of ``vae_los_angeles_tpu/models/decoders.py``).

  * DecoderA (RNA): ``fc`` = Linear(latent, 128) → ReLU → Linear(128, out),
    linear output (keys ``fc.0``, ``fc.2``).
  * DecoderB (DNA): ``fc`` = Linear(latent, 256) → ReLU → Linear(256, 512)
    → ReLU → Linear(512, out) (keys ``fc.0``, ``fc.2``, ``fc.4``). It
    returns LOGITS; the caller applies the sigmoid for β-values in [0, 1],
    as the JAX package's ``decoder_b_apply_logits`` does. The reference's
    trailing Sigmoid has no parameters, so the keys are unchanged.

`decoder_b_apply_logits` is the same chain on the JAX package's parameter
tree (``fc1``/``fc2``/``fc3``), for the trainer.
"""

from __future__ import annotations

import torch
from torch import nn

from vae_los_angeles_torch.ops.nn import linear_apply


class DecoderA(nn.Module):
    def __init__(self, latent_dim: int, output_dim: int):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(latent_dim, 128), nn.ReLU(), nn.Linear(128, output_dim)
        )

    def forward(self, z):
        return self.fc(z)


class DecoderB(nn.Module):
    def __init__(self, latent_dim: int, output_dim: int):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(latent_dim, 256), nn.ReLU(),
            nn.Linear(256, 512), nn.ReLU(),
            nn.Linear(512, output_dim),
        )

    def forward(self, z):
        """Logits (pre-sigmoid)."""
        return self.fc(z)


def decoder_b_apply_logits(params, z):
    """DecoderB on a params tree: the DNA logits."""
    h = torch.relu(linear_apply(params["fc1"], z))
    h = torch.relu(linear_apply(params["fc2"], h))
    return linear_apply(params["fc3"], h)
