"""Decoders (counterpart of ``vae_los_angeles_tpu/models/decoders.py``).

  * DecoderA (RNA): ``fc`` = Linear(latent, 128) → ReLU → Linear(128, out),
    linear output (keys ``fc.0``, ``fc.2``).
  * DecoderB (DNA): ``fc`` = Linear(latent, 256) → ReLU → Linear(256, 512)
    → ReLU → Linear(512, out) (keys ``fc.0``, ``fc.2``, ``fc.4``). It
    returns LOGITS; the caller applies the sigmoid for β-values in [0, 1],
    as the JAX package's ``decoder_b_apply_logits`` does. The reference's
    trailing Sigmoid has no parameters, so the keys are unchanged.
  * DecoderC (site): ``fc`` = Linear(latent, 64) → ReLU → Linear(64,
    n_sites), the site logits (keys ``fc.0``, ``fc.2``).

`decoder_a_apply`, `decoder_b_apply_logits` and `decoder_c_apply` are the
same chains on the JAX package's parameter trees (``fc1``/``fc2``,
``fc1``/``fc2``/``fc3`` and ``fc1``/``fc2``), for the trainer;
`decoder_b_hidden` stops before DecoderB's output layer, the 512 x dim_b
layer that the wide head kernel (``ops.kernels.fused_wide``) trains.
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


class DecoderC(nn.Module):
    def __init__(self, latent_dim: int, n_sites: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(latent_dim, 64), nn.ReLU(), nn.Linear(64, n_sites))

    def forward(self, z):
        """Site logits."""
        return self.fc(z)


def decoder_a_apply(params, z):
    """DecoderA on a params tree: the RNA reconstruction (linear head)."""
    return linear_apply(params["fc2"], torch.relu(linear_apply(params["fc1"], z)))


def decoder_b_hidden(params, z):
    """DecoderB up to its output layer: the 512-wide input of ``fc3``."""
    h = torch.relu(linear_apply(params["fc1"], z))
    return torch.relu(linear_apply(params["fc2"], h))


def decoder_b_apply_logits(params, z):
    """DecoderB on a params tree: the DNA logits."""
    return linear_apply(params["fc3"], decoder_b_hidden(params, z))


def decoder_c_apply(params, z):
    """DecoderC on a params tree: the site logits."""
    return linear_apply(params["fc2"], torch.relu(linear_apply(params["fc1"], z)))
