"""Encoders (counterpart of ``vae_los_angeles_tpu/models/encoders.py``).

Attribute names follow the reference's ``src/models/encoders.py``, so the
state_dict keys are the ones ``vae_los_angeles_tpu/utils/torch_import.py``
maps:

  * EncoderA (RNA): ``fc`` = Linear(in, 128) → BN → ReLU → Dropout(0.1)
    (keys ``fc.0``, ``fc.1``), heads ``fc_mu``/``fc_logvar`` 128 → latent.
  * EncoderB (DNA): ``fc`` = in → 512 → 256, each block Linear → BN → ReLU
    → Dropout(0.1) (keys ``fc.0``, ``fc.1``, ``fc.4``, ``fc.5``), heads
    256 → latent.
  * EncoderC (site): ``embedding`` = Embedding(n_sites, 32), heads
    32 → latent.

Each forward returns (mu, logvar).

The trainer's train-mode forward is functional, on the JAX package's
parameter trees (``vae_los_angeles_tpu/models/encoders.py``): `encoder_a_apply`
(Linear → BatchNorm with batch statistics → ReLU → dropout, returning the new
BatchNorm state) and `encoder_c_apply` (the site embedding's heads).
"""

from __future__ import annotations

from torch import nn

from vae_los_angeles_torch.ops.nn import batchnorm_apply, dropout_apply, linear_apply

DROPOUT_RATE = 0.1


class EncoderA(nn.Module):
    def __init__(self, input_dim: int, latent_dim: int):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(input_dim, 128), nn.BatchNorm1d(128), nn.ReLU(),
            nn.Dropout(DROPOUT_RATE),
        )
        self.fc_mu = nn.Linear(128, latent_dim)
        self.fc_logvar = nn.Linear(128, latent_dim)

    def forward(self, x):
        h = self.fc(x)
        return self.fc_mu(h), self.fc_logvar(h)


class EncoderB(nn.Module):
    def __init__(self, input_dim: int, latent_dim: int):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(input_dim, 512), nn.BatchNorm1d(512), nn.ReLU(),
            nn.Dropout(DROPOUT_RATE),
            nn.Linear(512, 256), nn.BatchNorm1d(256), nn.ReLU(),
            nn.Dropout(DROPOUT_RATE),
        )
        self.fc_mu = nn.Linear(256, latent_dim)
        self.fc_logvar = nn.Linear(256, latent_dim)

    def forward(self, x):
        h = self.fc(x.reshape(x.shape[0], -1))
        return self.fc_mu(h), self.fc_logvar(h)


class EncoderC(nn.Module):
    def __init__(self, n_sites: int, latent_dim: int, embed_dim: int = 32):
        super().__init__()
        self.embedding = nn.Embedding(n_sites, embed_dim)
        self.fc_mu = nn.Linear(embed_dim, latent_dim)
        self.fc_logvar = nn.Linear(embed_dim, latent_dim)

    def forward(self, site):
        h = self.embedding(site)
        return self.fc_mu(h), self.fc_logvar(h)


def encoder_a_apply(params, state, x, *, train: bool, drop_mask=None, generator=None):
    """EncoderA on a params tree: returns (mu, logvar, new_state). In train
    mode the dropout mask is ``drop_mask`` or drawn from ``generator``."""
    h = linear_apply(params["fc"], x)
    h, bn_s = batchnorm_apply(params["bn"], state["bn"], h, train=train)
    h = dropout_apply(h.clamp(min=0.0), DROPOUT_RATE, train=train, mask=drop_mask,
                      generator=generator)
    return linear_apply(params["mu"], h), linear_apply(params["logvar"], h), {"bn": bn_s}


def encoder_c_apply(params, site):
    """EncoderC on a params tree: (mu, logvar) of the site embedding."""
    h = params["embedding"]["table"][site]
    return linear_apply(params["mu"], h), linear_apply(params["logvar"], h)
