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
BatchNorm state), `encoder_b_apply` (two such blocks, returning both BatchNorm
states) and `encoder_c_apply` (the site embedding's heads). Each takes a 2-D
batch with the model's leaves or a 3-D (members, rows, features) batch with
stacked leaves and a list of generators, one a member (``ops.nn``), and a
``row_mask`` for the BatchNorms' train-mode statistics (the masked-size
populations, ``ops.nn.batchnorm_apply``).
"""

from __future__ import annotations

from torch import nn

from vae_los_angeles_torch.ops.nn import (batchnorm_apply, dropout_apply, embedding_lookup,
                                         flatten_rows, linear_apply)

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


def encoder_a_apply(params, state, x, *, train: bool, drop_mask=None, generator=None,
                    row_mask=None):
    """EncoderA on a params tree: returns (mu, logvar, new_state). In train
    mode the dropout mask is ``drop_mask`` or drawn from ``generator``."""
    h = linear_apply(params["fc"], x)
    h, bn_s = batchnorm_apply(params["bn"], state["bn"], h, train=train, row_mask=row_mask)
    h = dropout_apply(h.clamp(min=0.0), DROPOUT_RATE, train=train, mask=drop_mask,
                      generator=generator)
    return linear_apply(params["mu"], h), linear_apply(params["logvar"], h), {"bn": bn_s}


def encoder_b_apply(params, state, x, *, train: bool, drop_mask1=None, drop_mask2=None,
                    generator=None, row_mask=None):
    """EncoderB on a params tree: returns (mu, logvar, new_state) with the
    new state of both BatchNorms. In train mode the dropout masks (B, 512)
    and (B, 256) are ``drop_mask1``/``drop_mask2`` or drawn from
    ``generator``, block 1's first."""
    h = linear_apply(params["fc1"], flatten_rows(x, params["fc1"]["w"]))
    h, bn1 = batchnorm_apply(params["bn1"], state["bn1"], h, train=train, row_mask=row_mask)
    h = dropout_apply(h.clamp(min=0.0), DROPOUT_RATE, train=train, mask=drop_mask1,
                      generator=generator)
    h = linear_apply(params["fc2"], h)
    h, bn2 = batchnorm_apply(params["bn2"], state["bn2"], h, train=train, row_mask=row_mask)
    h = dropout_apply(h.clamp(min=0.0), DROPOUT_RATE, train=train, mask=drop_mask2,
                      generator=generator)
    return (linear_apply(params["mu"], h), linear_apply(params["logvar"], h),
            {"bn1": bn1, "bn2": bn2})


def encoder_c_apply(params, site):
    """EncoderC on a params tree: (mu, logvar) of the site embedding."""
    h = embedding_lookup(params["embedding"]["table"], site)
    return linear_apply(params["mu"], h), linear_apply(params["logvar"], h)
