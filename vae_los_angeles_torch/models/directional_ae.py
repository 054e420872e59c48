"""Directional (deterministic) autoencoders for imputation (counterpart of
``vae_los_angeles_tpu/models/directional_ae.py``).

  * RNA2DNAAE: encoder Linear(rna, 128) → BN → ReLU → Dropout(0.1) →
    Linear(128, latent); site path Embedding(n_sites, embed) →
    Linear(embed, latent); the mean of the latents given → DecoderB (sigmoid
    head). No mu/logvar.
  * DNA2RNAAE: encoder dna → 512 → 256 → latent (two Linear → BN → ReLU →
    Dropout blocks, then a Linear), the same site path → DecoderA (linear
    head). Its input is flattened to (B, -1) first.

Attribute names follow the reference's ``src/models/directional_ae.py``
(each encoder a bare Sequential), so the state_dict keys are the
``rna2dna_ae`` and ``dna2rna_ae`` layouts of ``utils.weights``. ``forward``
returns ``(recon, recon_logits, latent)``; for DNA2RNAAE ``recon_logits``
is ``recon``. Either input may be None, not both.

Training works on the JAX package's ``(params, state)`` trees
(``enc_fc1``, ``enc_bn``, ``enc_fc2``; ``enc_fc1``, ``enc_bn1``,
``enc_fc2``, ``enc_bn2``, ``enc_fc3``; ``site_embedding``,
``site_projection``, ``decoder_dna`` / ``decoder_rna``): `rna2dna_ae_init`
and `dna2rna_ae_init` draw them from a ``torch.Generator`` with PyTorch's
default initialisations, and `rna2dna_ae_apply` and `dna2rna_ae_apply` are
the train- or eval-mode forwards, with the new BatchNorm state in their
`DirectionalAEOutput`. Their dropout masks (``drop_mask`` (B, 128);
``drop_mask1`` (B, 512) and ``drop_mask2`` (B, 256)) are injected for tests
or drawn from an explicit generator. The JAX package has no kernel for
these models: they train on the plain path. Every apply takes a member axis
(``ops.nn``) and a ``row_mask`` for its BatchNorms (the masked-size
populations).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from vae_los_angeles_torch.models.decoders import (
    DecoderA,
    DecoderB,
    decoder_a_apply,
    decoder_b_apply_logits,
)
from vae_los_angeles_torch.models.vae import init_from_module
from vae_los_angeles_torch.ops.nn import (batchnorm_apply, dropout_apply, embedding_lookup,
                                         flatten_rows, linear_apply)

DROPOUT_RATE = 0.1


def fuse_latents(latents):
    """The mean of the latents given (one is returned as it is)."""
    if len(latents) == 1:
        return latents[0]
    return torch.stack(latents).mean(0)


def _block(d_in, d_out):
    return [nn.Linear(d_in, d_out), nn.BatchNorm1d(d_out), nn.ReLU(), nn.Dropout(DROPOUT_RATE)]


class _DirectionalAE(nn.Module):
    _input_name = ""

    def __init__(self, n_sites: int, latent_dim: int, embed_dim: int):
        super().__init__()
        self.site_embedding = nn.Embedding(n_sites, embed_dim)
        self.site_projection = nn.Linear(embed_dim, latent_dim)

    def _latent(self, encoder, x, site):
        if x is None and site is None:
            raise ValueError(f"at least one of {self._input_name}/site must be provided")
        latents = []
        if x is not None:
            latents.append(encoder(x))
        if site is not None:
            latents.append(self.site_projection(self.site_embedding(site)))
        return fuse_latents(latents)


class RNA2DNAAE(_DirectionalAE):
    _input_name = "rna"

    def __init__(self, rna_dim: int, dna_dim: int, n_sites: int, latent_dim: int,
                 embed_dim: int = 32):
        super().__init__(n_sites, latent_dim, embed_dim)
        self.encoder_rna = nn.Sequential(*_block(rna_dim, 128), nn.Linear(128, latent_dim))
        self.decoder_dna = DecoderB(latent_dim, dna_dim)

    def forward(self, rna=None, site=None):
        latent = self._latent(self.encoder_rna, rna, site)
        logits = self.decoder_dna(latent)
        return torch.sigmoid(logits), logits, latent


class DNA2RNAAE(_DirectionalAE):
    _input_name = "dna"

    def __init__(self, rna_dim: int, dna_dim: int, n_sites: int, latent_dim: int,
                 embed_dim: int = 32):
        super().__init__(n_sites, latent_dim, embed_dim)
        self.encoder_dna = nn.Sequential(*_block(dna_dim, 512), *_block(512, 256),
                                         nn.Linear(256, latent_dim))
        self.decoder_rna = DecoderA(latent_dim, rna_dim)

    def forward(self, dna=None, site=None):
        x = None if dna is None else dna.reshape(dna.shape[0], -1)
        latent = self._latent(self.encoder_dna, x, site)
        recon = self.decoder_rna(latent)
        return recon, recon, latent


class DirectionalAEOutput(NamedTuple):
    recon: torch.Tensor  # probabilities for DNA
    recon_logits: torch.Tensor
    latent: torch.Tensor
    state: dict


def rna2dna_ae_init(generator: torch.Generator, rna_dim: int, dna_dim: int, n_sites: int,
                    latent_dim: int, embed_dim: int = 32, device=None):
    """(params, state) trees of an RNA2DNAAE with PyTorch's default
    initialisations drawn from ``generator`` (a CPU generator), on ``device``."""
    return init_from_module(RNA2DNAAE(rna_dim, dna_dim, n_sites, latent_dim, embed_dim),
                            "rna2dna_ae", generator, device)


def dna2rna_ae_init(generator: torch.Generator, rna_dim: int, dna_dim: int, n_sites: int,
                    latent_dim: int, embed_dim: int = 32, device=None):
    """(params, state) trees of a DNA2RNAAE, as `rna2dna_ae_init`."""
    return init_from_module(DNA2RNAAE(rna_dim, dna_dim, n_sites, latent_dim, embed_dim),
                            "dna2rna_ae", generator, device)


def _bn_block(params, state, new_state, fc, bn, h, train, mask, generator, row_mask):
    """Linear → BatchNorm (its new state into ``new_state``) → ReLU → dropout."""
    h = linear_apply(params[fc], h)
    h, new_state[bn] = batchnorm_apply(params[bn], state[bn], h, train=train,
                                       row_mask=row_mask)
    return dropout_apply(h.clamp(min=0.0), DROPOUT_RATE, train=train, mask=mask,
                         generator=generator)


def _latent(params, encoded, site, input_name):
    if encoded is None and site is None:
        raise ValueError(f"at least one of {input_name}/site must be provided")
    latents = [] if encoded is None else [encoded]
    if site is not None:
        latents.append(linear_apply(params["site_projection"],
                                    embedding_lookup(params["site_embedding"]["table"], site)))
    return fuse_latents(latents)


def rna2dna_ae_apply(params, state, rna=None, site=None, *, train: bool = False,
                     drop_mask: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     row_mask=None) -> DirectionalAEOutput:
    """RNA2DNAAE forward on a params tree; ``drop_mask`` injects the dropout
    mask, else it is drawn from ``generator`` (on the tensors' device)."""
    new_state, encoded = dict(state), None
    if rna is not None:
        h = _bn_block(params, state, new_state, "enc_fc1", "enc_bn", rna, train, drop_mask,
                      generator, row_mask)
        encoded = linear_apply(params["enc_fc2"], h)
    latent = _latent(params, encoded, site, "rna")
    logits = decoder_b_apply_logits(params["decoder_dna"], latent)
    return DirectionalAEOutput(torch.sigmoid(logits), logits, latent, new_state)


def dna2rna_ae_apply(params, state, dna=None, site=None, *, train: bool = False,
                     drop_mask1: Optional[torch.Tensor] = None,
                     drop_mask2: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     row_mask=None) -> DirectionalAEOutput:
    """DNA2RNAAE forward on a params tree; the encoder's two dropout masks
    inject the noise, else they are drawn from ``generator``, block 1's
    first. ``recon_logits`` is ``recon`` (a linear head)."""
    new_state, encoded = dict(state), None
    if dna is not None:
        h = _bn_block(params, state, new_state, "enc_fc1", "enc_bn1",
                      flatten_rows(dna, params["enc_fc1"]["w"]), train, drop_mask1, generator,
                      row_mask)
        h = _bn_block(params, state, new_state, "enc_fc2", "enc_bn2", h, train, drop_mask2,
                      generator, row_mask)
        encoded = linear_apply(params["enc_fc3"], h)
    latent = _latent(params, encoded, site, "dna")
    recon = decoder_a_apply(params["decoder_rna"], latent)
    return DirectionalAEOutput(recon, recon, latent, new_state)
