"""Directional VAEs for cross-modal imputation (counterpart of
``vae_los_angeles_tpu/models/directional_vae.py``).

  * RNA2DNAVAE: EncoderA(rna) + EncoderC(site) → mean-fused posterior → z →
    DecoderB (sigmoid head).
  * DNA2RNAVAE: EncoderB(dna) + EncoderC(site) → mean-fused posterior → z →
    DecoderA (linear head).

Either input may be None (the unmatched-cohort path imputes without a site).
``forward`` returns ``(recon, recon_logits, mu, logvar)``; for DNA2RNAVAE
``recon_logits`` is ``recon``. Serving runs the fused kernels of
``ops.kernels.fused_vae`` on the same weights; these modules are the
unfused reference and the home of the weights.

Training works on the JAX package's ``(params, state)`` trees of tensors
(the checkpoint layout and the kernels' layout): `rna2dna_vae_init` draws
them from a ``torch.Generator`` with PyTorch's default initialisations, and
`rna2dna_vae_apply` is the train- or eval-mode forward of
``vae_los_angeles_tpu/models/directional_vae.py``'s ``rna2dna_vae_apply``,
with the new BatchNorm state in its output. Its noise (the dropout mask and
the reparameterisation's eps) is injected for tests or drawn from an
explicit generator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from vae_los_angeles_torch.models.decoders import DecoderA, DecoderB, decoder_b_apply_logits
from vae_los_angeles_torch.models.encoders import (
    EncoderA,
    EncoderB,
    EncoderC,
    encoder_a_apply,
    encoder_c_apply,
)
from vae_los_angeles_torch.models.vae import fuse_posteriors, reparameterize
from vae_los_angeles_torch.ops.nn import reset_parameters
from vae_los_angeles_torch.utils.weights import jax_from_state_dict, tree_from_numpy


class _DirectionalVAE(nn.Module):
    _input_name = ""

    def _posterior(self, x, site):
        if x is None and site is None:
            raise ValueError(f"at least one of {self._input_name}/site must be provided")
        mus, logvars = [], []
        if x is not None:
            mu, lv = self._encoder()(x)
            mus.append(mu)
            logvars.append(lv)
        if site is not None:
            mu, lv = self.encoder_site(site)
            mus.append(mu)
            logvars.append(lv)
        return fuse_posteriors(mus, logvars)


class RNA2DNAVAE(_DirectionalVAE):
    _input_name = "rna"

    def __init__(self, rna_dim: int, dna_dim: int, n_sites: int, latent_dim: int,
                 embed_dim: int = 32):
        super().__init__()
        self.encoder_rna = EncoderA(rna_dim, latent_dim)
        self.encoder_site = EncoderC(n_sites, latent_dim, embed_dim)
        self.decoder_dna = DecoderB(latent_dim, dna_dim)

    def _encoder(self):
        return self.encoder_rna

    def forward(self, rna=None, site=None, *, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        mu, logvar = self._posterior(rna, site)
        z = reparameterize(mu, logvar, eps, generator)
        logits = self.decoder_dna(z)
        return torch.sigmoid(logits), logits, mu, logvar


class DNA2RNAVAE(_DirectionalVAE):
    _input_name = "dna"

    def __init__(self, rna_dim: int, dna_dim: int, n_sites: int, latent_dim: int,
                 embed_dim: int = 32):
        super().__init__()
        self.encoder_dna = EncoderB(dna_dim, latent_dim)
        self.encoder_site = EncoderC(n_sites, latent_dim, embed_dim)
        self.decoder_rna = DecoderA(latent_dim, rna_dim)

    def _encoder(self):
        return self.encoder_dna

    def forward(self, dna=None, site=None, *, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        mu, logvar = self._posterior(dna, site)
        z = reparameterize(mu, logvar, eps, generator)
        recon = self.decoder_rna(z)
        return recon, recon, mu, logvar


class DirectionalVAEOutput(NamedTuple):
    recon: torch.Tensor  # probabilities for DNA
    recon_logits: torch.Tensor
    mu: torch.Tensor
    logvar: torch.Tensor
    state: dict


def rna2dna_vae_init(generator: torch.Generator, rna_dim: int, dna_dim: int, n_sites: int,
                     latent_dim: int, embed_dim: int = 32, device=None):
    """(params, state) trees of an RNA2DNAVAE with PyTorch's default
    initialisations drawn from ``generator`` (a CPU generator), on ``device``."""
    module = reset_parameters(RNA2DNAVAE(rna_dim, dna_dim, n_sites, latent_dim, embed_dim),
                              generator)
    params, state = jax_from_state_dict(module.state_dict(), "rna2dna")
    return tree_from_numpy(params, device), tree_from_numpy(state, device)


def rna2dna_vae_apply(params, state, rna=None, site=None, *, train: bool = False,
                      eps: Optional[torch.Tensor] = None,
                      drop_mask: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> DirectionalVAEOutput:
    """RNA2DNAVAE forward on a params tree; ``eps`` and ``drop_mask`` inject
    the noise, else it is drawn from ``generator`` (on the tensors' device)."""
    if rna is None and site is None:
        raise ValueError("at least one of rna/site must be provided")
    mus, logvars, new_state = [], [], dict(state)
    if rna is not None:
        mu_r, lv_r, new_state["encoder_rna"] = encoder_a_apply(
            params["encoder_rna"], state["encoder_rna"], rna, train=train, drop_mask=drop_mask,
            generator=generator)
        mus.append(mu_r)
        logvars.append(lv_r)
    if site is not None:
        mu_s, lv_s = encoder_c_apply(params["encoder_site"], site)
        mus.append(mu_s)
        logvars.append(lv_s)
    mu, logvar = fuse_posteriors(mus, logvars)
    z = reparameterize(mu, logvar, eps, generator)
    logits = decoder_b_apply_logits(params["decoder_dna"], z)
    return DirectionalVAEOutput(torch.sigmoid(logits), logits, mu, logvar, new_state)
