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
(the checkpoint layout and the kernels' layout): `rna2dna_vae_init` and
`dna2rna_vae_init` draw them from a ``torch.Generator`` with PyTorch's
default initialisations, and `rna2dna_vae_apply` and `dna2rna_vae_apply` are
the train- or eval-mode forwards of
``vae_los_angeles_tpu/models/directional_vae.py``'s functions of those names,
with the new BatchNorm state in their output. Their noise (the dropout
masks and the reparameterisation's eps) is injected for tests or drawn from
an explicit generator. `rna2dna_vae_hidden` is the RNA2DNAVAE forward up to
DecoderB's output layer, with the same draws in the same order: the trainer's
wide-head path (``training.engine``: rna2dna's kernel path at
``engine.WIDE_HEAD_MIN_DIM_B`` probes or more) trains that layer with a
kernel. ``noise_scale`` scales eps (``models.vae.reparameterize``): the
unified tasks' ``kl_on``. Every apply takes a member axis (``ops.nn``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from vae_los_angeles_torch.models.decoders import (
    DecoderA,
    DecoderB,
    decoder_a_apply,
    decoder_b_hidden,
)
from vae_los_angeles_torch.ops.nn import linear_apply
from vae_los_angeles_torch.models.encoders import (
    EncoderA,
    EncoderB,
    EncoderC,
    encoder_a_apply,
    encoder_b_apply,
    encoder_c_apply,
)
from vae_los_angeles_torch.models.vae import fuse_posteriors, init_from_module, reparameterize


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


def _init(model_cls, model_type, generator, rna_dim, dna_dim, n_sites, latent_dim, embed_dim,
          device):
    return init_from_module(model_cls(rna_dim, dna_dim, n_sites, latent_dim, embed_dim),
                            model_type, generator, device)


def rna2dna_vae_init(generator: torch.Generator, rna_dim: int, dna_dim: int, n_sites: int,
                     latent_dim: int, embed_dim: int = 32, device=None):
    """(params, state) trees of an RNA2DNAVAE with PyTorch's default
    initialisations drawn from ``generator`` (a CPU generator), on ``device``."""
    return _init(RNA2DNAVAE, "rna2dna", generator, rna_dim, dna_dim, n_sites, latent_dim,
                 embed_dim, device)


def dna2rna_vae_init(generator: torch.Generator, rna_dim: int, dna_dim: int, n_sites: int,
                     latent_dim: int, embed_dim: int = 32, device=None):
    """(params, state) trees of a DNA2RNAVAE, as `rna2dna_vae_init`."""
    return _init(DNA2RNAVAE, "dna2rna", generator, rna_dim, dna_dim, n_sites, latent_dim,
                 embed_dim, device)


def _sample(mu, logvar, eps, generator, noise_scale):
    """z; the VAE tasks' call (no ``noise_scale``) is the one they always made."""
    if noise_scale is None:
        return reparameterize(mu, logvar, eps, generator)
    return reparameterize(mu, logvar, eps, generator, noise_scale)


def rna2dna_vae_hidden(params, state, rna=None, site=None, *, train: bool = False,
                       eps: Optional[torch.Tensor] = None,
                       drop_mask: Optional[torch.Tensor] = None,
                       generator=None, noise_scale=None):
    """RNA2DNAVAE forward up to DecoderB's output layer: (h, mu, logvar,
    new_state), h the (n, 512) input of ``decoder_dna/fc3``."""
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
    z = _sample(mu, logvar, eps, generator, noise_scale)
    return decoder_b_hidden(params["decoder_dna"], z), mu, logvar, new_state


def rna2dna_vae_apply(params, state, rna=None, site=None, *, train: bool = False,
                      eps: Optional[torch.Tensor] = None,
                      drop_mask: Optional[torch.Tensor] = None,
                      generator=None, noise_scale=None) -> DirectionalVAEOutput:
    """RNA2DNAVAE forward on a params tree; ``eps`` and ``drop_mask`` inject
    the noise, else it is drawn from ``generator`` (on the tensors' device)."""
    h, mu, logvar, new_state = rna2dna_vae_hidden(params, state, rna, site, train=train, eps=eps,
                                                  drop_mask=drop_mask, generator=generator,
                                                  noise_scale=noise_scale)
    logits = linear_apply(params["decoder_dna"]["fc3"], h)
    return DirectionalVAEOutput(torch.sigmoid(logits), logits, mu, logvar, new_state)


def dna2rna_vae_apply(params, state, dna=None, site=None, *, train: bool = False,
                      eps: Optional[torch.Tensor] = None,
                      drop_mask1: Optional[torch.Tensor] = None,
                      drop_mask2: Optional[torch.Tensor] = None,
                      generator=None, noise_scale=None) -> DirectionalVAEOutput:
    """DNA2RNAVAE forward on a params tree; ``eps`` and the encoder's two
    dropout masks inject the noise, else it is drawn from ``generator``.
    ``recon_logits`` is ``recon`` (a linear head)."""
    if dna is None and site is None:
        raise ValueError("at least one of dna/site must be provided")
    mus, logvars, new_state = [], [], dict(state)
    if dna is not None:
        mu_d, lv_d, new_state["encoder_dna"] = encoder_b_apply(
            params["encoder_dna"], state["encoder_dna"], dna, train=train,
            drop_mask1=drop_mask1, drop_mask2=drop_mask2, generator=generator)
        mus.append(mu_d)
        logvars.append(lv_d)
    if site is not None:
        mu_s, lv_s = encoder_c_apply(params["encoder_site"], site)
        mus.append(mu_s)
        logvars.append(lv_s)
    mu, logvar = fuse_posteriors(mus, logvars)
    z = _sample(mu, logvar, eps, generator, noise_scale)
    recon = decoder_a_apply(params["decoder_rna"], z)
    return DirectionalVAEOutput(recon, recon, mu, logvar, new_state)
