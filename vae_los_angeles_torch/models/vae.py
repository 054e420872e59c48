"""The tri-modal MultiModalVAE and the posterior helpers shared by the VAE
family (counterpart of ``vae_los_angeles_tpu/models/vae.py``).

  * MultiModalVAE: EncoderA(RNA) + EncoderB(DNA) + EncoderC(site) →
    arithmetic-mean fusion of the posteriors given → z → DecoderA (RNA,
    linear), DecoderB (DNA logits; the output is their sigmoid) and DecoderC
    (site logits). Attribute names follow the reference's ``src/models/vae.py``,
    so the state_dict keys are the ``multivae`` layout of ``utils.weights``.

Training and evaluation work on the JAX package's ``(params, state)`` trees:
`multimodal_vae_init` draws them from a ``torch.Generator`` with PyTorch's
default initialisations, and `multimodal_vae_apply` is the train- or
eval-mode forward over any of the 7 modality subsets, returning a
`MultiModalVAEOutput` with the new BatchNorm state. z is sampled in eval
mode too, as in the JAX package. Noise (eps and the three dropout masks) is
injected for tests or drawn from an explicit generator. The JAX package's
``latent_mask`` and ``row_mask`` (the padded HPO populations and the
masked-size fold populations) are not ported: they raise. The posterior
helpers take a member axis (``ops.nn``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from vae_los_angeles_torch.models.decoders import (
    DecoderA,
    DecoderB,
    DecoderC,
    decoder_a_apply,
    decoder_b_apply_logits,
    decoder_c_apply,
)
from vae_los_angeles_torch.models.encoders import (
    EncoderA,
    EncoderB,
    EncoderC,
    encoder_a_apply,
    encoder_b_apply,
    encoder_c_apply,
)
from vae_los_angeles_torch.ops.nn import draw, per_member, reset_parameters
from vae_los_angeles_torch.utils.weights import jax_from_state_dict, tree_from_numpy


def reparameterize(mu, logvar, eps: Optional[torch.Tensor] = None,
                   generator=None, noise_scale=None):
    """z = mu + eps·exp(logvar/2), eps ~ N(0, I).

    ``eps`` injects the noise (the tests hand both packages the same draw,
    and zeros give z = mu); otherwise eps is drawn from ``generator`` (a list
    of them, one a member, for a member axis: ``ops.nn.draw``), which must
    live on ``mu``'s device. ``noise_scale`` (a scalar, or (P,) for a member
    axis) scales eps: 1 gives the unscaled z bit for bit (eps·1 is exact),
    0 gives z = mu, the unified tasks' autoencoder mode."""
    if eps is None:
        eps = draw(torch.randn, mu.shape, generator, mu.device, mu.dtype)
    if noise_scale is not None:
        eps = eps * per_member(noise_scale, eps)
    return mu + eps * torch.exp(0.5 * logvar)


def fuse_posteriors(mu_list, logvar_list):
    """Arithmetic-mean fusion of per-modality posteriors (not a product of
    experts)."""
    if len(mu_list) == 1:
        return mu_list[0], logvar_list[0]
    return torch.stack(mu_list).mean(0), torch.stack(logvar_list).mean(0)


def init_from_module(module: nn.Module, model_type: str, generator: torch.Generator, device):
    """(params, state) trees of ``module`` after redrawing its weights from
    ``generator`` with PyTorch's defaults, in the JAX layout, on ``device``."""
    params, state = jax_from_state_dict(reset_parameters(module, generator).state_dict(),
                                        model_type)
    return tree_from_numpy(params, device), tree_from_numpy(state, device)


class MultiModalVAE(nn.Module):
    def __init__(self, input_dim_a: int, input_dim_b: int, n_sites: int, latent_dim: int,
                 embed_dim: int = 32):
        super().__init__()
        self.encoder_a = EncoderA(input_dim_a, latent_dim)
        self.encoder_b = EncoderB(input_dim_b, latent_dim)
        self.encoder_c = EncoderC(n_sites, latent_dim, embed_dim)
        self.decoder_a = DecoderA(latent_dim, input_dim_a)
        self.decoder_b = DecoderB(latent_dim, input_dim_b)
        self.decoder_c = DecoderC(latent_dim, n_sites)

    def forward(self, a=None, b=None, site=None, *, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """(out_a, out_b, out_c, mu, logvar); out_b is the DNA probabilities."""
        mus, logvars = [], []
        for x, enc in ((a, self.encoder_a), (b, self.encoder_b), (site, self.encoder_c)):
            if x is not None:
                mu, lv = enc(x)
                mus.append(mu)
                logvars.append(lv)
        if not mus:
            raise ValueError("at least one modality must be provided")
        mu, logvar = fuse_posteriors(mus, logvars)
        z = reparameterize(mu, logvar, eps, generator)
        return (self.decoder_a(z), torch.sigmoid(self.decoder_b(z)), self.decoder_c(z), mu,
                logvar)


class MultiModalVAEOutput(NamedTuple):
    out_a: torch.Tensor  # RNA reconstruction (linear output)
    out_b: torch.Tensor  # DNA reconstruction, probabilities in [0, 1]
    out_b_logits: torch.Tensor  # pre-sigmoid DNA logits (the training loss's input)
    out_c: torch.Tensor  # site logits
    mu: torch.Tensor
    logvar: torch.Tensor
    state: dict  # updated BatchNorm running stats


def multimodal_vae_init(generator: torch.Generator, input_dim_a: int, input_dim_b: int,
                        n_sites: int, latent_dim: int, embed_dim: int = 32, device=None):
    """(params, state) trees of a MultiModalVAE with PyTorch's default
    initialisations drawn from ``generator`` (a CPU generator), on ``device``."""
    return init_from_module(MultiModalVAE(input_dim_a, input_dim_b, n_sites, latent_dim,
                                          embed_dim), "multivae", generator, device)


def multimodal_vae_apply(params, state, a=None, b=None, site=None, *, train: bool = False,
                         eps: Optional[torch.Tensor] = None,
                         drop_a: Optional[torch.Tensor] = None,
                         drop_b1: Optional[torch.Tensor] = None,
                         drop_b2: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         latent_mask=None, row_mask=None) -> MultiModalVAEOutput:
    """Forward over any subset of (a, b, site) on a params tree. ``eps``
    (B, latent) and the dropout masks ``drop_a`` (B, 128), ``drop_b1``
    (B, 512) and ``drop_b2`` (B, 256) inject the noise; what is not injected
    is drawn from ``generator`` (on the tensors' device)."""
    if latent_mask is not None or row_mask is not None:
        raise ValueError("latent_mask and row_mask are not ported: they belong to the padded "
                         "HPO populations and the masked-size fold populations")
    if a is None and b is None and site is None:
        raise ValueError("at least one modality must be provided")
    mus, logvars, new_state = [], [], dict(state)
    if a is not None:
        mu_a, lv_a, new_state["encoder_a"] = encoder_a_apply(
            params["encoder_a"], state["encoder_a"], a, train=train, drop_mask=drop_a,
            generator=generator)
        mus.append(mu_a)
        logvars.append(lv_a)
    if b is not None:
        mu_b, lv_b, new_state["encoder_b"] = encoder_b_apply(
            params["encoder_b"], state["encoder_b"], b, train=train, drop_mask1=drop_b1,
            drop_mask2=drop_b2, generator=generator)
        mus.append(mu_b)
        logvars.append(lv_b)
    if site is not None:
        mu_c, lv_c = encoder_c_apply(params["encoder_c"], site)
        mus.append(mu_c)
        logvars.append(lv_c)
    mu, logvar = fuse_posteriors(mus, logvars)
    z = reparameterize(mu, logvar, eps, generator)
    logits_b = decoder_b_apply_logits(params["decoder_b"], z)
    return MultiModalVAEOutput(decoder_a_apply(params["decoder_a"], z), torch.sigmoid(logits_b),
                               logits_b, decoder_c_apply(params["decoder_c"], z), mu, logvar,
                               new_state)
