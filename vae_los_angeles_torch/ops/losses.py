"""Loss functions of the directional trainers (counterpart of
``vae_los_angeles_tpu/ops/losses.py``), sum-reduced as in the reference:

  * ``kl_divergence`` = -0.5 * sum(1 + logvar - mu^2 - e^logvar);
  * ``bce_with_logits_sum`` = sum(max(l, 0) - l*t + log1p(e^-|l|)), BCE from
    logits (equal to sigmoid → BCE without its log(0));
  * ``mse_sum`` = sum((pred - target)^2);
  * ``cross_entropy_sum`` = sum of w[y] * nll over the rows (torch's
    ``F.cross_entropy(weight=w, reduction="sum")``: not renormalised by the
    weights);
  * ``rna2dna_loss`` = BCE sum + beta * KLD and ``dna2rna_loss`` = MSE sum +
    beta * KLD, each returning (total, aux);
  * ``vae_loss`` = MSE sum (RNA) + BCE sum (DNA) + gamma * weighted CE sum
    (site) + beta * KLD, the tri-modal loss, returning (total, aux);
  * ``rna2dna_ae_loss`` = BCE sum and ``dna2rna_ae_loss`` = MSE sum, the
    directional autoencoders' losses (no KLD), each returning (total, aux).

The RNA→DNA trainer calls the fused version (``ops.kernels.fused_loss``),
whose plain version is this module's ``rna2dna_loss``. The DNA→RNA and
tri-modal trainers call ``dna2rna_loss`` and ``vae_loss`` themselves: the JAX
package leaves those losses to XLA too, as it does the autoencoders'. The
``row_mask`` variants are not ported.

``members=True`` (the fold and trial populations: inputs with a leading
member axis) sums over every axis but that one, so a population step gives
one loss a member; ``beta`` (and ``vae_loss``'s ``gamma``) may then be a
(P,) tensor, and class weights stay one (classes,) vector for all members.
"""

from __future__ import annotations

import torch


def _sum(x, members: bool):
    """The sum of ``x``, or one sum a member (every axis but the first)."""
    return x.sum(tuple(range(1, x.dim()))) if members else torch.sum(x)


def kl_divergence(mu, logvar, members: bool = False):
    return -0.5 * _sum(1.0 + logvar - torch.square(mu) - torch.exp(logvar), members)


def bce_with_logits_sum(logits, target, members: bool = False):
    return _sum(
        torch.clamp(logits, min=0.0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits))),
        members)


def mse_sum(pred, target, members: bool = False):
    return _sum(torch.square(pred - target), members)


def cross_entropy_sum(logits, labels, class_weights=None, members: bool = False):
    """Sum over the rows of ``w[y] * -log softmax(logits)[y]`` (``w`` = 1
    without class weights); with ``members``, (P, rows, classes) logits and
    (P, rows) labels give one sum a member, the (classes,) weights shared."""
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
    if class_weights is not None:
        nll = nll * torch.as_tensor(class_weights, dtype=nll.dtype, device=nll.device)[labels]
    return _sum(nll, members)


def vae_loss(recon_a, a, recon_b_logits, b, recon_c, site, mu, logvar, beta=1e-3, gamma=1.0,
             class_weights=None, members: bool = False):
    """Tri-modal loss; ``recon_b_logits`` are pre-sigmoid DNA logits. Any
    reconstruction term may be None (with or without its target). With
    ``members`` every term is one sum a member and ``beta``, ``gamma`` may
    be (P,) tensors. Returns (total, {"recon": .., "class": .., "kld": ..})."""
    shape = mu.shape[:1] if members else ()
    recon = torch.zeros(shape, dtype=mu.dtype, device=mu.device)
    if recon_a is not None and a is not None:
        recon = recon + mse_sum(recon_a, a, members)
    if recon_b_logits is not None and b is not None:
        recon = recon + bce_with_logits_sum(recon_b_logits, b, members)
    class_loss = torch.zeros(shape, dtype=mu.dtype, device=mu.device)
    if recon_c is not None and site is not None:
        class_loss = cross_entropy_sum(recon_c, site, class_weights, members)
    kld = kl_divergence(mu, logvar, members)
    return recon + gamma * class_loss + beta * kld, {"recon": recon, "class": class_loss,
                                                     "kld": kld}


def rna2dna_loss(recon_dna_logits, dna, mu, logvar, beta=1e-3, members: bool = False):
    """BCE-sum + beta*KLD; returns (total, {"recon": .., "kld": ..})."""
    recon = bce_with_logits_sum(recon_dna_logits, dna, members)
    kld = kl_divergence(mu, logvar, members)
    return recon + beta * kld, {"recon": recon, "kld": kld}


def dna2rna_loss(recon_rna, rna, mu, logvar, beta=1e-3, members: bool = False):
    """MSE-sum + beta*KLD; returns (total, {"recon": .., "kld": ..})."""
    recon = mse_sum(recon_rna, rna, members)
    kld = kl_divergence(mu, logvar, members)
    return recon + beta * kld, {"recon": recon, "kld": kld}


def rna2dna_ae_loss(recon_dna_logits, dna, members: bool = False):
    """BCE-sum only; returns (total, {"recon": ..})."""
    recon = bce_with_logits_sum(recon_dna_logits, dna, members)
    return recon, {"recon": recon}


def dna2rna_ae_loss(recon_rna, rna, members: bool = False):
    """MSE-sum only; returns (total, {"recon": ..})."""
    recon = mse_sum(recon_rna, rna, members)
    return recon, {"recon": recon}
