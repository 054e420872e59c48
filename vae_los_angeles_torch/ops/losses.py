"""Loss functions of the directional trainers (counterpart of
``vae_los_angeles_tpu/ops/losses.py``), sum-reduced as in the reference:

  * ``kl_divergence`` = -0.5 * sum(1 + logvar - mu^2 - e^logvar);
  * ``bce_with_logits_sum`` = sum(max(l, 0) - l*t + log1p(e^-|l|)), BCE from
    logits (equal to sigmoid → BCE without its log(0));
  * ``mse_sum`` = sum((pred - target)^2);
  * ``rna2dna_loss`` = BCE sum + beta * KLD and ``dna2rna_loss`` = MSE sum +
    beta * KLD, each returning (total, aux).

The RNA→DNA trainer calls the fused version (``ops.kernels.fused_loss``),
whose plain version is this module's ``rna2dna_loss``. The DNA→RNA trainer
calls ``dna2rna_loss`` itself: the JAX package has no loss kernel for that
direction either. The other families' losses are not ported yet.
"""

from __future__ import annotations

import torch


def kl_divergence(mu, logvar):
    return -0.5 * torch.sum(1.0 + logvar - torch.square(mu) - torch.exp(logvar))


def bce_with_logits_sum(logits, target):
    return torch.sum(
        torch.clamp(logits, min=0.0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def mse_sum(pred, target):
    return torch.sum(torch.square(pred - target))


def rna2dna_loss(recon_dna_logits, dna, mu, logvar, beta=1e-3):
    """BCE-sum + beta*KLD; returns (total, {"recon": .., "kld": ..})."""
    recon = bce_with_logits_sum(recon_dna_logits, dna)
    kld = kl_divergence(mu, logvar)
    return recon + beta * kld, {"recon": recon, "kld": kld}


def dna2rna_loss(recon_rna, rna, mu, logvar, beta=1e-3):
    """MSE-sum + beta*KLD; returns (total, {"recon": .., "kld": ..})."""
    recon = mse_sum(recon_rna, rna)
    kld = kl_divergence(mu, logvar)
    return recon + beta * kld, {"recon": recon, "kld": kld}
