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
package leaves those losses to XLA too, as it does the autoencoders'.

``row_mask`` (the masked-size populations, ``parallel.vmap_meta``): a bool
(rows,) tensor, (P, rows) on a member axis, or an ``ops.nn.RowMask``. Each
term is zeroed at the masked rows with ``where`` before the sum (never a
product, so NaN padding stays inert), and an all-true mask leaves the sum's
terms and order as they are: the unmasked bits.

``members=True`` (the fold and trial populations: inputs with a leading
member axis) sums over every axis but that one, so a population step gives
one loss a member; ``beta`` (and ``vae_loss``'s ``gamma``) may then be a
(P,) tensor, and class weights stay one (classes,) vector for all members.
"""

from __future__ import annotations

import torch

from vae_los_angeles_torch.ops.nn import mask_tensor


def _sum(x, members: bool, row_mask=None):
    """The sum of ``x``, or one sum a member (every axis but the first),
    over the rows ``row_mask`` keeps (module docstring)."""
    if row_mask is not None:
        mask = mask_tensor(row_mask)
        x = torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())), x, 0.0)
    return x.sum(tuple(range(1, x.dim()))) if members else torch.sum(x)


def kl_divergence(mu, logvar, members: bool = False, row_mask=None):
    return -0.5 * _sum(1.0 + logvar - torch.square(mu) - torch.exp(logvar), members, row_mask)


def bce_with_logits_sum(logits, target, members: bool = False, row_mask=None):
    return _sum(
        torch.clamp(logits, min=0.0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits))),
        members, row_mask)


def mse_sum(pred, target, members: bool = False, row_mask=None):
    return _sum(torch.square(pred - target), members, row_mask)


def cross_entropy_sum(logits, labels, class_weights=None, members: bool = False, row_mask=None):
    """Sum over the rows of ``w[y] * -log softmax(logits)[y]`` (``w`` = 1
    without class weights); with ``members``, (P, rows, classes) logits and
    (P, rows) labels give one sum a member, the (classes,) weights shared."""
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
    if class_weights is not None:
        nll = nll * torch.as_tensor(class_weights, dtype=nll.dtype, device=nll.device)[labels]
    return _sum(nll, members, row_mask)


def vae_loss(recon_a, a, recon_b_logits, b, recon_c, site, mu, logvar, beta=1e-3, gamma=1.0,
             class_weights=None, members: bool = False, row_mask=None):
    """Tri-modal loss; ``recon_b_logits`` are pre-sigmoid DNA logits. Any
    reconstruction term may be None (with or without its target). With
    ``members`` every term is one sum a member and ``beta``, ``gamma`` may
    be (P,) tensors. Returns (total, {"recon": .., "class": .., "kld": ..})."""
    shape = mu.shape[:1] if members else ()
    recon = torch.zeros(shape, dtype=mu.dtype, device=mu.device)
    if recon_a is not None and a is not None:
        recon = recon + mse_sum(recon_a, a, members, row_mask)
    if recon_b_logits is not None and b is not None:
        recon = recon + bce_with_logits_sum(recon_b_logits, b, members, row_mask)
    class_loss = torch.zeros(shape, dtype=mu.dtype, device=mu.device)
    if recon_c is not None and site is not None:
        class_loss = cross_entropy_sum(recon_c, site, class_weights, members, row_mask)
    kld = kl_divergence(mu, logvar, members, row_mask)
    return recon + gamma * class_loss + beta * kld, {"recon": recon, "class": class_loss,
                                                     "kld": kld}


def rna2dna_loss(recon_dna_logits, dna, mu, logvar, beta=1e-3, members: bool = False,
                 row_mask=None):
    """BCE-sum + beta*KLD; returns (total, {"recon": .., "kld": ..})."""
    recon = bce_with_logits_sum(recon_dna_logits, dna, members, row_mask)
    kld = kl_divergence(mu, logvar, members, row_mask)
    return recon + beta * kld, {"recon": recon, "kld": kld}


def dna2rna_loss(recon_rna, rna, mu, logvar, beta=1e-3, members: bool = False, row_mask=None):
    """MSE-sum + beta*KLD; returns (total, {"recon": .., "kld": ..})."""
    recon = mse_sum(recon_rna, rna, members, row_mask)
    kld = kl_divergence(mu, logvar, members, row_mask)
    return recon + beta * kld, {"recon": recon, "kld": kld}


def rna2dna_ae_loss(recon_dna_logits, dna, members: bool = False, row_mask=None):
    """BCE-sum only; returns (total, {"recon": ..})."""
    recon = bce_with_logits_sum(recon_dna_logits, dna, members, row_mask)
    return recon, {"recon": recon}


def dna2rna_ae_loss(recon_rna, rna, members: bool = False, row_mask=None):
    """MSE-sum only; returns (total, {"recon": ..})."""
    recon = mse_sum(recon_rna, rna, members, row_mask)
    return recon, {"recon": recon}
