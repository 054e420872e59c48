"""Task registry (counterpart of ``vae_los_angeles_tpu/training/tasks.py``):
binds a model family to its init / loss / predict / target for the trainer.

Every batch is the (tpm, beta, site) triple `Batch`; the task decides which
fields are inputs and which the target. Only ``rna2dna`` is ported: RNA in,
DNA methylation out, BCE-with-logits sum + β·KLD with β warming up.

The loss goes through ``ops.kernels.fused_loss.rna2dna_loss_fused``, the
trainer's loss with its closed-form backward: on the card that is the loss
kernel pair, on the CPU its plain version (``ops.losses.rna2dna_loss``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from vae_los_angeles_torch.models import directional_vae
from vae_los_angeles_torch.ops.kernels.fused_loss import rna2dna_loss_fused


class Batch(NamedTuple):
    """Rows of the cohort: tpm (n, dim_a) f32, beta (n, dim_b) f32, site (n,) i64."""

    tpm: torch.Tensor
    beta: torch.Tensor
    site: torch.Tensor

    def take(self, idx):
        return Batch(*(t.index_select(0, idx) for t in self))

    def __len__(self):
        return self.tpm.shape[0]


class Task(NamedTuple):
    name: str
    # init(generator, cfg, n_sites, device) -> (params, bn_state)
    init: Callable
    # loss(params, state, batch, beta_kl, train, generator, eps=None,
    #      drop_mask=None) -> (loss_sum, new_state)
    loss: Callable
    # predict(params, state, batch, generator) -> imputed target (eval mode)
    predict: Callable
    # target(batch) -> ground truth of the prediction
    target: Callable
    uses_kl_warmup: bool


def _rna2dna_init(generator, cfg, n_sites, device=None):
    return directional_vae.rna2dna_vae_init(
        generator, cfg.input_dim_a, cfg.input_dim_b, n_sites, cfg.latent_dim, cfg.embed_dim,
        device)


def _rna2dna_loss(params, state, batch, beta_kl, train, generator=None, eps=None,
                  drop_mask=None):
    out = directional_vae.rna2dna_vae_apply(
        params, state, rna=batch.tpm, site=batch.site, train=train, eps=eps,
        drop_mask=drop_mask, generator=generator)
    return rna2dna_loss_fused(out.recon_logits, batch.beta, out.mu, out.logvar, beta_kl), \
        out.state


def _rna2dna_predict(params, state, batch, generator=None):
    return directional_vae.rna2dna_vae_apply(
        params, state, rna=batch.tpm, site=batch.site, train=False, generator=generator).recon


TASKS = {
    "rna2dna": Task("rna2dna", _rna2dna_init, _rna2dna_loss, _rna2dna_predict,
                    lambda batch: batch.beta, True),
}


def get_task(name: str) -> Task:
    try:
        return TASKS[name]
    except KeyError:
        raise ValueError(
            f"task {name!r} is not ported yet; the port trains {sorted(TASKS)}") from None
