"""Task registry (counterpart of ``vae_los_angeles_tpu/training/tasks.py``):
binds a model family to its init / loss / predict / target for the trainer.

Every batch is the (tpm, beta, site) triple `Batch`; the task decides which
fields are inputs and which the target. Ported so far:

  * ``rna2dna``: RNA in, DNA methylation out, BCE-with-logits sum + β·KLD
    with β warming up. The loss goes through
    ``ops.kernels.fused_loss.rna2dna_loss_fused``, the trainer's loss with its
    closed-form backward: on the card that is the loss kernel pair, on the
    CPU its plain version (``ops.losses.rna2dna_loss``).
  * ``dna2rna``: DNA methylation in, RNA out, MSE sum + β·KLD with β warming
    up, through ``ops.losses.dna2rna_loss`` (plain PyTorch, as the JAX
    engine leaves that loss to XLA).
  * ``multimodal``: the tri-modal MultiModalVAE, RNA, DNA and site in, all
    three reconstructed, MSE sum + BCE sum + γ·class-weighted CE sum + β·KLD
    with β warming up, through ``ops.losses.vae_loss`` (plain PyTorch, as in
    the JAX engine); it predicts DNA from RNA alone.
  * ``rna2dna_ae`` and ``dna2rna_ae``: the directional autoencoders, RNA
    (DNA) and site in, DNA (RNA) out, BCE-with-logits sum (MSE sum) through
    ``ops.losses.rna2dna_ae_loss`` (``dna2rna_ae_loss``), no KLD and so no
    β warm-up. They have no kernel (nor in the JAX package): the engine
    trains them on the plain path.

  * ``rna2dna_unified`` and ``dna2rna_unified``: the directional VAEs with a
    ``kl_on`` scalar in ``state`` (JAX ``training/tasks.py:213-283``), which
    scales eps and β: ``kl_on = 1`` trains bit for bit as the VAE task (eps·1
    and β·1 are exact), ``kl_on = 0`` gives z = mu and no KL term, the
    directional autoencoder as the VAE's trunk with its mu head as the
    latent. The fold populations set it a member (``state_overrides``).

Every loss takes ``gamma`` and ``class_weights``; the directional tasks
ignore them, as the JAX tasks do. Every loss and predict takes a member
axis (a (P, rows, features) batch and stacked leaves, ``ops.nn``): a loss
then returns one sum a member, the RNA→DNA loss through one call of the
loss pair a member (``rna2dna_loss_fused_members``). The VAE tasks' predict
takes an injected ``eps``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from vae_los_angeles_torch.models import directional_ae, directional_vae, vae
from vae_los_angeles_torch.ops.kernels.fused_loss import (rna2dna_loss_fused,
                                                          rna2dna_loss_fused_members)
from vae_los_angeles_torch.ops.losses import (dna2rna_ae_loss, dna2rna_loss, rna2dna_ae_loss,
                                              vae_loss)


class Batch(NamedTuple):
    """Rows of the cohort: tpm (n, dim_a) f32, beta (n, dim_b) f32, site (n,) i64."""

    tpm: torch.Tensor
    beta: torch.Tensor
    site: torch.Tensor

    def take(self, idx):
        return Batch(*(t.index_select(0, idx) for t in self))

    def __len__(self):
        return self.tpm.shape[0]


def _members(batch) -> bool:
    """Whether ``batch`` has a member axis: (P, rows, features) tables."""
    return batch.tpm.dim() == 3


class Task(NamedTuple):
    name: str
    # init(generator, cfg, n_sites, device) -> (params, bn_state)
    init: Callable
    # loss(params, state, batch, beta_kl, train, generator, *, gamma=1.0,
    #      class_weights=None, eps=None, **dropout masks) -> (loss_sum,
    #      new_state); the masks are drop_mask (rna2dna, rna2dna_ae),
    #      drop_mask1 and drop_mask2 (dna2rna, dna2rna_ae), or drop_a, drop_b1
    #      and drop_b2 (multimodal); the autoencoders take no eps
    loss: Callable
    # predict(params, state, batch, generator, **noise) -> imputed target
    # (eval mode); noise is eps for the VAE tasks
    predict: Callable
    # target(batch) -> ground truth of the prediction
    target: Callable
    uses_kl_warmup: bool


def _rna2dna_init(generator, cfg, n_sites, device=None):
    return directional_vae.rna2dna_vae_init(
        generator, cfg.input_dim_a, cfg.input_dim_b, n_sites, cfg.latent_dim, cfg.embed_dim,
        device)


def _rna2dna_loss(params, state, batch, beta_kl, train, generator=None, *, gamma=1.0,
                  class_weights=None, eps=None, drop_mask=None, noise_scale=None):
    out = directional_vae.rna2dna_vae_apply(
        params, state, rna=batch.tpm, site=batch.site, train=train, eps=eps,
        drop_mask=drop_mask, generator=generator, noise_scale=noise_scale)
    loss = rna2dna_loss_fused_members if _members(batch) else rna2dna_loss_fused
    return loss(out.recon_logits, batch.beta, out.mu, out.logvar, beta_kl), out.state


def _rna2dna_predict(params, state, batch, generator=None, *, eps=None, noise_scale=None):
    return directional_vae.rna2dna_vae_apply(
        params, state, rna=batch.tpm, site=batch.site, train=False, eps=eps,
        generator=generator, noise_scale=noise_scale).recon


def _dna2rna_init(generator, cfg, n_sites, device=None):
    return directional_vae.dna2rna_vae_init(
        generator, cfg.input_dim_a, cfg.input_dim_b, n_sites, cfg.latent_dim, cfg.embed_dim,
        device)


def _dna2rna_loss(params, state, batch, beta_kl, train, generator=None, *, gamma=1.0,
                  class_weights=None, eps=None, drop_mask1=None, drop_mask2=None,
                  noise_scale=None):
    out = directional_vae.dna2rna_vae_apply(
        params, state, dna=batch.beta, site=batch.site, train=train, eps=eps,
        drop_mask1=drop_mask1, drop_mask2=drop_mask2, generator=generator,
        noise_scale=noise_scale)
    return dna2rna_loss(out.recon, batch.tpm, out.mu, out.logvar, beta_kl,
                        members=_members(batch))[0], out.state


def _dna2rna_predict(params, state, batch, generator=None, *, eps=None, noise_scale=None):
    return directional_vae.dna2rna_vae_apply(
        params, state, dna=batch.beta, site=batch.site, train=False, eps=eps,
        generator=generator, noise_scale=noise_scale).recon


def _rna2dna_ae_init(generator, cfg, n_sites, device=None):
    return directional_ae.rna2dna_ae_init(
        generator, cfg.input_dim_a, cfg.input_dim_b, n_sites, cfg.latent_dim, cfg.embed_dim,
        device)


def _rna2dna_ae_loss(params, state, batch, beta_kl, train, generator=None, *, gamma=1.0,
                     class_weights=None, drop_mask=None):
    out = directional_ae.rna2dna_ae_apply(params, state, rna=batch.tpm, site=batch.site,
                                          train=train, drop_mask=drop_mask, generator=generator)
    return rna2dna_ae_loss(out.recon_logits, batch.beta, members=_members(batch))[0], out.state


def _rna2dna_ae_predict(params, state, batch, generator=None):
    return directional_ae.rna2dna_ae_apply(params, state, rna=batch.tpm, site=batch.site,
                                           train=False, generator=generator).recon


def _dna2rna_ae_init(generator, cfg, n_sites, device=None):
    return directional_ae.dna2rna_ae_init(
        generator, cfg.input_dim_a, cfg.input_dim_b, n_sites, cfg.latent_dim, cfg.embed_dim,
        device)


def _dna2rna_ae_loss(params, state, batch, beta_kl, train, generator=None, *, gamma=1.0,
                     class_weights=None, drop_mask1=None, drop_mask2=None):
    out = directional_ae.dna2rna_ae_apply(params, state, dna=batch.beta, site=batch.site,
                                          train=train, drop_mask1=drop_mask1,
                                          drop_mask2=drop_mask2, generator=generator)
    return dna2rna_ae_loss(out.recon, batch.tpm, members=_members(batch))[0], out.state


def _dna2rna_ae_predict(params, state, batch, generator=None):
    return directional_ae.dna2rna_ae_apply(params, state, dna=batch.beta, site=batch.site,
                                           train=False, generator=generator).recon


def _unified_init(vae_init):
    """The directional VAE's init with ``state["kl_on"] = 1``."""

    def init(generator, cfg, n_sites, device=None):
        params, state = vae_init(generator, cfg, n_sites, device)
        return params, {**state, "kl_on": torch.ones((), dtype=torch.float32, device=device)}

    return init


def _unified_loss(vae_loss_fn):
    """The directional VAE's loss with eps scaled by ``kl_on`` and β by
    ``kl_on`` (one value a member on a member axis); the new state keeps
    ``kl_on``."""

    def loss(params, state, batch, beta_kl, train, generator=None, **kw):
        kl_on = state["kl_on"]
        return vae_loss_fn(params, state, batch, beta_kl * kl_on, train, generator,
                           noise_scale=kl_on, **kw)

    return loss


def _unified_predict(vae_predict):
    def predict(params, state, batch, generator=None, *, eps=None):
        return vae_predict(params, state, batch, generator, eps=eps,
                           noise_scale=state["kl_on"])

    return predict


def _multimodal_init(generator, cfg, n_sites, device=None):
    return vae.multimodal_vae_init(generator, cfg.input_dim_a, cfg.input_dim_b, n_sites,
                                   cfg.latent_dim, cfg.embed_dim, device)


def _multimodal_loss(params, state, batch, beta_kl, train, generator=None, *, gamma=1.0,
                     class_weights=None, eps=None, drop_a=None, drop_b1=None, drop_b2=None):
    out = vae.multimodal_vae_apply(
        params, state, a=batch.tpm, b=batch.beta, site=batch.site, train=train, eps=eps,
        drop_a=drop_a, drop_b1=drop_b1, drop_b2=drop_b2, generator=generator)
    total, _ = vae_loss(out.out_a, batch.tpm, out.out_b_logits, batch.beta, out.out_c, batch.site,
                        out.mu, out.logvar, beta=beta_kl, gamma=gamma,
                        class_weights=class_weights)
    return total, out.state


def _multimodal_predict(params, state, batch, generator=None):
    """DNA imputed from RNA alone."""
    return vae.multimodal_vae_apply(params, state, a=batch.tpm, train=False,
                                    generator=generator).out_b


TASKS = {
    "rna2dna": Task("rna2dna", _rna2dna_init, _rna2dna_loss, _rna2dna_predict,
                    lambda batch: batch.beta, True),
    "dna2rna": Task("dna2rna", _dna2rna_init, _dna2rna_loss, _dna2rna_predict,
                    lambda batch: batch.tpm, True),
    "rna2dna_ae": Task("rna2dna_ae", _rna2dna_ae_init, _rna2dna_ae_loss, _rna2dna_ae_predict,
                       lambda batch: batch.beta, False),
    "dna2rna_ae": Task("dna2rna_ae", _dna2rna_ae_init, _dna2rna_ae_loss, _dna2rna_ae_predict,
                       lambda batch: batch.tpm, False),
    "multimodal": Task("multimodal", _multimodal_init, _multimodal_loss, _multimodal_predict,
                       lambda batch: batch.beta, True),
    "rna2dna_unified": Task("rna2dna_unified", _unified_init(_rna2dna_init),
                            _unified_loss(_rna2dna_loss), _unified_predict(_rna2dna_predict),
                            lambda batch: batch.beta, True),
    "dna2rna_unified": Task("dna2rna_unified", _unified_init(_dna2rna_init),
                            _unified_loss(_dna2rna_loss), _unified_predict(_dna2rna_predict),
                            lambda batch: batch.tpm, True),
}


def get_task(name: str) -> Task:
    try:
        return TASKS[name]
    except KeyError:
        raise ValueError(
            f"task {name!r} is not ported yet; the port trains {sorted(TASKS)}") from None
