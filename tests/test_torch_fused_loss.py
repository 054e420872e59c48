"""The loss Function's plain version (``ops/kernels/fused_loss.py``) against
the JAX package's ``rna2dna_loss_fused`` (Pallas, interpret mode) and its
``jax.grad``, with a traced β: value rtol 1e-5 (a sum over B·1211 terms in
another order), gradients rtol 1e-5, atol 1e-7 (closed form, elementwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.ops import losses as port_losses
from vae_los_angeles_torch.ops.kernels import fused_loss as fl
from vae_los_angeles_tpu.ops.pallas.fused_loss import rna2dna_loss_fused as j_fused

GRAD = dict(rtol=1e-5, atol=1e-7)


def _inputs(batch, width=56, latent=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 3, size=(batch, width)).astype(np.float32),
            rng.uniform(size=(batch, width)).astype(np.float32),
            rng.normal(size=(batch, latent)).astype(np.float32),
            rng.normal(0, 0.5, size=(batch, latent)).astype(np.float32))


@pytest.mark.parametrize("batch", [3, 32])
def test_value_and_gradients_match_the_pallas_custom_vjp(batch):
    logits, dna, mu, lv = _inputs(batch)
    beta = np.float32(2e-3)

    def j_loss(l, m, v, b):
        return j_fused(l, jnp.asarray(dna), m, v, b) * 1.7

    # one jitted program, waited for: the interpret-mode kernels call back into
    # Python while they run, and JAX work dispatched meanwhile can deadlock
    j_val, j_grads = jax.block_until_ready(jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1, 2, 3)))(jnp.asarray(logits), jnp.asarray(mu), jnp.asarray(lv),
                                       jnp.float32(beta)))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (logits, mu, lv)]
    b = torch.tensor(float(beta), requires_grad=True)
    val = fl.rna2dna_loss_fused(t[0], torch.from_numpy(dna), t[1], t[2], b) * 1.7
    grads = torch.autograd.grad(val, (*t, b))
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5)
    for g, jg in zip(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD)


def test_plain_forward_is_the_loss_module_and_dna_gets_no_gradient():
    logits, dna, mu, lv = (torch.from_numpy(a) for a in _inputs(8, seed=1))
    want, _ = port_losses.rna2dna_loss(logits, dna, mu, lv, 1e-3)
    assert fl.rna2dna_loss_fused(logits, dna, mu, lv, 1e-3).item() == want.item()
    dna.requires_grad_(True)
    logits.requires_grad_(True)
    (g_dna,) = torch.autograd.grad(fl.rna2dna_loss_fused(logits, dna, mu, lv, 1e-3), (dna,))
    assert torch.equal(g_dna, torch.zeros_like(dna))  # as the JAX custom_vjp returns
    before = dict(fl.launches)
    fl.rna2dna_loss_fused(logits, dna, mu, lv)
    assert fl.launches == before  # CPU tensors: the plain version, no launch


def test_wrapper_rejects_what_the_kernels_do_not_take():
    logits, dna, mu, lv = (torch.from_numpy(a) for a in _inputs(4))
    with pytest.raises(TypeError):
        fl.rna2dna_loss_fused(logits.double(), dna, mu, lv)
    with pytest.raises(ValueError):
        fl.rna2dna_loss_fused(logits, dna[:, :-1], mu, lv)
    with pytest.raises(ValueError):
        fl.rna2dna_loss_fused(logits, dna, mu, lv[:, :-1])
    with pytest.raises(ValueError):
        fl.rna2dna_loss_fused(logits.t().contiguous().t(), dna, mu, lv)
    with pytest.raises(ValueError):
        fl.rna2dna_loss_fused(logits, dna, mu, lv, torch.zeros(2))
