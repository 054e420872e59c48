"""The epoch's plain version (``ops/kernels/fused_epoch.py``) against the
JAX package's whole-epoch Pallas kernel (interpret mode) with the same
injected noise over 20 steps of 8 rows (crossing the kernel's 8-step loss
blocks, as ``tests/test_pallas_epoch.py`` does), and against a loop of the
port's train step plus ``adamw_update``.

Tolerances are the JAX test's: per-step losses rtol 1e-5; params and m
atol 2e-5, except the encoder fc bias (and the BN running mean, which moves
1:1 with it) at 5e-3: its true gradient through train-mode BatchNorm is
zero, so what is computed is fp32 cancellation noise that Adam's
normalisation turns into implementation-dependent steps; BN var atol 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.ops import optim as port_optim
from vae_los_angeles_torch.ops.kernels import fused_epoch as fe
from vae_los_angeles_torch.ops.kernels import fused_train as ft
from vae_los_angeles_torch.utils.tree import tree_map
from vae_los_angeles_torch.utils.weights import tree_from_numpy
from vae_los_angeles_tpu.models.directional_vae import rna2dna_vae_init
from vae_los_angeles_tpu.ops.pallas import fused_epoch as jfe

DIM_A, DIM_B, N_SITES, LATENT = 40, 56, 5, 8
BATCH, N_BATCHES = 8, 20
LR, WD, BETA, STEP0 = 5e-4, 1e-5, 1e-3, 3
FC_BIAS = ("encoder_rna", "fc", "b")


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    params, state = rna2dna_vae_init(jax.random.PRNGKey(0), DIM_A, DIM_B, N_SITES, LATENT)
    params, state = jax.tree.map(np.asarray, (params, state))
    n = BATCH * N_BATCHES
    d = dict(x=rng.normal(size=(n, DIM_A)).astype(np.float32),
             t=rng.uniform(0.02, 0.98, size=(n, DIM_B)).astype(np.float32),
             site=rng.integers(0, N_SITES, size=(n,)),
             eps=rng.normal(size=(n, LATENT)).astype(np.float32),
             drop=(rng.uniform(size=(n, 128)) < 0.9).astype(np.float32))
    m0 = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-3).astype(np.float32), params)
    v0 = jax.tree.map(lambda a: (rng.uniform(size=a.shape) * 1e-6).astype(np.float32), params)
    pallas = jax.block_until_ready(jfe.rna2dna_fused_epoch(
        params, m0, v0, state, d["x"], d["t"], d["site"], N_SITES, beta=BETA, lr=LR,
        weight_decay=WD, step0=STEP0, n_batches=N_BATCHES, eps_ep=d["eps"], drop_ep=d["drop"]))
    tt = {k: torch.from_numpy(v) for k, v in d.items()}
    port = fe.rna2dna_fused_epoch(
        tree_from_numpy(params), tree_from_numpy(m0), tree_from_numpy(v0),
        tree_from_numpy(state), tt["x"], tt["t"], tt["site"], N_SITES, beta=BETA, lr=LR,
        weight_decay=WD, step0=STEP0, n_batches=N_BATCHES, eps_ep=tt["eps"], drop_ep=tt["drop"])
    return params, state, m0, v0, tt, jax.tree.map(np.asarray, pallas), port


def _tol(path, tight):
    return 5e-3 if path == FC_BIAS else tight


def test_plain_epoch_matches_pallas_epoch_kernel(case):
    *_, (j_losses, j_p, j_m, j_v, j_bn), (losses, p, m, v, bn) = case
    assert losses.shape == (N_BATCHES,)
    np.testing.assert_allclose(losses.numpy(), j_losses, rtol=1e-5)
    for got, want in ((p, j_p), (m, j_m)):
        for path, w in _leaves(want):
            np.testing.assert_allclose(_at(got, path).numpy(), w, atol=_tol(path, 2e-5),
                                       err_msg=str(path))
    for path, w in _leaves(j_v):
        np.testing.assert_allclose(_at(v, path).numpy(), w, atol=1e-8, rtol=1e-3,
                                   err_msg=str(path))
    np.testing.assert_allclose(bn["encoder_rna"]["bn"]["mean"].numpy(),
                               j_bn["encoder_rna"]["bn"]["mean"], atol=5e-3)
    np.testing.assert_allclose(bn["encoder_rna"]["bn"]["var"].numpy(),
                               j_bn["encoder_rna"]["bn"]["var"], atol=2e-4)


def test_plain_epoch_equals_a_loop_of_the_step_and_adamw(case):
    params, state, m0, v0, tt, _, (losses, p, m, v, bn) = case
    p_ref, s_ref = tree_from_numpy(params), tree_from_numpy(state)
    opt = {"step": torch.tensor(STEP0, dtype=torch.int32), "m": tree_from_numpy(m0),
           "v": tree_from_numpy(v0)}
    ref_losses = []
    for b in range(N_BATCHES):
        rows = slice(b * BATCH, (b + 1) * BATCH)
        loss, grads, s_ref = ft.rna2dna_fused_train_step(
            p_ref, s_ref, tt["x"][rows], tt["t"][rows], tt["site"][rows], N_SITES, beta=BETA,
            eps=tt["eps"][rows], drop_mask=tt["drop"][rows])
        ref_losses.append(loss)
        p_ref, opt = port_optim.adamw_update(p_ref, grads, opt, LR, WD)
    assert torch.equal(torch.stack(ref_losses), losses)
    for got, want in ((p, p_ref), (m, opt["m"]), (v, opt["v"])):
        tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), got, want)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), bn, s_ref)


def test_philox_mode_matches_a_loop_of_philox_steps():
    """Without injected noise, step i draws what the train step draws at
    (seed, step i): the epoch equals a loop of those steps and AdamW."""
    rng = np.random.default_rng(5)
    params, state = jax.tree.map(np.asarray, rna2dna_vae_init(
        jax.random.PRNGKey(1), DIM_A, DIM_B, N_SITES, LATENT))
    x = torch.from_numpy(rng.normal(size=(3 * BATCH, DIM_A)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(size=(3 * BATCH, DIM_B)).astype(np.float32))
    s = torch.from_numpy(rng.integers(0, N_SITES, size=3 * BATCH))
    p0 = tree_from_numpy(params)
    zeros = tree_map(torch.zeros_like, p0)
    losses, p, *_ = fe.rna2dna_fused_epoch(p0, zeros, zeros, tree_from_numpy(state), x, t, s,
                                           N_SITES, seed=9, n_batches=3)
    p_ref, s_ref, opt = p0, tree_from_numpy(state), port_optim.adamw_init(p0)
    for b in range(3):
        rows = slice(b * BATCH, (b + 1) * BATCH)
        loss, grads, s_ref = ft.rna2dna_fused_train_step(p_ref, s_ref, x[rows], t[rows], s[rows],
                                                         N_SITES, seed=9, step=b)
        assert loss.item() == losses[b].item()
        p_ref, opt = port_optim.adamw_update(p_ref, grads, opt, 5e-4, 1e-5)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), p, p_ref)


def test_epoch_rejects_rows_that_do_not_divide(case):
    params, state, m0, v0, tt, *_ = case
    args = (tree_from_numpy(params), tree_from_numpy(m0), tree_from_numpy(v0),
            tree_from_numpy(state), tt["x"][:-1], tt["t"][:-1], tt["site"][:-1], N_SITES)
    with pytest.raises(ValueError, match="not divisible"):
        fe.rna2dna_fused_epoch(*args, n_batches=N_BATCHES)
    with pytest.raises(ValueError, match="all-or-nothing"):
        fe.rna2dna_fused_epoch(*args[:4], tt["x"], tt["t"], tt["site"], N_SITES,
                               n_batches=N_BATCHES, eps_ep=tt["eps"])
    with pytest.raises(ValueError, match="not divisible"):
        jfe.rna2dna_fused_epoch(params, m0, v0, state, jnp.asarray(tt["x"][:-1].numpy()),
                                jnp.asarray(tt["t"][:-1].numpy()), tt["site"][:-1].numpy(),
                                N_SITES, n_batches=N_BATCHES)
