"""The trainer's numerics against their JAX twins on the same numpy inputs:
train-mode BatchNorm and its running statistics, dropout's scaling, the
RNA→DNA and DNA→RNA losses, AdamW over three steps, the plateau and early-stop state
machines (exactly) and the β schedule.

Tolerances: rtol = 1e-6 for elementwise float32 work, 1e-5 for reductions
over a batch or a row (summed in another order); the state machines and β
are compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.ops import losses as port_losses
from vae_los_angeles_torch.ops import nn as port_nn
from vae_los_angeles_torch.ops import optim as port_optim
from vae_los_angeles_torch.training import engine as port_engine
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.ops import losses as jax_losses
from vae_los_angeles_tpu.ops import nn as jax_nn
from vae_los_angeles_tpu.ops import optim as jax_optim

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

RED = dict(rtol=1e-5, atol=1e-6)
T = torch.from_numpy


def test_batchnorm_train_and_running_stats_match_jax(rng):
    x = rng.normal(2.0, 3.0, size=(12, 9)).astype(np.float32)
    params = {"gamma": rng.uniform(0.5, 1.5, 9).astype(np.float32),
              "beta": rng.normal(size=9).astype(np.float32)}
    state = {"mean": rng.normal(size=9).astype(np.float32),
             "var": rng.uniform(0.5, 2, 9).astype(np.float32)}
    for train in (True, False):
        y, new = port_nn.batchnorm_apply({k: T(v) for k, v in params.items()},
                                         {k: T(v) for k, v in state.items()}, T(x), train=train)
        jy, jnew = jax_nn.batchnorm_apply(params, state, jnp.asarray(x), train=train)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **RED)
        for k in ("mean", "var"):
            np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]), **RED)
    assert port_nn.BN_MOMENTUM == jax_nn.BN_MOMENTUM and port_nn.BN_EPS == jax_nn.BN_EPS
    with pytest.raises(ValueError, match="batch size > 1"):
        port_nn.batchnorm_apply({k: T(v) for k, v in params.items()},
                                {k: T(v) for k, v in state.items()}, T(x[:1]), train=True)


def test_dropout_scales_what_it_keeps(rng):
    x = rng.normal(size=(64, 128)).astype(np.float32)
    mask = (rng.uniform(size=x.shape) < 0.9).astype(np.float32)
    got = port_nn.dropout_apply(T(x), 0.1, train=True, mask=T(mask))
    np.testing.assert_allclose(got.numpy(), np.where(mask > 0, x / np.float32(0.9), 0.0),
                               rtol=1e-6)
    assert torch.equal(port_nn.dropout_apply(T(x), 0.1, train=False), T(x))
    drawn = port_nn.dropout_apply(torch.ones(400, 500), 0.1, train=True,
                                  generator=torch.Generator().manual_seed(0))
    assert abs((drawn > 0).float().mean().item() - 0.9) < 0.005
    assert torch.allclose(drawn[drawn > 0], torch.tensor(1 / 0.9))
    # the JAX package's inverted dropout keeps the same scale
    j = jax_nn.dropout_apply(jax.random.PRNGKey(0), jnp.ones((400, 500)), 0.1, train=True)
    np.testing.assert_allclose(np.unique(np.asarray(j)), [0.0, 1 / 0.9], rtol=1e-6)


@pytest.mark.parametrize("beta", [0.0, 1e-3, 0.7])
def test_rna2dna_loss_matches_jax(rng, beta):
    logits = rng.normal(0, 3, size=(10, 23)).astype(np.float32)
    dna = rng.uniform(size=(10, 23)).astype(np.float32)
    mu = rng.normal(size=(10, 6)).astype(np.float32)
    lv = rng.normal(0, 0.5, size=(10, 6)).astype(np.float32)
    total, aux = port_losses.rna2dna_loss(T(logits), T(dna), T(mu), T(lv), beta)
    jt, jaux = jax_losses.rna2dna_loss(logits, dna, mu, lv, beta=beta)
    np.testing.assert_allclose(total.item(), float(jt), **RED)
    for k in ("recon", "kld"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), **RED)
    np.testing.assert_allclose(port_losses.kl_divergence(T(mu), T(lv)).item(),
                               float(jax_losses.kl_divergence(mu, lv)), **RED)
    np.testing.assert_allclose(port_losses.bce_with_logits_sum(T(logits), T(dna)).item(),
                               float(jax_losses.bce_with_logits_sum(logits, dna)), **RED)


@pytest.mark.parametrize("beta", [0.0, 1e-3, 0.7])
def test_dna2rna_loss_matches_jax(rng, beta):
    recon = rng.normal(0, 2, size=(10, 23)).astype(np.float32)
    rna = rng.normal(1, 2, size=(10, 23)).astype(np.float32)
    mu = rng.normal(size=(10, 6)).astype(np.float32)
    lv = rng.normal(0, 0.5, size=(10, 6)).astype(np.float32)
    total, aux = port_losses.dna2rna_loss(T(recon), T(rna), T(mu), T(lv), beta)
    jt, jaux = jax_losses.dna2rna_loss(recon, rna, mu, lv, beta=beta)
    np.testing.assert_allclose(total.item(), float(jt), **RED)
    for k in ("recon", "kld"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), **RED)
    np.testing.assert_allclose(port_losses.mse_sum(T(recon), T(rna)).item(),
                               float(jax_losses.mse_sum(recon, rna)), **RED)


def test_adamw_three_steps_match_jax(rng):
    params = {"a": {"w": rng.normal(size=(5, 4)).astype(np.float32)},
              "b": rng.normal(size=4).astype(np.float32)}
    grads = [{"a": {"w": rng.normal(size=(5, 4)).astype(np.float32)},
              "b": rng.normal(size=4).astype(np.float32)} for _ in range(3)]
    to_t = lambda tree: jax.tree.map(T, tree)  # noqa: E731
    p, st = to_t(params), port_optim.adamw_init(to_t(params))
    jp, jst = params, jax_optim.adamw_init(params)
    for g in grads:
        p, st = port_optim.adamw_update(p, to_t(g), st, 5e-3, 1e-2)
        jp, jst = jax_optim.adamw_update(jp, g, jst, 5e-3, 1e-2)
    assert int(st["step"]) == int(jst["step"]) == 3 and st["step"].dtype == torch.int32
    for got, want in ((p, jp), (st["m"], jst["m"]), (st["v"], jst["v"])):
        np.testing.assert_allclose(got["a"]["w"].numpy(), np.asarray(want["a"]["w"]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]), rtol=1e-6, atol=1e-7)
    # moments stored in bf16: the same three updates, the stored bits equal
    # JAX's (both round the fp32 update to nearest even), the params as above
    p, st = to_t(params), port_optim.adamw_init(to_t(params), "bfloat16")
    jp, jst = params, jax_optim.adamw_init(params, jnp.bfloat16)
    for g in grads:
        p, st = port_optim.adamw_update(p, to_t(g), st, 5e-3, 1e-2)
        jp, jst = jax_optim.adamw_update(jp, g, jst, 5e-3, 1e-2)
    for key in ("m", "v"):
        for got, want in ((st[key]["a"]["w"], jst[key]["a"]["w"]), (st[key]["b"], jst[key]["b"])):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                          np.asarray(want).view(np.uint16))
    np.testing.assert_allclose(p["a"]["w"].numpy(), np.asarray(jp["a"]["w"]), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="unsupported"):
        port_optim.adamw_init(to_t(params), "float16")


VAL_SEQUENCES = {
    "improving": [10.0, 9.0, 8.0, 7.0, 6.0, 5.0, 4.0, 3.0],
    "plateau": [10.0, 9.0, 9.5, 9.2, 9.0, 9.1, 9.3, 9.0, 8.9995, 9.4, 9.6, 9.7, 9.8, 9.9],
    "noisy": [5.0, 5.1, 4.9, 4.9, 4.95, 4.8, 4.81, 4.7999, 4.8, 5.0, 5.2, 4.0, 4.5, 4.5],
}


@pytest.mark.parametrize("name", sorted(VAL_SEQUENCES))
def test_plateau_and_early_stop_state_machines_match_jax_exactly(name):
    seq = np.asarray(VAL_SEQUENCES[name], np.float32)
    plateau, jplateau = port_optim.plateau_init(1e-3), jax_optim.plateau_init(1e-3)
    estop, jestop = port_optim.early_stop_init(), jax_optim.early_stop_init()
    for epoch, v in enumerate(seq):
        plateau = port_optim.plateau_step(plateau, torch.tensor(v), 0.5, 2)
        jplateau = jax_optim.plateau_step(jplateau, jnp.float32(v), 0.5, 2)
        estop, snap = port_optim.early_stop_step(estop, torch.tensor(v), epoch, 3)
        jestop, jsnap = jax_optim.early_stop_step(jestop, jnp.float32(v), epoch, 3)
        assert bool(snap) == bool(jsnap), epoch
        for got, want in ((plateau, jplateau), (estop, jestop)):
            for k in want:
                assert got[k].item() == np.asarray(want[k]).item(), (epoch, k)
                assert got[k].dtype == {np.dtype("float32"): torch.float32,
                                        np.dtype("int32"): torch.int32,
                                        np.dtype("bool"): torch.bool}[np.asarray(want[k]).dtype]


@pytest.mark.parametrize("warmup", [0, 1, 3, 50])
def test_beta_schedule_matches_the_jax_engine(warmup):
    cfg = JaxConfig(beta_warmup_epochs=warmup, beta_start=1e-3)
    hp = port_engine.hyperparams(cfg)
    for epoch in range(0, 60, 7):
        warm = jnp.float32(warmup)
        frac = jnp.where(warm > 0, jnp.float32(epoch) / jnp.maximum(warm, 1.0), 1.0)
        want = float(jnp.minimum(1.0, frac) * jnp.float32(1e-3))
        assert port_engine.beta_schedule(epoch, hp) == want, epoch


def test_hyperparams_reject_unknown_names():
    hp = port_engine.hyperparams(JaxConfig(), lr=1e-2)
    assert hp["lr"] == 1e-2 and hp["patience"] == 15
    with pytest.raises(ValueError, match="learning_rate"):
        port_engine.hyperparams(JaxConfig(), learning_rate=1e-2)
