"""The HPO slice of the port against the JAX package at small widths: the
trial sampler and rungs, AdamW with one weight decay a member, the
per-member tri-modal loss, the latent mask (``multimodal_padded``) and its
padded-population carry, the trial population
(``parallel.vmap_meta.fit_trials``) against single runs, against its own
continuation and against the JAX population, ``evaluation.hpo`` (the
population search with rung pruning, the optuna mode through a fake
module, ``main`` and its checkpoint) and the training CLI's
``--replicates``.

Tolerances: ``LAYER`` (1e-5) where the port and JAX compute the same fp32
expression in other orders; a member against its single run at rtol 2e-4
(the JAX package's population-against-sequential tolerance,
``tests/test_parallel.py``), with the epochs, the best epoch, β and the rates
equal; the mask's contract (an all-ones mask, masked dims, masked slices,
the padded carry) and rung continuation bit for bit. At these widths the
CPU's batched and single products give the same bits, so a trial equals
its single run exactly here; the rtol 2e-4 leaves room for the card's
batched products. The JAX population draws threefry noise and inits from
keys, the port from torch generators, so the two agree statistically: over
24 epochs of 160 rows a trial's final validation loss moved by up to 7.6%
across the port's seeds 0-5 and up to 9.4% across JAX's keys 0-2, and a
port seed and a JAX key differed by up to 8.5% for the same trial (the pair
the test runs: 3.2%, 1.6%, 2.7%). So the final losses are held at rtol
0.10, the seed spread, with β and the rates equal and each loss at most a
fifth of its first epoch's. One JAX population runs in this file
(``jax_trials``, a module-scoped fixture, ~17 s of CPU compile and run).

Run alone: ``python -m pytest tests/test_torch_hpo.py -q -p xdist -n 6``
(see CHANGES.md for its wall time)."""

import runpy
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.data.splits import train_val_indices
from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
from vae_los_angeles_torch.evaluation import hpo as port_hpo
from vae_los_angeles_torch.models import vae as port_vae
from vae_los_angeles_torch.ops import losses as port_losses
from vae_los_angeles_torch.ops import optim as port_optim
from vae_los_angeles_torch.parallel import vmap_meta as port_vm
from vae_los_angeles_torch.parallel.sharding import make_mesh
from vae_los_angeles_torch.training import checkpoint as port_ckpt
from vae_los_angeles_torch.training import cli as port_cli
from vae_los_angeles_torch.training import engine as port_engine
from vae_los_angeles_torch.training import tasks as port_tasks
from vae_los_angeles_torch.training.cli import compute_class_weights, run_training
from vae_los_angeles_torch.training.tasks import Batch
from vae_los_angeles_torch.utils.tree import tree_leaves, tree_map
from vae_los_angeles_torch.utils.weights import (jax_from_state_dict, state_dict_from_jax,
                                                 tree_from_numpy, tree_to_numpy)
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.data.dataset import MultiModalArrays
from vae_los_angeles_tpu.evaluation import hpo as jax_hpo
from vae_los_angeles_tpu.models import vae as jax_vae
from vae_los_angeles_tpu.ops import losses as jax_losses
from vae_los_angeles_tpu.parallel import vmap_meta as jax_vm
from vae_los_angeles_tpu.training import checkpoint as jax_ckpt

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, EMBED, BATCH = 21, 29, 5, 6, 16, 16
DIMS = dict(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT, embed_dim=EMBED,
            batch_size=BATCH)
LAYER = dict(atol=1e-5, rtol=1e-5)
MEMBER = dict(rtol=2e-4, atol=0.0)
POP = {"lr": np.array([1e-3, 5e-4, 2e-3], np.float32),
       "weight_decay": np.array([1e-5, 1e-4, 1e-6], np.float32),
       "beta_start": np.array([1e-3, 5e-3, 2e-4], np.float32),
       "gamma": np.array([1.0, 2.0, 0.7], np.float32)}
JAX_EPOCHS = 24


@pytest.fixture(scope="module")
def cohort():
    return generate_synthetic_arrays(n_samples=200, dim_a=DIM_A, dim_b=DIM_B, n_sites=N_SITES,
                                     seed=3)


@pytest.fixture(scope="module")
def split(cohort):
    """The 80/20 split of the cohort (the CLIs' split) and its balanced class
    weights."""
    tr_idx, va_idx = train_val_indices(len(cohort[0]), 0.2, 42)
    tr, va = (tuple(x[i] for x in cohort) for i in (tr_idx, va_idx))
    return tr, va, compute_class_weights(tr[2], N_SITES)


def _single(task, cfg, tr, va, seed, i, cw, epochs, pop=POP, **kw):
    hp = port_engine.hyperparams(cfg, **{k: float(v[i]) for k, v in pop.items()})
    return port_engine.fit(task, cfg, tr, va, seed, N_SITES, num_epochs=epochs,
                           class_weights=cw, hp=hp, device="cpu", **kw)


def _masked_single(task, cfg, tr, va, seed, **kw):
    """``engine.fit`` as a trial of a masked population (the default) trains:
    the tables padded to their row buckets, the true sizes masked."""
    def pad(table):
        n = port_vm.bucket_rows(len(table[0]))
        return tuple(np.concatenate([x, np.zeros((n - len(x),) + x.shape[1:], x.dtype)])
                     for x in table)

    return port_engine.fit(task, cfg, pad(tr), pad(va), seed, N_SITES, masked_sizes=True,
                           true_sizes=(len(tr[0]), len(va[0])), device="cpu", **kw)


def _check_member(res, single):
    assert res.epochs_ran == single.epochs_ran
    assert res.best_epoch == single.best_epoch and res.stopped == single.stopped
    np.testing.assert_array_equal(res.lrs, single.lrs)
    np.testing.assert_array_equal(res.betas, single.betas)
    np.testing.assert_allclose(res.train_losses, single.train_losses, **MEMBER)
    np.testing.assert_allclose(res.val_losses, single.val_losses, **MEMBER)
    for (name, a), (_, b) in zip(port_engine._named_leaves(res.params),
                                 port_engine._named_leaves(single.params)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-5, msg=name)


# --- sampling, rungs, seeds --------------------------------------------------

@pytest.mark.parametrize("n,seed,bucket", [(5, 0, 4), (13, 7, 4), (8, 3, 1), (6, 11, 3),
                                           (1, 2, 4)])
def test_sample_trials_equal_jax(n, seed, bucket):
    assert port_hpo.SEARCH_SPACE == jax_hpo.SEARCH_SPACE
    assert port_hpo.sample_trials(n, seed, bucket) == jax_hpo.sample_trials(n, seed, bucket)


@pytest.mark.parametrize("epochs,rungs", [(10, 3), (4, 2), (3, 5), (0, 2), (7, 1)])
def test_rung_lengths_equal_jax(epochs, rungs):
    assert port_hpo._rung_lengths(epochs, rungs) == jax_hpo._rung_lengths(epochs, rungs)


def test_trial_seeds_follow_the_global_index():
    assert port_hpo._trial_seeds(5, range(4)) == port_vm.member_seeds(5, 4)
    assert port_hpo._trial_seeds(5, [3, 1]) == [port_vm.member_seeds(5, 4)[i] for i in (3, 1)]


# --- the numerics a member ---------------------------------------------------

def test_adamw_with_one_decay_a_member_matches_each_member_bit_for_bit():
    g = torch.Generator().manual_seed(2)
    trees = [{"w": torch.randn(6, 4, generator=g), "b": torch.randn(4, generator=g)}
             for _ in range(3)]
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in t.items()} for t in trees]
    states = [{**port_optim.adamw_init(t),
               "m": {k: torch.randn(v.shape, generator=g) for k, v in t.items()},
               "v": {k: torch.rand(v.shape, generator=g) for k, v in t.items()}} for t in trees]
    lrs, wds = torch.tensor(POP["lr"]), torch.tensor(POP["weight_decay"])
    pop_state = {"step": states[0]["step"], "m": port_vm._stack([s["m"] for s in states]),
                 "v": port_vm._stack([s["v"] for s in states])}
    new, new_state = port_optim.adamw_update(port_vm._stack(trees), port_vm._stack(grads), pop_state, lrs, wds)
    for i in range(3):
        want, want_state = port_optim.adamw_update(trees[i], grads[i], states[i],
                                                   float(lrs[i]), float(wds[i]))
        for k in want:
            assert torch.equal(new[k][i], want[k]), k
            assert torch.equal(new_state["m"][k][i], want_state["m"][k])
            assert torch.equal(new_state["v"][k][i], want_state["v"][k])
    with pytest.raises(ValueError, match="needs an lr a member"):
        port_optim.adamw_update(trees[0], grads[0], states[0], 1e-3, wds)


def test_hyperparams_population_and_beta_schedule():
    cfg = PortConfig(**DIMS, beta_warmup_epochs=4)
    hp = port_engine.hyperparams(cfg, **POP)
    for k, v in POP.items():
        assert hp[k].dtype == np.float32 and np.array_equal(hp[k], v)
    assert isinstance(hp["patience"], int)
    for epoch in (0, 1, 3, 7):
        betas = port_engine.beta_schedule(epoch, hp)
        assert betas.dtype == np.float32
        for i, b in enumerate(betas):
            single = port_engine.hyperparams(cfg, beta_start=float(POP["beta_start"][i]))
            assert np.float32(port_engine.beta_schedule(epoch, single)) == b
    with pytest.raises(ValueError, match="one value a member"):
        port_engine.hyperparams(cfg, patience=np.array([1, 2]))
    with pytest.raises(ValueError, match="fit_trials"):
        port_engine.fit("multimodal", cfg, *[None] * 2, 0, N_SITES, hp=hp, device="cpu")


def test_vae_loss_with_a_member_axis_against_jax():
    rng = np.random.default_rng(4)
    p_n, rows = 3, 9
    a = rng.normal(size=(p_n, rows, DIM_A)).astype(np.float32)
    ra = rng.normal(size=a.shape).astype(np.float32)
    b = rng.random((p_n, rows, DIM_B)).astype(np.float32)
    rb = (3 * rng.normal(size=b.shape)).astype(np.float32)
    site = rng.integers(0, N_SITES, (p_n, rows))
    rc = rng.normal(size=(p_n, rows, N_SITES)).astype(np.float32)
    mu = rng.normal(size=(p_n, rows, LATENT)).astype(np.float32)
    lv = (0.5 * rng.normal(size=mu.shape)).astype(np.float32)
    cw = rng.uniform(0.5, 2.0, N_SITES).astype(np.float32)
    beta, gamma = POP["beta_start"], POP["gamma"]
    t = torch.as_tensor
    total, aux = port_losses.vae_loss(t(ra), t(a), t(rb), t(b), t(rc), t(site), t(mu), t(lv),
                                      beta=t(beta), gamma=t(gamma), class_weights=cw,
                                      members=True)
    assert total.shape == (p_n,)
    for i in range(p_n):
        want, want_aux = jax_losses.vae_loss(ra[i], a[i], rb[i], b[i], rc[i], site[i], mu[i],
                                             lv[i], beta=beta[i], gamma=gamma[i],
                                             class_weights=jnp.asarray(cw))
        np.testing.assert_allclose(total[i].item(), float(want), **LAYER)
        for k in want_aux:
            np.testing.assert_allclose(aux[k][i].item(), float(want_aux[k]), **LAYER)
        ce = port_losses.cross_entropy_sum(t(rc[i]), t(site[i]), cw)
        assert torch.equal(ce, aux["class"][i])


def _jax_padded_population(p_n, cfg_kw, keys_seed=4):
    cfg = JaxConfig(**cfg_kw)
    keys = jax.random.split(jax.random.PRNGKey(keys_seed), p_n)
    init = jax.vmap(lambda k: jax_vae.multimodal_vae_init(
        k, cfg.input_dim_a, cfg.input_dim_b, N_SITES, cfg.latent_dim, cfg.embed_dim))
    return init(keys)


# one compile for both cases (op by op, the vmapped apply takes ~12 s here)
_jax_masked_apply = jax.jit(jax.vmap(lambda p, s, k, m, a, b, c: jax_vae.multimodal_vae_apply(
    p, s, k, a=a, b=b, site=c, train=False, latent_mask=m)))


@pytest.mark.parametrize("train_bn", [False, True], ids=["running-stats", "perturbed-stats"])
def test_masked_member_axis_apply_against_jax(train_bn):
    """3 members with their own latent masks (widths 6, 2, 4 of 6), every
    modality on (the embedding and the posterior fusion on a 3-D batch),
    eval mode, JAX's weights moved by ``tree_from_numpy`` and JAX's own eps:
    the port's member-axis apply against ``jax.vmap`` of JAX's apply."""
    p_n, rows = 3, 7
    params, state = _jax_padded_population(p_n, DIMS)
    if train_bn:
        state = jax.tree.map(lambda x: x + 0.3 * jax.random.uniform(jax.random.PRNGKey(9),
                                                                    x.shape), state)
    masks = np.zeros((p_n, LATENT), np.float32)
    for j, width in enumerate((6, 2, 4)):
        masks[j, :width] = 1.0
    rng = np.random.default_rng(5)
    tpm = rng.normal(size=(p_n, rows, DIM_A)).astype(np.float32)
    beta = rng.random((p_n, rows, DIM_B)).astype(np.float32)
    site = rng.integers(0, N_SITES, size=(p_n, rows))
    keys = jax.random.split(jax.random.PRNGKey(8), p_n)
    want = _jax_masked_apply(params, state, keys, jnp.asarray(masks), jnp.asarray(tpm),
                             jnp.asarray(beta), jnp.asarray(site))
    eps = torch.as_tensor(np.stack([np.asarray(jax.random.normal(jax.random.split(k, 3)[2],
                                                                 (rows, LATENT)))
                                    for k in keys]))
    params, state = jax.tree.map(np.asarray, (params, state))
    got = port_vae.multimodal_vae_apply(
        tree_from_numpy(params), tree_from_numpy(state), a=torch.as_tensor(tpm),
        b=torch.as_tensor(beta), site=torch.as_tensor(site), train=False, eps=eps,
        latent_mask=torch.as_tensor(masks))
    for name in ("out_a", "out_b", "out_b_logits", "out_c", "mu", "logvar"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **LAYER)
    for j, width in enumerate((6, 2, 4)):
        assert not got.mu[j, :, width:].any() and not got.logvar[j, :, width:].any()


# --- the latent mask's contract (tests/test_hpo_padded.py:71-180) -------------

def _masked_slices(params, k, member=None):
    """The parameter slices a width-k mask makes inert: the mu/logvar head
    columns [k:] of the three encoders and the fc1 rows [k:] of the three
    decoders (``w`` is (in, out)); member ``member`` of stacked leaves."""
    pick = (lambda t: t) if member is None else (lambda t: t[member])
    out = {}
    for enc in ("encoder_a", "encoder_b", "encoder_c"):
        for head in ("mu", "logvar"):
            out[f"{enc}.{head}.w"] = pick(params[enc][head]["w"])[:, k:]
            out[f"{enc}.{head}.b"] = pick(params[enc][head]["b"])[k:]
    for dec in ("decoder_a", "decoder_b", "decoder_c"):
        out[f"{dec}.fc1.w"] = pick(params[dec]["fc1"]["w"])[k:, :]
    return out


def _live_slices(params, k, member=None):
    pick = (lambda t: t) if member is None else (lambda t: t[member])
    out = {}
    for enc in ("encoder_a", "encoder_b", "encoder_c"):
        for head in ("mu", "logvar"):
            out[f"{enc}.{head}.w"] = pick(params[enc][head]["w"])[:, :k]
            out[f"{enc}.{head}.b"] = pick(params[enc][head]["b"])[:k]
    for dec in ("decoder_a", "decoder_b", "decoder_c"):
        out[f"{dec}.fc1.w"] = pick(params[dec]["fc1"]["w"])[:k, :]
    return out


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_all_ones_mask_bit_identical_to_unmasked(split, compute_dtype):
    tr, va, cw = split
    cfg = PortConfig(**DIMS, compute_dtype=compute_dtype)
    p0, s0 = port_tasks.get_task("multimodal").init(torch.Generator().manual_seed(5), cfg,
                                                   N_SITES)
    pp, sp = port_tasks.get_task("multimodal_padded").init(torch.Generator().manual_seed(5),
                                                          cfg, N_SITES)
    for (name, a), (_, b) in zip(port_engine._named_leaves(p0), port_engine._named_leaves(pp)):
        assert torch.equal(a, b), name
    assert set(sp) == set(s0) | {"latent_mask"} and torch.equal(sp["latent_mask"],
                                                               torch.ones(LATENT))
    plain, padded = (port_engine.fit(task, cfg, tr, va, 5, N_SITES, num_epochs=3,
                                     class_weights=cw, init_params=p, init_state=s,
                                     device="cpu")
                     for task, p, s in (("multimodal", p0, s0), ("multimodal_padded", pp, sp)))
    np.testing.assert_array_equal(plain.train_losses, padded.train_losses)
    np.testing.assert_array_equal(plain.val_losses, padded.val_losses)
    for (name, a), (_, b) in zip(port_engine._named_leaves(plain.params),
                                 port_engine._named_leaves(padded.params)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("members", [False, True], ids=["single", "member-axis"])
def test_masked_dims_exact_zero_kl_and_gradient(split, members):
    """Masked posterior dims are exactly 0 (so the KL term of a dim,
    −½(1 + 0 − 0 − e⁰), is exactly 0) and every masked slice gets exactly 0
    gradient through the whole tri-modal loss; on the member axis, two
    members with masks of widths 3 and 5."""
    tr, _, cw = split
    cfg = PortConfig(**DIMS)
    task = port_tasks.get_task("multimodal_padded")
    widths = (3, 5) if members else (3,)
    inits = [task.init(torch.Generator().manual_seed(9 + j), cfg, N_SITES)
             for j in range(len(widths))]
    masks = torch.zeros(len(widths), LATENT)
    for j, width in enumerate(widths):
        masks[j, :width] = 1.0
    batch = port_engine._as_batch(tuple(x[:32] for x in tr), "cpu")
    gens = lambda seed: [torch.Generator().manual_seed(seed + j)  # noqa: E731
                         for j in range(len(widths))]
    if members:
        params, state = port_vm._stack([p for p, _ in inits]), port_vm._stack([s for _, s in inits])
        state["latent_mask"] = masks
        batch = Batch(*(torch.stack([t] * 2) for t in batch))
        beta, noise = torch.tensor([1e-3, 2e-3]), gens
    else:
        (params, state), beta = inits[0], 1e-3
        state["latent_mask"] = masks[0]
        noise = lambda seed: gens(seed)[0]  # noqa: E731
    out = port_vae.multimodal_vae_apply(params, state, a=batch.tpm, b=batch.beta,
                                        site=batch.site, train=True, generator=noise(1),
                                        latent_mask=state["latent_mask"])
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = task.loss(leaves, state, batch, beta, True, noise(1), gamma=1.0,
                        class_weights=cw)
    flat = iter(torch.autograd.grad(loss.sum(), tree_leaves(leaves)))
    grads = tree_map(lambda _: next(flat), leaves)
    for j, width in enumerate(widths):
        member = j if members else None
        mu, lv = (out.mu[j], out.logvar[j]) if members else (out.mu, out.logvar)
        assert not mu[:, width:].any() and not lv[:, width:].any()
        assert port_losses.kl_divergence(mu[:, width:], lv[:, width:]).item() == 0.0
        for name, g in _masked_slices(grads, width, member).items():
            assert not g.any(), f"nonzero gradient in masked slice {name}"
        live = _live_slices(grads, width, member)
        assert all(g.abs().max() > 0 for g in live.values())


def test_masked_param_slices_are_trajectory_inert(split):
    """Two padded fits whose masked slices differ train bit-identical loss
    rows and live slices, through AdamW, the plateau and the best snapshot
    (decoupled weight decay still moves the masked slices themselves)."""
    tr, va, cw = split
    k, cfg = 3, PortConfig(**DIMS)
    params_a, state = port_tasks.get_task("multimodal_padded").init(
        torch.Generator().manual_seed(7), cfg, N_SITES)
    state["latent_mask"] = torch.tensor([1.0] * k + [0.0] * (LATENT - k))
    params_b = tree_from_numpy(tree_to_numpy(params_a))
    for enc in ("encoder_a", "encoder_b", "encoder_c"):
        for head in ("mu", "logvar"):
            params_b[enc][head]["w"][:, k:] = params_b[enc][head]["w"][:, k:] * 3.0 + 0.5
            params_b[enc][head]["b"][k:] -= 2.0
    for dec in ("decoder_a", "decoder_b", "decoder_c"):
        params_b[dec]["fc1"]["w"][k:, :] = params_b[dec]["fc1"]["w"][k:, :] * -5.0 + 1.0
    fits = [port_engine.fit("multimodal_padded", cfg, tr, va, 7, N_SITES, num_epochs=4,
                            class_weights=cw, init_params=p, init_state=state, device="cpu")
            for p in (params_a, params_b)]
    np.testing.assert_array_equal(fits[0].train_losses, fits[1].train_losses)
    np.testing.assert_array_equal(fits[0].val_losses, fits[1].val_losses)
    live0, live1 = (_live_slices(f.params, k) for f in fits)
    for name in live0:
        assert torch.equal(live0[name], live1[name]), f"live slice {name} diverged"
    assert not torch.equal(fits[0].params["decoder_a"]["fc1"]["w"][k:],
                           fits[1].params["decoder_a"]["fc1"]["w"][k:])


def test_padded_carry_equals_jax_from_its_padded_init():
    """JAX's padded population init, moved across: the port's `_pad_latents`
    gives JAX's ``_padded_carry`` masks and rescaled decoder layers (params
    and best snapshot) bit for bit; the port's own `_padded_carry` bounds a
    padded trial's layers at 1/√true_width and keeps a full-width trial's."""
    cfg = JaxConfig(**DIMS)
    latents = [LATENT, 3, 5]
    keys = jax_hpo._trial_keys(0, range(3))
    lrs = np.full(3, 1e-3, np.float32)
    init = jax.device_get(jax_vm._vmapped_init("multimodal_padded", cfg, N_SITES)(
        jnp.asarray(keys), jnp.asarray(lrs)))
    want = jax.device_get(jax_hpo._padded_carry(cfg, N_SITES, keys, lrs, latents))
    got = port_hpo._pad_latents(tree_from_numpy(init), LATENT, latents)
    for tree in ("state", "best"):
        state = got[tree] if tree == "state" else got["best"]["state"]
        ref = want[tree] if tree == "state" else want["best"]["state"]
        np.testing.assert_array_equal(state["latent_mask"].numpy(), ref["latent_mask"])
    for dec in ("decoder_a", "decoder_b", "decoder_c"):
        for leaf in ("w", "b"):
            for g, w in ((got["params"], want["params"]),
                         (got["best"]["params"], want["best"]["params"])):
                np.testing.assert_array_equal(g[dec]["fc1"][leaf].numpy(), w[dec]["fc1"][leaf])
    np.testing.assert_array_equal(got["params"]["encoder_a"]["mu"]["w"].numpy(),
                                  want["params"]["encoder_a"]["mu"]["w"])

    port_cfg = PortConfig(**DIMS)
    seeds = port_hpo._trial_seeds(0, range(3))
    carry = port_hpo._padded_carry(port_cfg, N_SITES, seeds, lrs, latents, "cpu")
    ref, _ = port_tasks.get_task("multimodal").init(torch.Generator().manual_seed(seeds[0]),
                                                   port_cfg, N_SITES)
    for dec in ("decoder_a", "decoder_b", "decoder_c"):
        assert torch.equal(carry["params"][dec]["fc1"]["w"][0], ref[dec]["fc1"]["w"])
        for j in (1, 2):
            bound = 1.0 / np.sqrt(latents[j])
            w = carry["params"][dec]["fc1"]["w"][j].abs().max().item()
            assert bound * 0.8 < w <= bound * (1 + 1e-6)
        assert torch.equal(carry["best"]["params"][dec]["fc1"]["w"],
                           carry["params"][dec]["fc1"]["w"])
    assert torch.equal(carry["best"]["state"]["latent_mask"], carry["state"]["latent_mask"])
    assert carry["state"]["latent_mask"].sum(1).tolist() == latents


def test_padded_layout_across_the_numpy_bridge(split):
    """``multimodal_padded``'s weights and a padded population's carry
    across the state_dict and numpy bridges both ways; a population
    continued from the numpy carry trains as from the tensors."""
    tr, va, cw = split
    cfg = PortConfig(**DIMS)
    params, state = port_tasks.get_task("multimodal_padded").init(
        torch.Generator().manual_seed(1), cfg, N_SITES)
    state["latent_mask"] = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    sd = state_dict_from_jax(params, state, "multimodal_padded")
    back_p, back_s = jax_from_state_dict(sd, "multimodal_padded")
    np.testing.assert_array_equal(back_s["latent_mask"], state["latent_mask"].numpy())
    assert back_s.keys() == state.keys()
    module = port_vae.MultiModalVAE(DIM_A, DIM_B, N_SITES, LATENT, EMBED)
    module.load_state_dict({k: v for k, v in sd.items() if k != "latent_mask"}, strict=True)
    seeds = port_hpo._trial_seeds(0, range(2))
    carry = port_hpo._padded_carry(cfg, N_SITES, seeds, POP["lr"][:2], [3, 6], "cpu")
    as_numpy = tree_to_numpy(carry)
    assert isinstance(as_numpy["best"]["state"]["latent_mask"], np.ndarray)
    pop = {k: v[:2] for k, v in POP.items()}
    runs = [port_vm.fit_trials("multimodal_padded", cfg, tr, va, 0, N_SITES, pop,
                               num_epochs=2, class_weights=cw, carry0=c, seeds=seeds,
                               device="cpu")
            for c in (carry, as_numpy)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a.val_losses, b.val_losses)


# --- the trial population ----------------------------------------------------

@pytest.mark.parametrize("task", ["multimodal", "multimodal_padded", "rna2dna"])
def test_each_trial_is_its_single_run(split, task):
    """Three trials with their own lr, weight decay, β and γ (class weights
    shared), a patience of 2, so that the plateau cuts a rate or a trial
    stops: each trial against ``engine.fit`` at its seed with its
    hyperparameters."""
    tr, va, cw = split
    cfg = PortConfig(**DIMS, patience=2, lr_scheduler_patience=0, beta_warmup_epochs=3)
    pop = {**POP, "lr": np.array([1e-3, 5e-4, 2e-2], np.float32)}
    results = port_vm.fit_trials(task, cfg, tr, va, 3, N_SITES, pop, num_epochs=6,
                                 class_weights=cw, mask_sizes=False, device="cpu")
    seeds = port_vm.member_seeds(3, 3)
    for i, res in enumerate(results):
        _check_member(res, _single(task, cfg, tr, va, seeds[i], i, cw, 6, pop=pop))
    assert len({tuple(r.betas) for r in results}) == 3


def test_two_rung_continuation_equals_the_uninterrupted_population(split):
    tr, va, cw = split
    cfg = PortConfig(**DIMS)
    seeds = port_vm.member_seeds(3, 3)
    full = port_vm.fit_trials("multimodal", cfg, tr, va, 3, N_SITES, POP, num_epochs=4,
                              class_weights=cw, device="cpu")
    first = port_vm.fit_trials("multimodal", cfg, tr, va, 3, N_SITES, POP, num_epochs=2,
                               class_weights=cw, seeds=seeds, device="cpu")
    keep = [2, 0]
    rest = port_vm.fit_trials("multimodal", cfg, tr, va, 3, N_SITES,
                              {k: v[keep] for k, v in POP.items()}, num_epochs=2,
                              class_weights=cw, carry0=[first[j].carry for j in keep],
                              start_epoch=2, seeds=[seeds[j] for j in keep], device="cpu")
    for res, j in zip(rest, keep):
        np.testing.assert_array_equal(res.val_losses, full[j].val_losses[2:])
        np.testing.assert_array_equal(res.train_losses, full[j].train_losses[2:])
        np.testing.assert_array_equal(res.betas, full[j].betas[2:])
        assert res.best_val_loss == full[j].best_val_loss
        assert res.best_epoch == full[j].best_epoch
        assert int(res.carry["opt"]["step"]) == int(full[j].carry["opt"]["step"])
        for (name, a), (_, b) in zip(port_engine._named_leaves(res.params),
                                     port_engine._named_leaves(full[j].params)):
            assert torch.equal(a, b), name


def test_fit_trials_refusals(split):
    tr, va, cw = split
    cfg = PortConfig(**DIMS)
    first = port_vm.fit_trials("multimodal", cfg, tr, va, 0, N_SITES, POP, num_epochs=1,
                               device="cpu")
    with pytest.raises(ValueError, match="requires explicit per-trial `seeds`"):
        port_vm.fit_trials("multimodal", cfg, tr, va, 0, N_SITES, POP, num_epochs=1,
                           carry0=[r.carry for r in first], start_epoch=1, device="cpu")
    with pytest.raises(ValueError, match="requires explicit per-trial `seeds`"):
        port_vm.fit_trials("multimodal", cfg, tr, va, 0, N_SITES, POP, start_epoch=1,
                           device="cpu")
    # masked sizes train (the default): the same trials as the explicit flag
    masked = port_vm.fit_trials("multimodal", cfg, tr, va, 0, N_SITES, POP, num_epochs=1,
                                mask_sizes=True, device="cpu")
    for a, b in zip(first, masked):
        np.testing.assert_array_equal(a.val_losses, b.val_losses)
    # the mesh refusal is gone: a mesh of one device trains the plain population
    meshed = port_vm.fit_trials("multimodal", cfg, tr, va, 0, N_SITES, POP, num_epochs=1,
                                mesh=make_mesh(), device="cpu")
    for a, b in zip(first, meshed):
        np.testing.assert_array_equal(a.val_losses, b.val_losses)
    with pytest.raises(ValueError, match="hp_population keys"):
        port_vm.fit_trials("multimodal", cfg, tr, va, 0, N_SITES, {"patience": [1]},
                           device="cpu")
    with pytest.raises(ValueError, match="lengths"):
        port_vm.fit_trials("multimodal", cfg, tr, va, 0, N_SITES,
                           {"lr": POP["lr"], "gamma": POP["gamma"][:2]}, device="cpu")
    # Adafactor trains a trial population
    ada = port_vm.fit_trials("multimodal", cfg.replace(optimizer="adafactor"), tr, va, 0,
                             N_SITES, POP, num_epochs=1, device="cpu")
    assert all(np.isfinite(r.val_losses[0]) and "vr" in r.carry["opt"] for r in ada)
    with pytest.raises(ValueError, match="no training batches"):
        port_vm.fit_trials("multimodal", cfg, tuple(x[:10] for x in tr), va, 0, N_SITES, POP,
                           device="cpu")


@pytest.fixture(scope="module")
def jax_trials(split):
    """The JAX trial population: 3 trials x 24 epochs (exact sizes)."""
    tr, va, cw = split
    arrays = lambda t: MultiModalArrays(*(jnp.asarray(x) for x in t))  # noqa: E731
    res = jax_vm.fit_trials("multimodal", JaxConfig(**DIMS), arrays(tr), arrays(va),
                            jax.random.PRNGKey(0), N_SITES, POP, num_epochs=JAX_EPOCHS,
                            class_weights=cw, mask_sizes=False)
    return jax.device_get(res)


def test_trial_losses_agree_with_the_jax_population(split, jax_trials):
    tr, va, cw = split
    got = port_vm.fit_trials("multimodal", PortConfig(**DIMS), tr, va, 0, N_SITES, POP,
                             num_epochs=JAX_EPOCHS, class_weights=cw, mask_sizes=False,
                             device="cpu")
    for i, g in enumerate(got):
        assert g.epochs_ran == JAX_EPOCHS
        np.testing.assert_array_equal(g.betas, jax_trials.betas[i])
        np.testing.assert_array_equal(g.lrs, jax_trials.lrs[i])
        np.testing.assert_allclose(g.val_losses[-1], jax_trials.val_losses[i, -1], rtol=0.10)
        assert g.val_losses[-1] < 0.2 * g.val_losses[0]


# --- the search --------------------------------------------------------------

TRIALS = [dict(latent_dim=5, embed_dim=4, learning_rate=1e-3, weight_decay=1e-5,
               beta_start=1e-3, gamma=1.0),
          dict(latent_dim=7, embed_dim=8, learning_rate=3e-4, weight_decay=1e-6,
               beta_start=5e-4, gamma=2.0)]


def test_pad_shapes_singleton_buckets_equal_unpadded(split):
    """Every bucket a singleton: an all-ones mask at the trial's own width
    and a rescale of exactly 1, so the values are the unpadded path's bits."""
    tr, va, cw = split
    runs = [port_hpo.run_vmapped(PortConfig(**DIMS), TRIALS, tr, va, N_SITES, cw, 3, seed=0,
                                 pad_shapes=pad, device="cpu") for pad in (False, True)]
    for values, pruned in runs:
        assert (pruned == -1).all() and np.isfinite(values).all()
    np.testing.assert_array_equal(runs[0][0], runs[1][0])


@pytest.mark.parametrize("pad_shapes", [False, True])
def test_run_vmapped_prunes_by_the_median_rule(split, monkeypatch, pad_shapes):
    """Four trials in one bucket, two rungs: after the first, the trials
    strictly worse than the median leave (a NaN one always), the others
    continue from their carries with their own seeds, and each survivor's
    value is its uninterrupted single run's."""
    tr, va, cw = split
    trials = [dict(TRIALS[0], latent_dim=ld, learning_rate=lr)
              for ld, lr in ((3, 1e-3), (5, 2e-3), (5, 3e-9), (4, 8e-4))]
    if not pad_shapes:
        trials = [dict(t, latent_dim=5) for t in trials]
    calls, real = [], port_vm.fit_trials

    def spy(*a, **k):
        calls.append((len(a[6]["lr"]), k["start_epoch"], k["seeds"]))
        out = real(*a, **k)
        if k["start_epoch"] == 0:  # trial 1 diverges at the first rung
            out[1] = out[1]._replace(best_val_loss=float("nan"))
        return out

    monkeypatch.setattr(port_hpo.vmap_meta, "fit_trials", spy)
    values, pruned = port_hpo.run_vmapped(PortConfig(**DIMS), trials, tr, va, N_SITES, cw, 4,
                                          seed=1, prune_rungs=2, pad_shapes=pad_shapes,
                                          device="cpu")
    seeds = port_hpo._trial_seeds(1, range(4))
    assert calls[0] == (4, 0, seeds)
    survivors = [i for i in range(4) if pruned[i] == -1]
    assert pruned[1] == 2 and pruned[2] == 2 and len(survivors) == 2
    assert calls[1] == (2, 2, [seeds[i] for i in survivors])
    if not pad_shapes:
        cfg = PortConfig(**DIMS).replace(latent_dim=5, embed_dim=4, patience=10**6)
        for i in survivors:
            single = _masked_single("multimodal", cfg, tr, va, seeds[i], num_epochs=4,
                                    class_weights=cw, hp=port_hpo._trial_hp(cfg, trials[i]))
            np.testing.assert_allclose(values[i], single.best_val_loss, **MEMBER)


def test_run_vmapped_timeout_between_rungs_and_buckets(split, monkeypatch):
    tr, va, cw = split
    ticks = iter([0.0, 0.0])  # the start, the first bucket's check; then 10 s later
    monkeypatch.setattr(port_hpo, "time", types.SimpleNamespace(
        monotonic=lambda: next(ticks, 10.0)))
    values, pruned = port_hpo.run_vmapped(PortConfig(**DIMS), TRIALS, tr, va, N_SITES, cw, 4,
                                          timeout=5.0, prune_rungs=2, device="cpu")
    # the first bucket ran its first rung only (2 epochs), the second never started
    assert np.isfinite(values[0]) and values[1] == np.inf and (pruned == -1).all()
    first = port_vm.fit_trials("multimodal", PortConfig(**DIMS).replace(
        latent_dim=5, embed_dim=4, patience=10**6), tr, va, 0, N_SITES,
        {k: np.asarray([TRIALS[0][n]], np.float32) for k, n in port_hpo.FIT_KEYS.items()},
        num_epochs=2, class_weights=cw, seeds=port_hpo._trial_seeds(0, [0]), device="cpu")
    assert values[0] == first[0].best_val_loss


def _fake_optuna(monkeypatch, prune_odd=True):
    class TrialPruned(Exception):
        pass

    class FakeTrial:
        """Suggests the low end of each range; odd trials ask to be pruned."""

        def __init__(self, number):
            self.number, self.reports = number, []

        def suggest_int(self, name, lo, hi):
            return lo

        def suggest_float(self, name, lo, hi, log=False):
            return lo

        def suggest_categorical(self, name, choices):
            return choices[0]

        def report(self, value, step):
            self.reports.append((step, value))

        def should_prune(self):
            return prune_odd and self.number % 2 == 1

    class FakeStudy:
        def __init__(self):
            self.trials, self.values = [], []

        def optimize(self, objective, n_trials, timeout):
            for i in range(n_trials):
                trial = FakeTrial(i)
                self.trials.append(trial)
                try:
                    self.values.append(objective(trial))
                except TrialPruned:
                    self.values.append(None)

        @property
        def best_params(self):
            return {"latent_dim": 10, "learning_rate": 1e-5, "weight_decay": 1e-6,
                    "beta_start": 1e-4, "gamma": 0.5, "embed_dim": 16}

        @property
        def best_value(self):
            return min(v for v in self.values if v is not None)

    fake = types.ModuleType("optuna")
    fake.TrialPruned = TrialPruned
    fake.create_study = lambda direction, pruner=None: FakeStudy()
    monkeypatch.setitem(sys.modules, "optuna", fake)


def test_optuna_mode_segmented_pruning(split, monkeypatch):
    """Mirror of ``tests/test_misc.py::test_optuna_mode_segmented_pruning``:
    a trial trains in segments continued from the carry (the same run as one
    segment, bit for bit), and a pruned trial's later segments never run."""
    tr, va, cw = split
    _fake_optuna(monkeypatch)
    fit_calls, real_fit = [], port_engine.fit

    def spy(*a, **k):
        fit_calls.append((k.get("num_epochs"), k.get("start_epoch", 0)))
        return real_fit(*a, **k)

    monkeypatch.setattr(port_hpo.engine, "fit", spy)
    cfg = PortConfig(**DIMS)
    study = port_hpo.run_optuna(cfg, 2, None, tr, va, N_SITES, None, num_epochs=4, seed=0,
                                prune_rungs=2, device="cpu")
    assert fit_calls == [(2, 0), (2, 2), (2, 0)]
    assert study.values[1] is None and len(study.trials[1].reports) == 1
    assert [s for s, _ in study.trials[0].reports] == [0, 1, 2, 3]
    full = real_fit("multimodal", cfg.replace(latent_dim=10, embed_dim=16, patience=10**6),
                    tr, va, 0, N_SITES, num_epochs=4,
                    hp=port_engine.hyperparams(cfg, lr=1e-5, weight_decay=1e-6,
                                               beta_start=1e-4, gamma=0.5), device="cpu")
    assert study.values[0] == float(np.nanmin(full.val_losses))


def test_optuna_missing_exits(split, monkeypatch):
    tr, va, cw = split
    monkeypatch.setitem(sys.modules, "optuna", None)
    with pytest.raises(SystemExit, match="optuna is not installed"):
        port_hpo.run_optuna(PortConfig(**DIMS), 1, None, tr, va, N_SITES, cw, num_epochs=1,
                            device="cpu")


@pytest.fixture
def hpo_dirs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return PortConfig(checkpoint_dir=str(tmp_path / "checkpoints"), batch_size=BATCH,
                      latent_dim=LATENT, embed_dim=EMBED)


@pytest.mark.parametrize("argv", [["--prune-rungs", "2"], ["--pad-shapes"]],
                         ids=["pruned", "pad-shapes"])
def test_main_writes_both_artifacts_and_jax_loads_the_checkpoint(cohort, hpo_dirs, argv,
                                                                 tmp_path):
    import json

    data = cohort
    best_params, best_value = port_hpo.main(["--trials", "4", "--epochs", "2", *argv],
                                            data=data, device="cpu", cfg=hpo_dirs)
    saved = json.loads((tmp_path / "best_hyperparameters.json").read_text())
    assert saved == {"best_params": best_params, "best_value": best_value}
    assert np.isfinite(best_value)
    path = tmp_path / "checkpoints" / "best_multivae_optimized.npz"
    params, state = jax_ckpt.load(str(path))
    port_params, port_state = port_ckpt.load(str(path))
    assert params["decoder_a"]["fc1"]["w"].shape == (best_params["latent_dim"], 128)
    assert params["encoder_c"]["embedding"]["table"].shape == (N_SITES,
                                                              best_params["embed_dim"])
    np.testing.assert_array_equal(params["encoder_b"]["fc1"]["w"],
                                  port_params["encoder_b"]["fc1"]["w"])
    module = port_vae.MultiModalVAE(DIM_A, DIM_B, N_SITES, best_params["latent_dim"],
                                    best_params["embed_dim"])
    module.load_state_dict(state_dict_from_jax(port_params, port_state, "multivae"))


def test_main_guards(hpo_dirs):
    for argv in (["--mode", "optuna", "--pad-shapes"], ["--pad-shapes", "--bucket-size", "4"]):
        with pytest.raises(SystemExit):
            port_hpo.main(argv, data=None, device="cpu", cfg=hpo_dirs)


def test_main_optuna_mode_through_a_fake_module(cohort, hpo_dirs, monkeypatch, tmp_path):
    _fake_optuna(monkeypatch, prune_odd=False)
    data = cohort
    best_params, best_value = port_hpo.main(["--mode", "optuna", "--trials", "2", "--epochs",
                                             "1"], data=data, device="cpu", cfg=hpo_dirs)
    assert best_params["latent_dim"] == 10 and np.isfinite(best_value)
    assert (tmp_path / "checkpoints" / "best_multivae_optimized.npz").exists()


# --- the training CLI's --replicates -----------------------------------------

def test_replicates_keep_the_best_and_each_is_its_single_run(cohort, split, tmp_path,
                                                              monkeypatch):
    tr, va, _ = split
    data = cohort
    cfg = PortConfig(checkpoint_dir=str(tmp_path / "ckpt"), plots_dir=str(tmp_path / "plots"),
                     batch_size=BATCH, latent_dim=LATENT, embed_dim=EMBED)
    got, real = [], port_vm.fit_trials

    def spy(*a, **k):
        got.extend(real(*a, **k))
        return got

    monkeypatch.setattr(port_cli.vmap_meta, "fit_trials", spy)
    result, run_id, _ = run_training("rna2dna", "rna2dna", cfg=cfg,
                                     argv=["--epochs", "3", "--replicates", "3", "--seed", "4"],
                                     data=data, device="cpu", root=str(tmp_path))
    seeds = port_vm.member_seeds(4, 3)
    best = int(np.argmin([r.best_val_loss for r in got]))
    assert result is got[best]
    assert len({r.best_val_loss for r in got}) == 3  # the replicates differ
    cfg_run = cfg.replace(input_dim_a=DIM_A, input_dim_b=DIM_B)
    for seed, res in zip(seeds, got):  # each a masked trial, the populations' default
        _check_member(res, _masked_single("rna2dna", cfg_run, tr, va, seed, num_epochs=3))
    params, _, _ = port_ckpt.load_best("rna2dna", run_id, checkpoint_dir=cfg.checkpoint_dir)
    np.testing.assert_array_equal(params["decoder_dna"]["fc3"]["w"],
                                  result.params["decoder_dna"]["fc3"]["w"].numpy())
    _, _, _, saved_seed = port_ckpt.load_resume("rna2dna", run_id,
                                                checkpoint_dir=cfg.checkpoint_dir,
                                                root=str(tmp_path))
    assert saved_seed == seeds[best]


def test_replicates_print_the_population_throughput(cohort, tmp_path, capsys):
    """``--replicates 3`` prints the samples the whole population trained:
    3 x one member's rows an epoch x the epochs run, over the wall time."""
    cfg = PortConfig(checkpoint_dir=str(tmp_path / "ckpt"), plots_dir=str(tmp_path / "plots"),
                     batch_size=BATCH, latent_dim=LATENT, embed_dim=EMBED)
    capsys.readouterr()
    result, _, wall = run_training("rna2dna", "rna2dna", cfg=cfg,
                                   argv=["--epochs", "2", "--replicates", "3", "--seed", "1"],
                                   data=cohort, device="cpu", root=str(tmp_path))
    line = [ln for ln in capsys.readouterr().out.splitlines() if "samples/sec" in ln]
    n_train = len(train_val_indices(len(cohort[0]), cfg.train_test_split, cfg.random_seed)[0])
    trained = 3 * (n_train // BATCH) * BATCH * result.epochs_ran
    assert len(line) == 1 and result.epochs_ran == 2
    assert f"({trained / wall:,.0f} samples/sec)" in line[0], line[0]


def test_replicates_refusals(cohort, tmp_path):
    data = cohort
    cfg = PortConfig(checkpoint_dir=str(tmp_path / "c"), plots_dir=str(tmp_path / "p"))
    for argv, match in ((["--replicates", "0"], "must be >= 1"),
                        (["--replicates", "2", "--resume"], "does not compose")):
        with pytest.raises(SystemExit, match=match):
            run_training("rna2dna", "rna2dna", cfg=cfg, argv=argv, data=data, device="cpu",
                         root=str(tmp_path))


# --- no card, no run ---------------------------------------------------------

def test_entry_points_raise_without_a_card(cohort, split, monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("DEVICE", raising=False)
    monkeypatch.chdir(tmp_path)
    tr, va, cw = split
    data = cohort
    calls = [
        lambda: port_vm.fit_trials("multimodal", PortConfig(**DIMS), tr, va, 0, N_SITES, POP),
        lambda: port_hpo.main(["--trials", "1", "--epochs", "1"], data=data),
        lambda: port_hpo.run_vmapped(PortConfig(**DIMS), TRIALS, tr, va, N_SITES, cw, 1),
        lambda: run_training("rna2dna", "rna2dna", argv=["--replicates", "2"], data=data,
                             root=str(tmp_path)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    monkeypatch.setattr(sys, "argv", ["optimize_hyperparameters", "--trials", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_module("vae_los_angeles_torch.optimize_hyperparameters", run_name="__main__")
