"""The CV slice of the port against the JAX package at small widths: the
KFold and inner splits, ``--subset``'s rows, the CV metrics, the member axis
of the layer primitives and the applies, the fold population
(``parallel.vmap_meta.fit_folds``) against single runs and against the JAX
population, ``engine.predict``, the unified tasks, and
``evaluation.cross_modality_cv`` (mean and kNN records, the paired t-tests,
the unified VAE half, the refusals).

Tolerances: ``LAYER`` (1e-5) where the port and JAX compute the same fp32
expression in other orders; a member against its single run at rtol 2e-4
(the JAX package's population-against-sequential tolerance,
``tests/test_parallel.py``), with the epoch count, the best epoch and the
rates equal; the unified VAE half bit for bit. The JAX population draws
threefry noise and inits from keys, the port from torch generators, so
their per-fold final validation losses agree to rtol 5%, the rule of
``tests/test_torch_training.py``, for the two RNA→DNA families: over the
port's seeds 0-2 and JAX's keys 0-1 at this size a fold's final validation
loss moves by up to ~5% with the seed alone, and the pair the test runs
differs by at most 4.5% (RNA→DNA VAE) and 3.2% (RNA→DNA AE). The DNA→RNA
population's final validation loss moves by up to 28% with the seed at 4
epochs of ~120 rows (MSE sums of log-expression, early in the descent), so
no 5% rule holds for it against JAX here; it is held against its single
runs (``test_each_member_is_its_single_run``), and the single run against
JAX in ``tests/test_torch_training.py``. Two JAX populations run in this
file (``jax_folds``). At these widths (every product's inner width >= 16)
the CPU's batched and single products give the same bits, so a member
equals its single run exactly here; the rtol 2e-4 leaves room for the
card's batched products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.data.splits import cv_inner_split, kfold_indices
from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
from vae_los_angeles_torch.evaluation import cross_modality_cv as port_cv
from vae_los_angeles_torch.models import decoders as p_decoders
from vae_los_angeles_torch.models import directional_ae as p_dae
from vae_los_angeles_torch.models import directional_vae as p_dvae
from vae_los_angeles_torch.models import encoders as p_encoders
from vae_los_angeles_torch.models.vae import reparameterize
from vae_los_angeles_torch.ops import metrics as port_metrics
from vae_los_angeles_torch.ops import nn as ops_nn
from vae_los_angeles_torch.ops import optim as port_optim
from vae_los_angeles_torch.ops.kernels import fused_loss
from vae_los_angeles_torch.parallel import vmap_meta as port_vm
from vae_los_angeles_torch.training import engine as port_engine
from vae_los_angeles_torch.training import tasks as port_tasks
from vae_los_angeles_torch.training.tasks import Batch
from vae_los_angeles_torch.utils.weights import (jax_from_state_dict, state_dict_from_jax,
                                                 tree_from_numpy)
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.data import splits as jax_splits
from vae_los_angeles_tpu.data.dataset import MultiModalArrays
from vae_los_angeles_tpu.evaluation import cross_modality_cv as jax_cv
from vae_los_angeles_tpu.ops import metrics as jax_metrics
from vae_los_angeles_tpu.parallel import vmap_meta as jax_vm
from vae_los_angeles_tpu.training import tasks as jax_tasks

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, EMBED, BATCH = 21, 29, 5, 6, 16, 16
DIMS = dict(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT, embed_dim=EMBED,
            batch_size=BATCH)
LAYER = dict(atol=1e-5, rtol=1e-5)
MEMBER = dict(rtol=2e-4, atol=0.0)
TASKS = ["rna2dna", "dna2rna", "rna2dna_ae", "dna2rna_ae", "rna2dna_unified",
         "dna2rna_unified"]


@pytest.fixture(scope="module")
def cohort():
    return generate_synthetic_arrays(n_samples=200, dim_a=DIM_A, dim_b=DIM_B, n_sites=N_SITES,
                                     seed=3)


def cv_folds(cohort, n_folds=3):
    """The CV's inner (train, validation) triples of each fold."""
    tr, va = [], []
    for train_index, _ in kfold_indices(len(cohort[0]), n_folds):
        a, b = cv_inner_split(train_index)
        tr.append(tuple(x[a] for x in cohort))
        va.append(tuple(x[b] for x in cohort))
    return tr, va


# --- splits, subset, metrics -------------------------------------------------

@pytest.mark.parametrize("n,n_splits", [(103, 5), (200, 3), (11, 10), (1024, 5)])
def test_kfold_and_inner_split_equal_sklearn(n, n_splits):
    from sklearn.model_selection import train_test_split

    got, want = kfold_indices(n, n_splits), jax_splits.kfold_indices(n, n_splits)
    assert len(got) == len(want) == n_splits
    for (tr, te), (wtr, wte) in zip(got, want):
        np.testing.assert_array_equal(tr, wtr)
        np.testing.assert_array_equal(te, wte)
        for g, w in zip(cv_inner_split(tr), train_test_split(wtr, test_size=0.1,
                                                             random_state=42)):
            np.testing.assert_array_equal(g, w)


def test_kfold_refuses_too_many_splits():
    with pytest.raises(ValueError, match="n_splits"):
        kfold_indices(4, 5)


@pytest.mark.parametrize("frac", [0.5, 0.37, 0.999])
def test_subset_rows_equal_pandas_sample(frac):
    import pandas as pd

    frame = pd.DataFrame({"row": np.arange(137)})
    want = frame.sample(frac=frac, random_state=42)["row"].to_numpy()
    np.testing.assert_array_equal(port_cv.subset_rows(137, frac), want)


def test_cv_metrics_against_jax():
    """A constant column (0.25 over 64 rows, an exact mean) and a
    power-of-two width (32), so that XLA's row and column means of a
    constant are exact (ROADMAP C, ``pearson_per_sample``)."""
    rng = np.random.default_rng(0)
    y_true = rng.random((64, 32)).astype(np.float32)
    y_true[:, 3] = 0.25
    y_pred = (y_true + 0.1 * rng.normal(size=y_true.shape)).astype(np.float32)
    y_pred[:, 3] = 0.25  # a perfectly predicted constant column scores 1.0
    y_pred[5] = 0.5  # a constant prediction row: its Pearson r is undefined
    got = port_metrics.compute_cv_metrics(y_true, y_pred)
    want = jax_metrics.compute_cv_metrics(y_true, y_pred)
    assert list(got) == port_metrics.METRIC_NAMES == jax_cv.METRIC_NAMES
    for k in got:
        assert isinstance(got[k], float)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    y_pred[0, 3] = 0.5  # a missed constant column scores 0.0
    np.testing.assert_allclose(port_metrics.compute_cv_metrics(y_true, y_pred)["Mean R2"],
                               jax_metrics.compute_cv_metrics(y_true, y_pred)["Mean R2"],
                               rtol=1e-5)


# --- the member axis ---------------------------------------------------------

def _stack(trees):
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def test_layer_primitives_with_a_member_axis_equal_each_member():
    g = torch.Generator().manual_seed(0)
    p_n, rows = 3, 9
    lin = [{"w": torch.randn(7, 5, generator=g), "b": torch.randn(5, generator=g)}
           for _ in range(p_n)]
    bn = [{"gamma": torch.rand(5, generator=g), "beta": torch.randn(5, generator=g)}
          for _ in range(p_n)]
    bns = [{"mean": torch.randn(5, generator=g), "var": torch.rand(5, generator=g) + 0.5}
           for _ in range(p_n)]
    x = torch.randn(p_n, rows, 7, generator=g)
    y = ops_nn.linear_apply(_stack(lin), x)
    for train in (True, False):
        z, st = ops_nn.batchnorm_apply(_stack(bn), _stack(bns), y, train=train)
        for i in range(p_n):
            yi = ops_nn.linear_apply(lin[i], x[i])
            torch.testing.assert_close(y[i], yi, **LAYER)
            zi, sti = ops_nn.batchnorm_apply(bn[i], bns[i], yi, train=train)
            torch.testing.assert_close(z[i], zi, **LAYER)
            for k in sti:
                torch.testing.assert_close(st[k][i], sti[k], **LAYER)
    table = torch.randn(p_n, N_SITES, 4, generator=g)
    ids = torch.randint(0, N_SITES, (p_n, rows), generator=g)
    got = ops_nn.embedding_lookup(table, ids)
    for i in range(p_n):
        assert torch.equal(got[i], table[i][ids[i]])
    # one generator a member: each member's draws are its single run's
    gens = [torch.Generator().manual_seed(s) for s in (5, 6, 7)]
    out = ops_nn.dropout_apply(torch.ones(p_n, rows, 8), 0.3, train=True, generator=gens)
    for i, s in enumerate((5, 6, 7)):
        want = ops_nn.dropout_apply(torch.ones(rows, 8), 0.3, train=True,
                                    generator=torch.Generator().manual_seed(s))
        assert torch.equal(out[i], want)


def test_reparameterize_noise_scale():
    g = torch.Generator().manual_seed(1)
    mu, logvar, eps = (torch.randn(4, LATENT, generator=g) for _ in range(3))
    assert torch.equal(reparameterize(mu, logvar, eps, noise_scale=torch.tensor(1.0)),
                       reparameterize(mu, logvar, eps))
    assert torch.equal(reparameterize(mu, logvar, eps, noise_scale=torch.tensor(0.0)), mu)
    # per member: member 0 sampled, member 1 at its mean
    z = reparameterize(torch.stack([mu, mu]), torch.stack([logvar, logvar]),
                       torch.stack([eps, eps]), noise_scale=torch.tensor([1.0, 0.0]))
    assert torch.equal(z[0], reparameterize(mu, logvar, eps)) and torch.equal(z[1], mu)


def test_adamw_with_one_rate_a_member_matches_each_member_bit_for_bit():
    g = torch.Generator().manual_seed(2)
    p_n = 3
    trees = [{"w": torch.randn(6, 4, generator=g), "b": torch.randn(4, generator=g)}
             for _ in range(p_n)]
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in t.items()} for t in trees]
    states = [port_optim.adamw_init(t) for t in trees]
    states = [{**s, "m": {k: torch.randn(v.shape, generator=g) for k, v in s["m"].items()},
               "v": {k: torch.rand(v.shape, generator=g) for k, v in s["v"].items()}}
              for s in states]
    lrs = torch.tensor([5e-4, 2.5e-4, 1.3e-3], dtype=torch.float32)
    pop_state = {"step": states[0]["step"], "m": _stack([s["m"] for s in states]),
                 "v": _stack([s["v"] for s in states])}
    new, new_state = port_optim.adamw_update(_stack(trees), _stack(grads), pop_state, lrs, 1e-5)
    for i in range(p_n):
        want, want_state = port_optim.adamw_update(trees[i], grads[i], states[i],
                                                   float(lrs[i]), 1e-5)
        for k in want:
            assert torch.equal(new[k][i], want[k]), k
            assert torch.equal(new_state["m"][k][i], want_state["m"][k])
            assert torch.equal(new_state["v"][k][i], want_state["v"][k])
    plateau = port_optim.plateau_init(5e-4, n_members=p_n)
    assert plateau["lr"].shape == (p_n,) and port_optim.early_stop_init(
        n_members=p_n)["stopped"].shape == (p_n,)


JAX_PREDICT_CASES = [(t, None) for t in TASKS[:4]] + [
    (t, k) for t in TASKS[4:] for k in (0.0, 1.0)]


@pytest.mark.parametrize("task,kl_on", JAX_PREDICT_CASES,
                         ids=[f"{t}-{k}" if k is not None else t for t, k in JAX_PREDICT_CASES])
def test_population_predict_against_jax_vmap(task, kl_on):
    """JAX-stacked weights (3 members, randomized BatchNorm statistics),
    moved by ``tree_from_numpy``, each member on its own rows: the port's
    eval predict with the member axis against ``jax.vmap`` of the JAX
    task's predict, the VAEs given JAX's own eps."""
    p_n, rows = 3, 11
    cfg = JaxConfig(**DIMS)
    keys = jax.random.split(jax.random.PRNGKey(4), p_n)
    jtask = jax_tasks.TASKS[task]
    params, state = jax.vmap(lambda k: jtask.init(k, cfg, N_SITES))(keys)
    state = dict(jax.tree.map(lambda x: x + 0.3 * jax.random.uniform(jax.random.PRNGKey(9),
                                                                      x.shape), state))
    if kl_on is not None:
        state["kl_on"] = jnp.full((p_n,), kl_on, jnp.float32)
    rng = np.random.default_rng(5)
    tpm = rng.normal(size=(p_n, rows, DIM_A)).astype(np.float32)
    beta = rng.random((p_n, rows, DIM_B)).astype(np.float32)
    site = rng.integers(0, N_SITES, size=(p_n, rows))
    pred_keys = jax.random.split(jax.random.PRNGKey(8), p_n)
    want = np.asarray(jax.vmap(jtask.predict)(
        params, state, pred_keys, MultiModalArrays(jnp.asarray(tpm), jnp.asarray(beta),
                                                   jnp.asarray(site))))
    noise = {}
    if not task.endswith("_ae"):  # the eps each member's apply draws from k_z
        noise["eps"] = torch.as_tensor(np.stack([
            np.asarray(jax.random.normal(jax.random.split(k)[1], (rows, LATENT)))
            for k in pred_keys]))
    params, state = jax.tree.map(np.asarray, (params, state))
    got = port_tasks.get_task(task).predict(
        tree_from_numpy(params), tree_from_numpy(state),
        Batch(torch.as_tensor(tpm), torch.as_tensor(beta), torch.as_tensor(site)), **noise)
    assert got.shape == want.shape == (p_n, rows, DIM_B if task.startswith("rna2dna")
                                       else DIM_A)
    np.testing.assert_allclose(got.numpy(), want, **LAYER)


def test_unified_weight_layout_round_trips_kl_on():
    params, state = port_tasks.get_task("dna2rna_unified").init(
        torch.Generator().manual_seed(0), PortConfig(**DIMS), N_SITES)
    sd = state_dict_from_jax(params, state, "dna2rna_unified")
    assert float(sd["kl_on"]) == 1.0
    back_p, back_s = jax_from_state_dict(sd, "dna2rna_unified")
    assert float(back_s["kl_on"]) == 1.0 and back_s.keys() == state.keys()
    module = p_dvae.DNA2RNAVAE(DIM_A, DIM_B, N_SITES, LATENT, EMBED)
    module.load_state_dict({k: v for k, v in sd.items() if k != "kl_on"}, strict=True)


# --- the fold population -----------------------------------------------------

def _check_member(res, single):
    assert res.epochs_ran == single.epochs_ran
    assert res.best_epoch == single.best_epoch and res.stopped == single.stopped
    np.testing.assert_array_equal(res.lrs, single.lrs)
    np.testing.assert_array_equal(res.betas, single.betas)
    np.testing.assert_allclose(res.train_losses, single.train_losses, **MEMBER)
    np.testing.assert_allclose(res.val_losses, single.val_losses, **MEMBER)
    np.testing.assert_allclose(res.best_val_loss, single.best_val_loss, **MEMBER)
    for a, b in zip(port_engine._named_leaves(res.params),
                    port_engine._named_leaves(single.params)):
        torch.testing.assert_close(a[1], b[1], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("task", TASKS)
def test_each_member_is_its_single_run(cohort, task):
    EPOCHS = 8
    """Three folds in two (n_train, n_val) groups, a high rate and patience
    1, so that members stop early at different epochs while others train
    on and the plateau cuts the rate; each member against ``engine.fit``'s
    plain path at its seed (the unified tasks at ``kl_on = 0`` on member 1)."""
    tr, va = cv_folds(cohort)
    cfg = PortConfig(**DIMS, learning_rate=1e-2, patience=1, lr_scheduler_patience=0)
    overrides = ({"kl_on": np.array([1.0, 0.0, 1.0], np.float32)}
                 if task.endswith("_unified") else None)
    results = port_vm.fit_folds(task, cfg, tr, va, 7, N_SITES, num_epochs=EPOCHS,
                                state_overrides=overrides, device="cpu")
    seeds = port_vm.member_seeds(7, 3)
    ran = []
    for i, res in enumerate(results):
        init = port_tasks.get_task(task).init(torch.Generator().manual_seed(seeds[i]), cfg,
                                              N_SITES)
        if overrides:
            init[1]["kl_on"] = torch.tensor(overrides["kl_on"][i])
        single = port_engine.fit(task, cfg, tr[i], va[i], seeds[i], N_SITES, num_epochs=EPOCHS,
                                 drop_last=False, init_params=init[0], init_state=init[1],
                                 device="cpu")
        _check_member(res, single)
        ran.append(res.epochs_ran)
        if overrides:
            assert float(res.state["kl_on"]) == overrides["kl_on"][i]
    assert min(ran) < EPOCHS, ran  # a member stopped early
    assert len({len(t[0]) for t in tr}) == 2  # two groups


def test_a_population_step_runs_each_layer_once_for_all_members(cohort, monkeypatch):
    """One epoch of a 3-member population calls every Linear as often as one
    single run's epoch does (each call one batched product), and the RNA→DNA
    loss pair once a member a step and a validation."""
    tr, va = cv_folds(cohort)
    cfg = PortConfig(**DIMS)
    calls = {"linear": 0, "loss": 0}
    real_linear, real_loss = ops_nn.linear_apply, fused_loss._forward

    def counted_linear(params, x):
        calls["linear"] += 1
        return real_linear(params, x)

    def counted_loss(*args):
        calls["loss"] += 1
        return real_loss(*args)

    for mod in (p_encoders, p_decoders, p_dvae, p_dae):
        monkeypatch.setattr(mod, "linear_apply", counted_linear, raising=False)
    monkeypatch.setattr(fused_loss, "_forward", counted_loss)
    port_vm.fit_folds("rna2dna", cfg, tr[:2], va[:2], 0, N_SITES, num_epochs=1,
                      device="cpu")
    pop = dict(calls)
    calls.update(linear=0, loss=0)
    port_engine.fit("rna2dna", cfg, tr[0], va[0], 0, N_SITES, num_epochs=1, drop_last=False,
                    device="cpu")
    steps = -(-len(tr[0][0]) // BATCH)
    assert pop["linear"] == calls["linear"] > 0
    assert calls["loss"] == steps + 1 and pop["loss"] == 2 * (steps + 1)


@pytest.mark.parametrize("direction", ["rna2dna", "dna2rna"])
def test_unified_vae_half_equals_the_vae_population_bit_for_bit(cohort, direction):
    tr, va = cv_folds(cohort)
    cfg = PortConfig(**DIMS)
    seeds = port_vm.member_seeds(0, 3)
    vae = port_vm.fit_folds(direction, cfg, tr, va, 0, N_SITES, num_epochs=3, device="cpu")
    uni = port_vm.fit_folds(f"{direction}_unified", cfg, tr, va, 0, N_SITES, num_epochs=3,
                            seeds=seeds, state_overrides={"kl_on": np.ones(3, np.float32)},
                            device="cpu")
    for a, b in zip(vae, uni):
        np.testing.assert_array_equal(a.train_losses, b.train_losses)
        np.testing.assert_array_equal(a.val_losses, b.val_losses)
        for (name, x), (_, y) in zip(port_engine._named_leaves(a.params),
                                     port_engine._named_leaves(b.params)):
            assert torch.equal(x, y), name


@pytest.fixture(scope="module", params=["rna2dna", "rna2dna_ae"])
def jax_folds(request, cohort):
    """The JAX population (exact-shape groups) of 3 folds x 4 epochs."""
    tr, va = cv_folds(cohort)
    arrays = lambda t: MultiModalArrays(*(jnp.asarray(x) for x in t))  # noqa: E731
    res = jax_vm.fit_folds(request.param, JaxConfig(**DIMS), [arrays(t) for t in tr],
                           [arrays(v) for v in va], jax.random.PRNGKey(0), N_SITES,
                           num_epochs=4, drop_last=False, mask_sizes=False)
    return request.param, [jax.device_get(r) for r in res]


def test_fold_losses_agree_with_the_jax_population(jax_folds, cohort):
    task, want = jax_folds
    tr, va = cv_folds(cohort)
    got = port_vm.fit_folds(task, PortConfig(**DIMS), tr, va, 0, N_SITES, num_epochs=4,
                            device="cpu")
    for g, w in zip(got, want):
        assert g.epochs_ran == int(w.epochs_ran) == 4
        np.testing.assert_array_equal(g.betas, np.asarray(w.betas))
        np.testing.assert_array_equal(g.lrs, np.asarray(w.lrs))
        np.testing.assert_allclose(g.val_losses[-1], float(w.val_losses[-1]), rtol=0.05)
        assert g.val_losses[-1] < g.val_losses[0]


def test_fit_folds_refusals(cohort):
    tr, va = cv_folds(cohort)
    cfg = PortConfig(**DIMS)
    with pytest.raises(ValueError, match="mask_sizes=True is not ported"):
        port_vm.fit_folds("rna2dna", cfg, tr, va, 0, N_SITES, mask_sizes=True, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        port_vm.fit_folds("rna2dna", cfg, tr, va, 0, N_SITES, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="no such state entry"):
        port_vm.fit_folds("rna2dna", cfg, tr, va, 0, N_SITES, num_epochs=1, device="cpu",
                          state_overrides={"kl_on": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="AdamW"):
        port_vm.fit_folds("rna2dna", cfg.replace(optimizer="adafactor"), tr, va, 0, N_SITES,
                          device="cpu")


@pytest.mark.parametrize("n_train,n_val,drop_last,match", [
    (10, 5, True, "no training batches"),
    (33, 5, False, "single row"),
    (40, 0, False, "empty validation set"),
])
def test_fit_folds_host_checks(cohort, n_train, n_val, drop_last, match):
    take = lambda a, b: tuple(x[a:b] for x in cohort)  # noqa: E731
    with pytest.raises(ValueError, match=f"member 1: .*{match}"):
        port_vm.fit_folds("rna2dna", PortConfig(**DIMS), [take(0, 40), take(0, n_train)],
                          [take(100, 110), take(100, 100 + n_val)], 0, N_SITES,
                          drop_last=drop_last, device="cpu")


# --- engine.predict ----------------------------------------------------------

def test_predict_in_chunks_gives_the_rows_of_one_call(cohort):
    cfg = PortConfig(**DIMS)
    params, state = port_tasks.get_task("dna2rna_ae").init(torch.Generator().manual_seed(0),
                                                          cfg, N_SITES)
    table = tuple(x[:45] for x in cohort)
    whole = port_engine.predict("dna2rna_ae", params, state, table, device="cpu")
    chunked = port_engine.predict("dna2rna_ae", params, state, table, chunk_size=16,
                                  device="cpu")
    assert isinstance(chunked, np.ndarray) and chunked.shape == (45, DIM_A)
    np.testing.assert_allclose(chunked, whole.numpy(), rtol=1e-6, atol=1e-6)
    # a VAE samples z from the seeded generator: the task's predict with it
    params, state = port_tasks.get_task("rna2dna").init(torch.Generator().manual_seed(0),
                                                       cfg, N_SITES)
    got = port_engine.predict("rna2dna", params, state, table, seed=3, device="cpu")
    want = port_tasks.get_task("rna2dna").predict(params, state,
                                                  port_engine._as_batch(table, "cpu"),
                                                  torch.Generator().manual_seed(3))
    assert torch.equal(got, want)
    bf16 = port_engine.predict("rna2dna", params, state, table, seed=3,
                               compute_dtype="bfloat16", device="cpu")
    assert bf16.dtype == torch.float32 and not torch.equal(bf16, want)
    torch.testing.assert_close(bf16, want, rtol=0.05, atol=0.05)
    with pytest.raises(ValueError, match="mesh"):
        port_engine.predict("rna2dna", params, state, table, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        port_engine.predict("rna2dna", params, state, table, chunk_size=0, device="cpu")


# --- the cross-modality CV ---------------------------------------------------

def _records_close(got, want):
    assert [(r["direction"], r["model"], r["param_name"], r["param_value"]) for r in got] == \
        [(r["direction"], r["model"], r["param_name"], r["param_value"]) for r in want]
    for g, w in zip(got, want):
        for k in jax_cv.METRIC_NAMES:
            np.testing.assert_allclose(g["fold_metrics"][k], w["fold_metrics"][k],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(g[f"mean_{k}"], w[f"mean_{k}"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model_type,k_values", [("mean", []), ("knn", [5, 10, 25])])
def test_mean_and_knn_records_equal_jax(cohort, model_type, k_values):
    tpm, beta, site = cohort
    folds = kfold_indices(len(tpm), 4)
    for direction, X, y in (("RNA -> DNA", tpm, beta), ("DNA -> RNA", beta, tpm)):
        got = port_cv.run_cross_validation(X, y, site, k_values, folds, direction, model_type,
                                           device="cpu")
        want = jax_cv.run_cross_validation(X, y, site, k_values, folds, direction, model_type)
        _records_close(got, want)


def _fake_results():
    rng = np.random.default_rng(11)
    out = []
    for direction in ("RNA -> DNA", "DNA -> RNA"):
        for model, param_name, values, shift in (("mean", "dummy", [0], 0.0),
                                                 ("knn", "k", [5, 10], 0.3),
                                                 ("vae", "epochs", [3], 0.25),
                                                 ("ae", "epochs", [3], 0.26)):
            for value in values:
                fm = {k: list(shift + 0.05 * rng.normal(size=5) + 0.01 * value)
                      for k in jax_cv.METRIC_NAMES}
                out.append(jax_cv._aggregate_sweep(direction, model, param_name, value, 1.0,
                                                   fm, quiet=True))
    return out


@pytest.mark.parametrize("metric", ["Mean R2", "MSE", "Pearson"])
def test_pairwise_tests_rows_equal_the_jax_frame(metric):
    results = _fake_results()
    got = port_cv.pairwise_tests(results, metric)
    want = jax_cv.pairwise_tests(results, metric).to_dict("records")
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("Direction", "A", "B", "A_config", "B_config"):
            assert g[k] == w[k]
        assert g["winner"] == (w["winner"] if isinstance(w["winner"], str) else None)
        for k in ("A_mean", "B_mean", "t", "p"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-9, atol=0.0)
    assert any(g["winner"] for g in got)
    tidy = port_cv.tidy_results(results)
    assert tidy == jax_cv.tidy_results(results).to_dict("records")


def test_unified_direction_vae_half_equals_the_vae_sweep(cohort):
    tpm, beta, site = cohort
    folds = kfold_indices(len(tpm), 3)
    vae = port_cv.run_cross_validation(tpm, beta, site, [], folds, "RNA -> DNA", "vae",
                                       epochs=2, batch_size=BATCH, device="cpu")
    uni = port_cv.run_unified_direction(tpm, beta, site, folds, "RNA -> DNA", epochs=2,
                                        batch_size=BATCH, device="cpu")
    assert [r["model"] for r in uni] == ["vae", "ae"]
    assert uni[0]["fold_metrics"] == vae[0]["fold_metrics"]
    assert uni[1]["fold_metrics"] != vae[0]["fold_metrics"]


def test_cv_main_runs_both_directions_on_the_cpu(cohort, monkeypatch, capsys, tmp_path):
    monkeypatch.chdir(tmp_path)
    for k, v in DIMS.items():
        monkeypatch.setenv(k.upper(), str(v))
    results = port_cv.main(["--folds", "3", "--epochs", "2", "--batch_size", str(BATCH),
                            "--subset", "0.8"], data=cohort, device="cpu")
    assert [(r["direction"], r["model"]) for r in results][:5] == [
        ("DNA -> RNA", "mean"), ("DNA -> RNA", "knn"), ("DNA -> RNA", "knn"),
        ("DNA -> RNA", "vae"), ("DNA -> RNA", "ae")]
    assert len(results) == 10
    for r in results:
        assert all(len(v) == 3 and np.isfinite(v).all() for v in r["fold_metrics"].values())
    out = capsys.readouterr().out
    assert "FINAL RESULTS SUMMARY" in out and out.count("STATISTICAL COMPARISON") == 3


def test_cv_entry_raises_without_a_card_unless_asked_for_the_cpu(cohort, monkeypatch):
    monkeypatch.delenv("DEVICE", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cv.main(["--folds", "3", "--epochs", "1"], data=cohort)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_vm.fit_folds("rna2dna", PortConfig(**DIMS), *cv_folds(cohort), 0, N_SITES)


def test_unified_families_policy(monkeypatch):
    monkeypatch.delenv("CV_UNIFIED_FAMILIES", raising=False)
    assert port_cv.resolve_unified_families() is True
    monkeypatch.setenv("CV_UNIFIED_FAMILIES", "0")
    assert port_cv.resolve_unified_families() is False
    assert port_cv.resolve_unified_families(True) is True
    assert port_cv.parse_args(["--unified-families"]).unified_families is True
    monkeypatch.setenv("CV_UNIFIED_FAMILIES", "maybe")
    with pytest.raises(ValueError, match="CV_UNIFIED_FAMILIES"):
        port_cv.resolve_unified_families()
