"""The masked-size fold and trial populations and the Adafactor populations
of the port against the JAX package (``tests/test_masked_populations.py``'s
contracts) at small widths: the masked losses and BatchNorm, every task's
masked loss, ``bucket_rows``, ``engine.fit(masked_sizes=True)``,
``vmap_meta.fit_folds``/``fit_trials`` with ``mask_sizes``, and Adafactor
over a member axis.

Tolerances: ``LAYER`` (rtol 1e-5, atol 1e-5) where the port and JAX compute
the same fp32 expression in other orders (the losses, BatchNorm, a task's
train-mode loss with the same injected noise); bit for bit where the port
holds itself (a member against its population of one, a member at the
padded maximum against its exact-shape run, NaN padding against zero
padding, an all-true mask against none, Adafactor's population of one
against its single run). At these widths every product's inner width is at
least 16 rows, where the CPU's batched and single products give the same
bits. The JAX populations draw threefry noise and inits from keys, the port
from torch generators, so a fold's final validation loss is held to rtol
5% against JAX's, the rule of ``tests/test_torch_cv.py``, with the epochs,
βs and rates equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.data.splits import kfold_indices
from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
from vae_los_angeles_torch.ops import losses as port_losses
from vae_los_angeles_torch.ops import nn as ops_nn
from vae_los_angeles_torch.ops import optim as port_optim
from vae_los_angeles_torch.ops.kernels import fused_loss
from vae_los_angeles_torch.parallel import vmap_meta as port_vm
from vae_los_angeles_torch.training import engine as port_engine
from vae_los_angeles_torch.training import tasks as port_tasks
from vae_los_angeles_torch.training.cli import run_training
from vae_los_angeles_torch.training.tasks import Batch
from vae_los_angeles_torch.utils.tree import tree_map
from vae_los_angeles_torch.utils.weights import tree_from_numpy
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.data.dataset import MultiModalArrays
from vae_los_angeles_tpu.models import directional_ae as jax_dae
from vae_los_angeles_tpu.models import directional_vae as jax_dvae
from vae_los_angeles_tpu.models import encoders as jax_encoders
from vae_los_angeles_tpu.models import vae as jax_vae
from vae_los_angeles_tpu.ops import losses as jax_losses
from vae_los_angeles_tpu.ops import nn as jax_nn
from vae_los_angeles_tpu.ops.backend import bucket_rows as jax_bucket_rows
from vae_los_angeles_tpu.parallel import vmap_meta as jax_vm
from vae_los_angeles_tpu.training import tasks as jax_tasks

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, EMBED, BATCH = 40, 48, 5, 8, 8, 16
DIMS = dict(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT, embed_dim=EMBED,
            batch_size=BATCH)
LAYER = dict(atol=1e-5, rtol=1e-5)
EPOCHS = 4
TASKS = ["rna2dna", "dna2rna", "rna2dna_ae", "dna2rna_ae", "multimodal", "multimodal_padded",
         "rna2dna_unified", "dna2rna_unified"]


@pytest.fixture(scope="module")
def cohort():
    return generate_synthetic_arrays(n_samples=200, dim_a=DIM_A, dim_b=DIM_B, n_sites=N_SITES,
                                     seed=0)


def take(cohort, idx):
    return tuple(x[idx] for x in cohort)


@pytest.fixture(scope="module")
def uneven(cohort):
    """KFold of 110 samples into 3: (73, 37), (73, 37), (74, 36) rows, two
    exact sizes (JAX ``_uneven_folds``)."""
    folds = kfold_indices(110, 3)
    ftr = [take(cohort, tr) for tr, _ in folds]
    fva = [take(cohort, va) for _, va in folds]
    assert len({(len(a[0]), len(b[0])) for a, b in zip(ftr, fva)}) == 2
    return ftr, fva


def _bit_equal(a, b):
    """Two ``FitResult``s: every parameter, state and loss row the same bits."""
    for name in ("params", "state", "final_params", "final_state"):
        for (path, x), (_, y) in zip(port_engine._named_leaves(getattr(a, name)),
                                     port_engine._named_leaves(getattr(b, name))):
            if not np.array_equal(x.numpy(), y.numpy(), equal_nan=True):
                return False
    return all(np.array_equal(getattr(a, k), getattr(b, k), equal_nan=True)
               for k in ("train_losses", "val_losses", "betas", "lrs")) and (
        a.best_val_loss == b.best_val_loss and a.epochs_ran == b.epochs_ran)


def _padded(table, n_max, fill=0.0):
    """``table`` as tensors with rows appended up to ``n_max`` (``fill`` in
    the float columns, site 0)."""
    t = port_engine._as_batch(table, "cpu")
    pad = n_max - len(t)
    return Batch(torch.cat([t.tpm, torch.full((pad, DIM_A), fill)]),
                 torch.cat([t.beta, torch.full((pad, DIM_B), fill)]),
                 torch.cat([t.site, torch.zeros(pad, dtype=torch.int64)]))


def _population_of_one(task, cfg, tr, va, seed, maxima, fill=0.0):
    """One member's masked population at the padded ``maxima``."""
    stack = lambda t, n: Batch(*(x[None] for x in _padded(t, n, fill)))  # noqa: E731
    return port_vm._fit_group(port_tasks.get_task(task), cfg, stack(tr, maxima[0]),
                              stack(va, maxima[1]), [seed], N_SITES, EPOCHS, False, "cpu",
                              sizes=([len(tr[0])], [len(va[0])]))[0]


# --- the masked losses, BatchNorm and bucket_rows ------------------------------

def _loss_inputs(rng, lead=()):
    rows = 13
    shape = lead + (rows,)
    return dict(logits=rng.normal(size=shape + (DIM_B,)), dna=rng.random(shape + (DIM_B,)),
                rna=rng.normal(size=shape + (DIM_A,)), pred=rng.normal(size=shape + (DIM_A,)),
                mu=rng.normal(size=shape + (LATENT,)), logvar=0.3 * rng.normal(
                    size=shape + (LATENT,)), site_logits=rng.normal(size=shape + (N_SITES,)),
                site=rng.integers(0, N_SITES, size=shape))


LOSSES = {
    "kl_divergence": lambda L, d, m, **k: L.kl_divergence(d["mu"], d["logvar"], row_mask=m, **k),
    "mse_sum": lambda L, d, m, **k: L.mse_sum(d["pred"], d["rna"], row_mask=m, **k),
    "bce_with_logits_sum": lambda L, d, m, **k: L.bce_with_logits_sum(d["logits"], d["dna"],
                                                                      row_mask=m, **k),
    "cross_entropy_sum": lambda L, d, m, **k: L.cross_entropy_sum(
        d["site_logits"], d["site"], d["cw"], row_mask=m, **k),
    "vae_loss": lambda L, d, m, **k: L.vae_loss(
        d["pred"], d["rna"], d["logits"], d["dna"], d["site_logits"], d["site"], d["mu"],
        d["logvar"], beta=0.01, gamma=2.0, class_weights=d["cw"], row_mask=m, **k)[0],
    "rna2dna_loss": lambda L, d, m, **k: L.rna2dna_loss(d["logits"], d["dna"], d["mu"],
                                                        d["logvar"], 0.01, row_mask=m, **k)[0],
    "dna2rna_loss": lambda L, d, m, **k: L.dna2rna_loss(d["pred"], d["rna"], d["mu"],
                                                        d["logvar"], 0.01, row_mask=m, **k)[0],
    "rna2dna_ae_loss": lambda L, d, m, **k: L.rna2dna_ae_loss(d["logits"], d["dna"],
                                                              row_mask=m, **k)[0],
    "dna2rna_ae_loss": lambda L, d, m, **k: L.dna2rna_ae_loss(d["pred"], d["rna"],
                                                              row_mask=m, **k)[0],
}


def _poison(d, mask):
    """NaN in every float input's masked rows."""
    out = dict(d)
    for k, v in d.items():
        if v.dtype.kind == "f" and v.shape[:mask.ndim] == mask.shape:
            out[k] = np.where(mask.reshape(mask.shape + (1,) * (v.ndim - mask.ndim)), v, np.nan)
    return out


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_masked_losses_match_jax(name):
    """Each masked sum-loss against JAX's, NaN in the masked rows; with a
    member axis against ``jax.vmap``; an all-true mask is the unmasked
    loss bit for bit."""
    rng = np.random.default_rng(1)
    cw = rng.random(N_SITES).astype(np.float32) + 0.5
    mask = np.arange(13) < 9
    d = {**_poison({k: v.astype(np.float32) if v.dtype.kind == "f" else v
                    for k, v in _loss_inputs(rng).items()}, mask), "cw": cw}
    port = {k: torch.as_tensor(v) for k, v in d.items()}
    got = LOSSES[name](port_losses, port, torch.as_tensor(mask))
    want = LOSSES[name](jax_losses, {k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    clean = {k: torch.nan_to_num(v) if v.is_floating_point() else v for k, v in port.items()}
    assert torch.equal(LOSSES[name](port_losses, clean, torch.ones(13, dtype=torch.bool)),
                       LOSSES[name](port_losses, clean, None))
    # a member axis: one sum a member, each member's own prefix
    members = np.arange(13)[None] < np.array([[13], [4], [0]])
    dm = {**_poison({k: v.astype(np.float32) if v.dtype.kind == "f" else v
                     for k, v in _loss_inputs(rng, (3,)).items()}, members), "cw": cw}
    got = LOSSES[name](port_losses, {k: torch.as_tensor(v) for k, v in dm.items()},
                       torch.as_tensor(members), members=True)
    axes = {k: None if k == "cw" else 0 for k in dm}
    want = jax.vmap(lambda dd, m: LOSSES[name](jax_losses, dd, m), in_axes=(axes, 0))(
        {k: jnp.asarray(v) for k, v in dm.items()}, jnp.asarray(members))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


@pytest.mark.parametrize("kind", ["prefix", "scattered", "all_false", "all_true"])
def test_masked_batchnorm_matches_jax(kind):
    """Train-mode BatchNorm over the valid rows (biased variance normalises,
    the running variance unbiased over the valid count, row 0 always in the
    statistics) against JAX's, NaN in the masked rows; the same per member
    against ``jax.vmap``; eval mode ignores the mask."""
    rng = np.random.default_rng(2)
    rows, feat = 19, 12
    x = rng.normal(size=(3, rows, feat)).astype(np.float32)
    masks = {"prefix": np.arange(rows) < 11, "scattered": rng.random(rows) < 0.5,
             "all_false": np.zeros(rows, bool), "all_true": np.ones(rows, bool)}
    mask = masks[kind]
    params = {"gamma": rng.random(feat).astype(np.float32) + 0.5,
              "beta": rng.normal(size=feat).astype(np.float32)}
    state = {"mean": rng.normal(size=feat).astype(np.float32),
             "var": rng.random(feat).astype(np.float32) + 0.5}
    poisoned = np.where((mask | (np.arange(rows) == 0))[:, None], x[0], np.nan)
    T = lambda tree: {k: torch.as_tensor(v) for k, v in tree.items()}  # noqa: E731
    J = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}  # noqa: E731
    y, new = ops_nn.batchnorm_apply(T(params), T(state), torch.as_tensor(poisoned), train=True,
                                    row_mask=torch.as_tensor(mask))
    jy, jnew = jax_nn.batchnorm_apply(J(params), J(state), jnp.asarray(poisoned), train=True,
                                      row_mask=jnp.asarray(mask))
    keep = mask | (np.arange(rows) == 0)
    np.testing.assert_allclose(y.numpy()[keep], np.asarray(jy)[keep], **LAYER)
    for k in ("mean", "var"):
        assert np.isfinite(new[k].numpy()).all()
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]), **LAYER)
    if kind == "all_true":  # the unmasked bits
        plain_y, plain = ops_nn.batchnorm_apply(T(params), T(state), torch.as_tensor(x[0]),
                                                train=True)
        assert torch.equal(plain_y, y) and all(torch.equal(plain[k], new[k]) for k in plain)
    ey, estate = ops_nn.batchnorm_apply(T(params), T(state), torch.as_tensor(x[0]), train=False,
                                        row_mask=torch.as_tensor(mask))
    assert torch.equal(ey, ops_nn.batchnorm_apply(T(params), T(state), torch.as_tensor(x[0]),
                                                  train=False)[0])
    # a member axis: stacked leaves, one mask a member
    member_masks = np.stack([mask, np.arange(rows) < 5, np.ones(rows, bool)])
    stack = lambda tree: {k: np.stack([v, v * 0.9, v + 0.1]) for k, v in tree.items()}  # noqa
    y, new = ops_nn.batchnorm_apply(T(stack(params)), T(stack(state)), torch.as_tensor(x),
                                    train=True, row_mask=torch.as_tensor(member_masks))
    jy, jnew = jax.vmap(lambda p, s, xx, m: jax_nn.batchnorm_apply(p, s, xx, train=True,
                                                                   row_mask=m))(
        J(stack(params)), J(stack(state)), jnp.asarray(x), jnp.asarray(member_masks))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]), **LAYER)


def test_bucket_rows_is_the_jax_ladder(monkeypatch):
    for n in list(range(1, 200)) + [737, 1024, 6482, 6483, 8004, 100_000]:
        assert port_vm.bucket_rows(n) == jax_bucket_rows(n), n
    monkeypatch.setenv("EVAL_BUCKET", "0")
    assert port_vm.bucket_rows(737) == jax_bucket_rows(737) == 737


# --- every task's masked loss ---------------------------------------------------

def _jax_noise(monkeypatch, eps):
    """JAX's dropout keeps every unit (scaled by 1/keep, as the port's
    all-ones mask) and its reparameterisation takes ``eps``."""
    def dropout(key, x, rate, *, train):
        return jnp.where(True, x / (1.0 - rate), 0.0) if train and rate > 0 else x

    def reparameterize(key, mu, logvar, noise_scale=None):
        e = jnp.asarray(eps)
        if noise_scale is not None:
            e = e * noise_scale
        return mu + e * jnp.exp(0.5 * logvar)

    for mod in (jax_encoders, jax_dae):
        monkeypatch.setattr(mod, "dropout_apply", dropout)
    for mod in (jax_vae, jax_dvae):
        monkeypatch.setattr(mod, "reparameterize", reparameterize)


DROP = {"rna2dna": {"drop_mask": 128}, "rna2dna_ae": {"drop_mask": 128},
        "dna2rna": {"drop_mask1": 512, "drop_mask2": 256},
        "dna2rna_ae": {"drop_mask1": 512, "drop_mask2": 256},
        "multimodal": {"drop_a": 128, "drop_b1": 512, "drop_b2": 256}}


@pytest.mark.parametrize("task", TASKS)
def test_task_masked_loss_matches_jax(task, monkeypatch):
    """A train-mode batch of 21 rows whose last 6 are NaN padding, the same
    noise in both packages: the port's loss and new BatchNorm state against
    the JAX task's with ``row_mask``; with a member axis each member's
    masked loss is its own 2-D one."""
    rows, n_valid = 21, 15
    rng = np.random.default_rng(3)
    eps = rng.normal(size=(rows, LATENT)).astype(np.float32)
    _jax_noise(monkeypatch, eps)
    jtask = jax_tasks.TASKS[task]
    params, state = jtask.init(jax.random.PRNGKey(1), JaxConfig(**DIMS), N_SITES)
    state = dict(state)
    if task == "multimodal_padded":  # the latent and row masks compose
        state["latent_mask"] = jnp.asarray((np.arange(LATENT) < 5).astype(np.float32))
    if task.endswith("_unified"):
        state["kl_on"] = jnp.float32(0.0 if task.startswith("dna") else 1.0)
    mask = np.arange(rows) < n_valid
    tpm = rng.normal(size=(rows, DIM_A)).astype(np.float32)
    beta = rng.random((rows, DIM_B)).astype(np.float32)
    tpm[n_valid:], beta[n_valid:] = np.nan, np.nan
    site = rng.integers(0, N_SITES, size=rows)
    cw = rng.random(N_SITES).astype(np.float32) + 0.5
    want, want_state = jtask.loss(params, state, jax.random.PRNGKey(2),
                                  MultiModalArrays(jnp.asarray(tpm), jnp.asarray(beta),
                                                   jnp.asarray(site)),
                                  0.01, 1.5, jnp.asarray(cw), True, row_mask=jnp.asarray(mask))
    ptask = port_tasks.get_task(task)
    base = task.removesuffix("_unified").removesuffix("_padded")
    noise = {k: torch.ones(rows, w) for k, w in DROP[base].items()}
    if not task.endswith("_ae"):
        noise["eps"] = torch.as_tensor(eps)
    p, s = tree_from_numpy(jax.tree.map(np.asarray, params)), tree_from_numpy(
        jax.tree.map(np.asarray, state))
    batch = Batch(torch.as_tensor(tpm), torch.as_tensor(beta), torch.as_tensor(site))
    got, got_state = ptask.loss(p, s, batch, 0.01, True, gamma=1.5, class_weights=torch.as_tensor(
        cw), row_mask=torch.as_tensor(mask), **noise)
    np.testing.assert_allclose(got.numpy(), float(want), **LAYER)
    want_state = dict(port_engine._named_leaves(tree_from_numpy(
        jax.tree.map(np.asarray, want_state))))
    got_state = dict(port_engine._named_leaves(got_state))
    assert got_state.keys() == want_state.keys()
    for path, a in got_state.items():
        np.testing.assert_allclose(a.numpy(), want_state[path].numpy(), err_msg=path, **LAYER)
    # three members (valid prefixes 15, 21 and 0 rows): each its own 2-D masked loss
    counts = (n_valid, rows, 0)
    stacked = lambda t: torch.stack([t] * 3)  # noqa: E731
    clean = Batch(torch.nan_to_num(batch.tpm), torch.nan_to_num(batch.beta), batch.site)
    pm, sm = (tree_map(stacked, t) for t in (p, s))
    rmask = ops_nn.RowMask(torch.arange(rows)[None] < torch.tensor(counts)[:, None], counts)
    losses, _ = ptask.loss(pm, sm, Batch(*(stacked(t) for t in clean)), 0.01, True, gamma=1.5,
                           class_weights=torch.as_tensor(cw), row_mask=rmask,
                           **{k: stacked(v) for k, v in noise.items()})
    for j, n in enumerate(counts):
        one, _ = ptask.loss(p, s, clean, 0.01, True, gamma=1.5,
                            class_weights=torch.as_tensor(cw),
                            row_mask=torch.arange(rows) < n, **noise)
        np.testing.assert_allclose(losses[j].numpy(), one.numpy(), **LAYER)
    assert float(losses[2]) == 0.0


def test_members_loss_pair_takes_each_valid_prefix():
    """B3 (``rna2dna_loss_fused_members``) with ``rows``: each member's loss
    is the pair on its first rows, the pad rows get zero gradient, a member
    without rows adds 0."""
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(3, 9, DIM_B, generator=g, requires_grad=True)
    dna = torch.rand(3, 9, DIM_B, generator=g)
    mu = torch.randn(3, 9, LATENT, generator=g, requires_grad=True)
    logvar = torch.randn(3, 9, LATENT, generator=g, requires_grad=True)
    rows = (9, 2, 0)
    out = fused_loss.rna2dna_loss_fused_members(logits, dna, mu, logvar, 0.01, rows=rows)
    for j, n in enumerate(rows):
        want = fused_loss.rna2dna_loss_fused(logits[j, :n].detach().contiguous(),
                                             dna[j, :n].contiguous(),
                                             mu[j, :n].detach().contiguous(),
                                             logvar[j, :n].detach().contiguous(), 0.01)
        assert torch.equal(out[j].detach(), want) if n else float(out[j].detach()) == 0.0
    dl, dm, dv = torch.autograd.grad(out.sum(), (logits, mu, logvar))
    assert not dl[1, 2:].any() and not dm[1, 2:].any() and not dv[2].any()
    assert dl[0].abs().sum() > 0 and dl[1, :2].abs().sum() > 0
    with pytest.raises(ValueError, match="row counts"):
        fused_loss.rna2dna_loss_fused_members(logits, dna, mu, logvar, 0.01, rows=(1, 2))


# --- the masked fold populations ------------------------------------------------

@pytest.fixture(scope="module", params=["adamw", "adafactor"])
def jax_masked_folds(request, uneven):
    """JAX's masked population of the uneven folds (RNA→DNA, 4 epochs) with
    AdamW or Adafactor."""
    ftr, fva = uneven
    arrays = lambda t: MultiModalArrays(*(jnp.asarray(x) for x in t))  # noqa: E731
    res = jax_vm.fit_folds("rna2dna", JaxConfig(**DIMS, optimizer=request.param),
                           [arrays(t) for t in ftr], [arrays(v) for v in fva],
                           jax.random.PRNGKey(0), N_SITES, num_epochs=EPOCHS, drop_last=False,
                           mask_sizes=True)
    return request.param, [jax.device_get(r) for r in res]


def test_masked_fold_losses_agree_with_the_jax_population(jax_masked_folds, uneven):
    optimizer, want = jax_masked_folds
    got = port_vm.fit_folds("rna2dna", PortConfig(**DIMS, optimizer=optimizer), *uneven, 0,
                            N_SITES, num_epochs=EPOCHS, mask_sizes=True, device="cpu")
    for g, w in zip(got, want):
        assert g.epochs_ran == int(w.epochs_ran) == EPOCHS
        np.testing.assert_array_equal(g.betas, np.asarray(w.betas))
        np.testing.assert_array_equal(g.lrs, np.asarray(w.lrs))
        np.testing.assert_allclose(g.val_losses[-1], float(w.val_losses[-1]), rtol=0.05)
        assert g.val_losses[-1] < g.val_losses[0]


def _spy_groups(monkeypatch):
    calls, real = [], port_vm._fit_group

    def spy(task, cfg, tr, *a, **k):
        calls.append((tr.tpm.shape[0], k.get("sizes")))
        return real(task, cfg, tr, *a, **k)

    monkeypatch.setattr(port_vm, "_fit_group", spy)
    return calls


def test_uneven_folds_train_as_one_group(uneven, monkeypatch):
    calls = _spy_groups(monkeypatch)
    monkeypatch.delenv("POP_MASK_SIZES", raising=False)
    assert port_vm.mask_sizes_enabled()
    res = port_vm.fit_folds("dna2rna", PortConfig(**DIMS), *uneven, 0, N_SITES, num_epochs=1,
                            device="cpu")
    assert calls == [(3, ([73, 73, 74], [37, 37, 36]))]
    assert all(np.isfinite(r.val_losses[0]) for r in res)


def test_exact_mode_opt_out(uneven, monkeypatch):
    """``POP_MASK_SIZES=0`` restores the exact-shape groups: two populations,
    the results of ``mask_sizes=False`` bit for bit."""
    calls = _spy_groups(monkeypatch)
    monkeypatch.setenv("POP_MASK_SIZES", "0")
    assert not port_vm.mask_sizes_enabled()
    env = port_vm.fit_folds("rna2dna", PortConfig(**DIMS), *uneven, 0, N_SITES, num_epochs=2,
                            device="cpu")
    assert calls == [(2, None), (1, None)]
    explicit = port_vm.fit_folds("rna2dna", PortConfig(**DIMS), *uneven, 0, N_SITES,
                                 num_epochs=2, mask_sizes=False, device="cpu")
    assert all(_bit_equal(a, b) for a, b in zip(env, explicit))


@pytest.mark.parametrize("task", ["rna2dna", "dna2rna", "multimodal", "rna2dna_unified"])
def test_masked_member_equals_its_population_of_one(cohort, task):
    """Folds of 66, 50 and 84 training rows (5, 4 and 6 batches: the short
    members sit out trailing batches, their state and step gated) and 30,
    20 and 25 validation rows: each member against its population of one at
    the same maxima, bit for bit; each member's optimizer steps are its own
    count."""
    ftr = [take(cohort, np.arange(0, n)) for n in (66, 50, 84)]
    fva = [take(cohort, np.arange(100, 100 + n)) for n in (30, 20, 25)]
    cfg = PortConfig(**DIMS)
    res = port_vm.fit_folds(task, cfg, ftr, fva, 3, N_SITES, num_epochs=EPOCHS, mask_sizes=True,
                            device="cpu")
    assert all(np.isfinite(r.val_losses).all() for r in res)
    seeds = port_vm.member_seeds(3, 3)
    maxima = (port_vm.bucket_rows(84), port_vm.bucket_rows(30))
    for i in range(3):
        assert _bit_equal(res[i], _population_of_one(task, cfg, ftr[i], fva[i], seeds[i],
                                                     maxima)), f"fold {i}"
    assert [int(r.carry["opt"]["step"]) for r in res] == [5 * EPOCHS, 4 * EPOCHS, 6 * EPOCHS]


@pytest.mark.parametrize("task", ["rna2dna", "dna2rna", "multimodal", "dna2rna_ae"])
def test_member_at_the_padded_maximum_is_its_exact_run(cohort, task):
    """Folds of (96, 32) and (90, 30) rows pad to (96, 32): the first
    member, whose true sizes are the maxima, is ``engine.fit``'s
    exact-shape run at its seed bit for bit, and so is the masked single
    run at the maxima."""
    ftr = [take(cohort, np.arange(0, n)) for n in (96, 90)]
    fva = [take(cohort, np.arange(100, 100 + n)) for n in (32, 30)]
    cfg = PortConfig(**DIMS)
    res = port_vm.fit_folds(task, cfg, ftr, fva, 0, N_SITES, num_epochs=EPOCHS, mask_sizes=True,
                            device="cpu")
    seed = port_vm.member_seeds(0, 2)[0]
    exact = port_engine.fit(task, cfg, ftr[0], fva[0], seed, N_SITES, num_epochs=EPOCHS,
                            drop_last=False, device="cpu")
    assert _bit_equal(res[0], exact)
    masked = port_engine.fit(task, cfg, ftr[0], fva[0], seed, N_SITES, num_epochs=EPOCHS,
                             drop_last=False, masked_sizes=True, true_sizes=(96, 32),
                             device="cpu")
    assert _bit_equal(masked, exact)


def test_nan_padding_is_inert(uneven):
    """NaN in every padded row (train and validation) changes no bit: the
    training pads are never gathered, the validation pads are masked."""
    ftr, fva = uneven
    cfg = PortConfig(**DIMS)
    maxima = (port_vm.bucket_rows(74), port_vm.bucket_rows(37))
    for i in range(len(ftr)):
        clean = _population_of_one("rna2dna", cfg, ftr[i], fva[i], 5, maxima)
        poisoned = _population_of_one("rna2dna", cfg, ftr[i], fva[i], 5, maxima, np.nan)
        assert _bit_equal(clean, poisoned), f"fold {i} saw its padding"
    single = [port_engine.fit("dna2rna", cfg, tuple(_padded(ftr[2], maxima[0], fill)),
                              tuple(_padded(fva[2], maxima[1], fill)), 5, N_SITES, num_epochs=2,
                              drop_last=False, masked_sizes=True, true_sizes=(74, 36),
                              device="cpu") for fill in (0.0, np.nan)]
    assert _bit_equal(*single)


def test_masked_trial_is_its_masked_single_run(cohort):
    """``fit_trials`` pads the shared tables to their buckets (150 → 168,
    37 → 42 rows): a trial is ``engine.fit(masked_sizes=True)`` at the
    maxima bit for bit, and re-sized tables in the same buckets train."""
    tr, va = take(cohort, np.arange(150)), take(cohort, np.arange(150, 187))
    cfg = PortConfig(**DIMS)
    pop = {"lr": np.array([5e-4, 2e-3], np.float32)}
    res = port_vm.fit_trials("rna2dna", cfg, tr, va, 1, N_SITES, pop, num_epochs=3,
                             mask_sizes=True, device="cpu")
    seeds = port_vm.member_seeds(1, 2)
    for i, r in enumerate(res):
        single = port_engine.fit(
            "rna2dna", cfg, tuple(_padded(tr, 168)), tuple(_padded(va, 42)), seeds[i], N_SITES,
            num_epochs=3, hp=port_engine.hyperparams(cfg, lr=float(pop["lr"][i])),
            masked_sizes=True, true_sizes=(150, 37), device="cpu")
        assert _bit_equal(r, single), f"trial {i}"
    resized = port_vm.fit_trials("rna2dna", cfg, take(cohort, np.arange(160)),
                                 take(cohort, np.arange(160, 200)), 1, N_SITES, pop,
                                 num_epochs=1, device="cpu")
    assert all(np.isfinite(r.val_losses[0]) for r in resized)


def test_masked_fail_loud(cohort):
    """What the exact path rejects fails loudly with masked sizes too: a
    1-row final batch, no training batch, an empty validation set; JAX's
    two refusals stay (the kernel paths, intra-run data sharding)."""
    cfg = PortConfig(**DIMS)
    with pytest.raises(ValueError, match="single row"):
        port_vm.fit_folds("rna2dna", cfg, [take(cohort, np.arange(33))],
                          [take(cohort, np.arange(33, 60))], 0, N_SITES, num_epochs=1,
                          mask_sizes=True, device="cpu")
    with pytest.raises(ValueError, match="no training batches"):
        port_vm.fit_trials("rna2dna", cfg, take(cohort, np.arange(10)),
                           take(cohort, np.arange(10, 20)), 0, N_SITES,
                           {"lr": np.asarray([1e-3], np.float32)}, num_epochs=1,
                           mask_sizes=True, device="cpu")
    with pytest.raises(ValueError, match="empty validation set"):
        port_engine.fit("rna2dna", cfg, take(cohort, np.arange(64)),
                        take(cohort, np.arange(64, 70)), 0, N_SITES, num_epochs=1,
                        masked_sizes=True, true_sizes=(64, 0), device="cpu")
    with pytest.raises(ValueError, match="single row"):
        port_engine.fit("rna2dna", cfg, take(cohort, np.arange(64)),
                        take(cohort, np.arange(64, 70)), 0, N_SITES, num_epochs=1,
                        drop_last=False, masked_sizes=True, true_sizes=(49, 6), device="cpu")
    with pytest.raises(ValueError, match="exact-shape programs"):
        port_engine.fit("rna2dna", cfg, take(cohort, np.arange(64)),
                        take(cohort, np.arange(64, 70)), 0, N_SITES, num_epochs=1,
                        fused_epoch=True, masked_sizes=True, device="cpu")
    with pytest.raises(ValueError, match="intra-run data sharding"):
        port_engine.fit("rna2dna", cfg, take(cohort, np.arange(64)),
                        take(cohort, np.arange(64, 70)), 0, N_SITES, num_epochs=1,
                        masked_sizes=True, mesh=type("Mesh", (), {"size": 2})(),
                        device="cpu")


def test_debug_nans_survives_a_masked_population(cohort):
    """``DEBUG_NANS=1`` checks every step: the members' inactive trailing
    batches (all rows masked, BatchNorm's row 0 kept) make no non-finite
    value, and early-stopped members leave without NaN work."""
    ftr = [take(cohort, np.arange(0, n)) for n in (66, 50, 84)]
    fva = [take(cohort, np.arange(100, 100 + n)) for n in (30, 20, 25)]
    cfg = PortConfig(**DIMS, debug_nans=True, patience=1, learning_rate=1e-2)
    res = port_vm.fit_folds("rna2dna", cfg, ftr, fva, 2, N_SITES, num_epochs=3, mask_sizes=True,
                            device="cpu")
    assert all(np.isfinite(r.best_val_loss) for r in res)


# --- Adafactor populations ---------------------------------------------------------

def test_adafactor_population_of_one_is_the_single_run(cohort):
    cfg = PortConfig(**DIMS, optimizer="adafactor", learning_rate=1e-3)
    tr, va = take(cohort, np.arange(96)), take(cohort, np.arange(100, 132))
    for task in ("rna2dna", "multimodal"):
        pop = port_vm.fit_folds(task, cfg, [tr], [va], 0, N_SITES, num_epochs=EPOCHS,
                                mask_sizes=False, device="cpu")[0]
        single = port_engine.fit(task, cfg, tr, va, port_vm.member_seeds(0, 1)[0], N_SITES,
                                 num_epochs=EPOCHS, drop_last=False, device="cpu")
        assert _bit_equal(pop, single), task
        for key in ("vr", "vc"):
            for (path, a), (_, b) in zip(port_engine._named_leaves(pop.carry["opt"][key]),
                                         port_engine._named_leaves(single.carry["opt"][key])):
                assert torch.equal(a, b), (task, key, path)


def test_adafactor_member_axis_state_layout():
    """A stacked (P, n) bias keeps an unfactored (P, n) statistic and a
    (P, 0) placeholder; a stacked (P, r, c) weight factors into (P, r) and
    (P, c); a member's slice is the single run's layout."""
    params = {"w": torch.zeros(3, 7, 5), "b": torch.zeros(3, 5)}
    st = port_optim.adafactor_init(params, members=True)
    assert st["vr"]["b"].shape == (3, 5) and st["vc"]["b"].shape == (3, 0)
    assert st["vr"]["w"].shape == (3, 7) and st["vc"]["w"].shape == (3, 5)
    single = port_optim.adafactor_init({"w": torch.zeros(7, 5), "b": torch.zeros(5)})
    for key in ("vr", "vc"):
        for name in ("w", "b"):
            assert st[key][name][0].shape == single[key][name].shape
    carry = port_engine.init_carry(params, {}, np.full(3, 1e-3, np.float32),
                                   optimizer="adafactor", n_members=3)
    assert carry["opt"]["vc"]["b"].shape == (3, 0)


def test_adafactor_member_clip_and_rate_are_its_own():
    """Member 1's gradients 100x larger: member 0's update equals its
    population of one and its single 2-D step bit for bit (its RMS clip,
    factoring, rate and decay its own)."""
    g = torch.Generator().manual_seed(6)
    params = {"w": torch.randn(2, 24, 17, generator=g), "b": torch.randn(2, 17, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    grads = {k: torch.stack([v[0], 100.0 * v[1]]) for k, v in grads.items()}
    lrs, wds = torch.tensor([1e-2, 3e-3]), torch.tensor([1e-4, 1e-2])
    state = port_optim.adafactor_init(params, members=True)
    for _ in range(3):  # a few steps, so that the statistics are not fresh
        new, state_new = port_optim.adafactor_update(params, grads, state, lrs, wds)
        one, one_state = port_optim.adafactor_update(
            {k: v[:1] for k, v in params.items()}, {k: v[:1] for k, v in grads.items()},
            {"step": state["step"], **{s: {k: v[:1] for k, v in state[s].items()}
                                      for s in ("vr", "vc")}}, lrs[:1], wds[:1])
        flat, _ = port_optim.adafactor_update(
            {k: v[0] for k, v in params.items()}, {k: v[0] for k, v in grads.items()},
            {"step": state["step"], **{s: {k: v[0] for k, v in state[s].items()}
                                      for s in ("vr", "vc")}}, float(lrs[0]), float(wds[0]))
        for k in params:
            assert torch.equal(new[k][0], one[k][0]) and torch.equal(new[k][0], flat[k]), k
        params, state = new, state_new


def test_adafactor_replicates_run_and_print_the_population_throughput(cohort, tmp_path, capsys):
    cfg = PortConfig(checkpoint_dir=str(tmp_path / "ckpt"), plots_dir=str(tmp_path / "plots"),
                     batch_size=BATCH, latent_dim=LATENT, embed_dim=EMBED)
    capsys.readouterr()
    result, _, wall = run_training("rna2dna", "rna2dna", cfg=cfg,
                                   argv=["--epochs", "2", "--replicates", "2", "--optimizer",
                                         "adafactor", "--seed", "1"],
                                   data=cohort, device="cpu", root=str(tmp_path))
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if "samples/sec" in ln]
    assert len(line) == 1 and "Replicates (best val loss each): r0=" in out
    assert result.epochs_ran == 2 and "vr" in result.carry["opt"]
    assert result.carry["opt"]["vc"]["decoder_dna"]["fc3"]["b"].shape == (0,)
