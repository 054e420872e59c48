"""The downstream site classification of the port against sklearn and the
JAX package at small sizes: the numpy splits, scaler, class weights, label
codes and classification reports against sklearn; the MLPs' forward, loss,
LayerNorm and Adam step, one training step and a few epochs of the fit
against the JAX package's (through the weight bridge, the fit given the JAX
package's own permutations and dropout masks through `_fit`'s ``noise``
seam); the populations against their single fits; the scenario aggregation
against JAX's; both entry points on the CPU.

Tolerances: the splits, class weights, label codes, reports and the
aggregation exactly; the scaler to 1e-6; the layers, the loss and an Adam
step to 1e-5 (one fp32 expression in two orders); the fit's parameters to
1e-5 of each tensor's largest entry, its validation accuracies exactly; a
population of one bit for bit; a member of an uneven population to 1e-5 of
each tensor's largest entry (batched products; on this CPU they happen to
give the same bits).

The JAX oracles are ``fit_classifier`` (jit, no vmap) and the unjitted
pieces: the vmapped MLP aborts natively under xdist
(``test_downstream_vmap.py``), so ``fit_classifier_folds`` and the grouped
runs of the JAX package are not called here. Each JAX fit runs once, in a
module-scoped fixture.
"""

import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import classification_report as sk_report
from sklearn.model_selection import StratifiedKFold, train_test_split
from sklearn.preprocessing import LabelEncoder, StandardScaler
from sklearn.utils.class_weight import compute_class_weight

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.data import splits as port_splits
from vae_los_angeles_torch.data.dataset import MultiModalDataset
from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
from vae_los_angeles_torch.evaluation import downstream as port_ds
from vae_los_angeles_torch.evaluation import downstream_directional as port_dd
from vae_los_angeles_torch.evaluation import mlp_classifier as port_mc
from vae_los_angeles_torch.models.directional_vae import dna2rna_vae_init, rna2dna_vae_init
from vae_los_angeles_torch.models.vae import multimodal_vae_init
from vae_los_angeles_torch.ops import nn as port_nn
from vae_los_angeles_torch.ops import optim as port_optim
from vae_los_angeles_torch.ops.metrics import classification_report, format_report
from vae_los_angeles_torch.training import checkpoint as port_ckpt
from vae_los_angeles_torch.utils.tree import tree_map
from vae_los_angeles_torch.utils.weights import tree_to_numpy
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.data.synthetic import write_synthetic_artifacts
from vae_los_angeles_tpu.evaluation import downstream as jax_ds
from vae_los_angeles_tpu.evaluation import mlp_classifier as jax_mc
from vae_los_angeles_tpu.ops import optim as jax_optim

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

LAYER = dict(atol=1e-5, rtol=1e-5)
N_CLASSES, DIM, BATCH = 5, 36, 32
JAX_EPOCHS = 20


def blobs(seed, n=120, dim=DIM, k=N_CLASSES, spread=2.5):
    """Rows around one centre a class, overlapping enough that accuracies
    move between epochs."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, dim)).astype(np.float32)
    y = rng.integers(0, k, n)
    x = (centres[y] + spread * rng.normal(size=(n, dim))).astype(np.float32)
    return x, y


def relative(got, want):
    """Largest |got - want| over the largest |want| (a tiny floor only
    against an all-zero ``want``)."""
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), np.finfo(np.float32).tiny)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / scale)


def held(port_params, jax_params, tol, tie_step=None):
    """Each tensor within ``tol`` of its largest entry. With ``tie_step``,
    at most one element in 10⁴ of a tensor (at least one) may lie beyond,
    within ``tie_step`` of JAX's: a unit whose ReLU input sits at an fp32
    tie with 0 in one implementation has a gradient of rounding size there,
    which Adam scales up to a step of up to lr."""
    got = tree_to_numpy(port_params)
    for layer, leaves in jax_params.items():
        for name, want in leaves.items():
            err = relative(got[layer][name], want)
            if tie_step is None or err <= tol:
                assert err <= tol, f"{layer}.{name}: {err:.3g}"
                continue
            diff = np.abs(got[layer][name] - want)
            beyond = diff > tol * np.max(np.abs(want))
            assert beyond.sum() <= max(1, want.size // 10_000), f"{layer}.{name}: {err:.3g}"
            assert diff.max() <= tie_step, f"{layer}.{name}: {diff.max():.3g}"


def same_bits(a, b):
    return all(torch.equal(a[k][n], b[k][n]) for k in a for n in a[k])


# --- splits, scaler, class weights, label codes, reports against sklearn -------

LAYOUTS = {
    "balanced": np.repeat(np.arange(4), 10),
    "a class of exactly n_splits rows": np.r_[np.zeros(5), np.ones(17), np.full(9, 2)],
    "a class missing from some folds": np.r_[np.zeros(2), np.ones(20), np.full(13, 7)],
    "shuffled codes": np.random.default_rng(3).choice([4, 9, 2, 11], size=57,
                                                      p=[0.4, 0.3, 0.2, 0.1]),
}


@pytest.mark.parametrize("seed", (0, 42))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stratified_kfold_is_sklearns(layout, seed):
    y = LAYOUTS[layout].astype(np.int64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = list(StratifiedKFold(5, shuffle=True, random_state=seed).split(np.zeros(len(y)), y))
        got = port_splits.stratified_kfold_indices(y, 5, seed)
    assert len(got) == len(want) == 5
    for (tr, va), (wtr, wva) in zip(got, want):
        np.testing.assert_array_equal(tr, wtr)
        np.testing.assert_array_equal(va, wva)
    if layout == "a class missing from some folds":
        assert any(0 not in y[va] for _, va in got)


def test_stratified_kfold_refuses_and_warns_as_sklearn():
    y = np.r_[np.zeros(3), np.ones(4)].astype(np.int64)
    with pytest.raises(ValueError, match="cannot be greater than the number of members"):
        port_splits.stratified_kfold_indices(y, 5, 0)
    with pytest.raises(ValueError, match="greater than the number of samples"):
        port_splits.stratified_kfold_indices(y, 8, 0)
    with pytest.warns(UserWarning, match="least populated class in y has only 3 members"):
        port_splits.stratified_kfold_indices(y, 4, 0)


@pytest.mark.parametrize("seed", (0, 7, 42))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stratified_train_test_split_is_sklearns(layout, seed):
    y = LAYOUTS[layout].astype(np.int64)
    idx = np.arange(len(y))
    want_tr, want_te = train_test_split(idx, test_size=0.2, random_state=seed, stratify=y)
    got_tr, got_te = port_splits.stratified_train_test_split(y, 0.2, seed)
    np.testing.assert_array_equal(got_tr, want_tr)
    np.testing.assert_array_equal(got_te, want_te)


def test_stratified_train_test_split_refuses_a_single_member_class():
    with pytest.raises(ValueError, match="only 1 member"):
        port_splits.stratified_train_test_split(np.r_[np.zeros(9), 1], 0.2, 0)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_class_weights_scaler_and_label_codes_are_sklearns(layout):
    y = LAYOUTS[layout].astype(np.int64)
    classes = np.unique(y)
    np.testing.assert_array_equal(port_splits.balanced_class_weight(classes, y),
                                  compute_class_weight("balanced", classes=classes, y=y))
    with pytest.raises(ValueError, match="valid labels"):
        port_splits.balanced_class_weight(np.r_[classes, 99], y)
    rng = np.random.default_rng(len(y))
    x = (rng.normal(size=(len(y), 11)) * rng.uniform(0.1, 30, 11) + rng.uniform(-9, 9, 11))
    x = x.astype(np.float32)
    x[:, 4] = 2.5  # a constant column keeps a scale of 1
    got, want = port_splits.standard_scale(x), StandardScaler().fit_transform(x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    names = np.array(["lung", "brain", "skin", "liver", "colon"])[y % 5]
    codes, le = port_splits.LabelCodes(), LabelEncoder()
    np.testing.assert_array_equal(codes.fit_transform(names), le.fit_transform(names))
    np.testing.assert_array_equal(codes.classes_, le.classes_)


REPORT_CASES = {
    "mostly right": ([0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 0], [0, 1, 2, 3, 1, 0, 1, 2, 4, 4, 0, 2]),
    "a class never predicted": ([0, 1, 2, 2, 1, 0, 3, 3], [0, 1, 1, 1, 1, 0, 0, 1]),
    "a class with no support": ([0, 1, 1, 0, 2, 2], [0, 1, 3, 0, 2, 4]),
    "all wrong": ([0, 0, 1, 1], [1, 1, 0, 0]),
}


@pytest.mark.parametrize("case", sorted(REPORT_CASES))
def test_classification_report_is_sklearns(case):
    y_true, y_pred = (np.asarray(a) for a in REPORT_CASES[case])
    names = np.array(["brain", "colon", "liver", "lung", "skin"])
    for labels in (np.arange(5), np.arange(3)):  # the second leaves out labels that occur
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = sk_report(y_true, y_pred, labels=labels, target_names=names[labels],
                             output_dict=True, zero_division=0)
        got = classification_report(y_true, y_pred, labels, names[labels], zero_division=0)
        assert list(got) == list(want)
        assert got == want
    text = format_report(got)
    assert "weighted avg" in text and "brain" in text


def test_aggregated_report_is_jaxs():
    """The port's per-fold reports and their aggregate equal sklearn's and
    the JAX package's ``_aggregate_fold_reports`` on the same per-fold
    predictions, a class absent from one fold's validation rows included."""
    rng = np.random.default_rng(5)
    names = np.array(["brain", "colon", "liver", "lung"])
    le_sk, le_port = LabelEncoder().fit(names), port_splits.LabelCodes().fit(names)
    sk_reports, port_reports = [], []
    for fold in range(5):
        y_true = rng.integers(0, 4 if fold else 3, 17)  # fold 0 has no "lung" row
        y_pred = np.where(rng.random(17) < 0.6, y_true, rng.integers(0, 4, 17))
        sk_reports.append(sk_report(y_true, y_pred, labels=np.arange(4), target_names=names,
                                    output_dict=True, zero_division=0))
        port_reports.append(port_ds._report(y_true, y_pred, le_port))
        assert port_reports[-1] == sk_reports[-1]
    assert (port_ds._aggregate_fold_reports(port_reports, le_port)
            == jax_ds._aggregate_fold_reports(sk_reports, le_sk))


# --- the MLP's layers, loss and optimizer against the JAX package --------------

def jax_params(arch, seed=0, dim=DIM):
    return jax.tree.map(np.asarray, jax_mc.mlp_init(jax.random.PRNGKey(seed), dim, N_CLASSES,
                                                    arch))


def jax_masks(arch, key, rows=BATCH):
    """The {0, 1} dropout masks JAX's ``mlp_apply`` draws from ``key``."""
    widths, rates = port_mc.HIDDEN[arch], port_mc.DROPOUT[arch]
    keys = jax.random.split(key) if arch == "deep" else (key,)
    return tuple(np.asarray(jax.random.bernoulli(k, 1.0 - r, (rows, w)), np.float32)
                 for k, w, r in zip(keys, widths, rates))


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_weight_bridge_round_trip_and_bucketed_rows():
    """The bridge copies both ways; a JAX fit at a bucketed width (fc1's
    zero rows past the true width) predicts the same classes in the port,
    its inputs' columns padded."""
    p = jax_params("deep")
    port = port_mc.mlp_params_from_jax(p, "deep")
    back = port_mc.mlp_params_to_jax(port)
    assert jax.tree.all(jax.tree.map(np.array_equal, back, p))
    padded = dict(p, fc1={"w": np.pad(p["fc1"]["w"], ((0, 92), (0, 0))), "b": p["fc1"]["b"]})
    x, _ = blobs(2, n=20)
    np.testing.assert_array_equal(
        port_mc.predict_classes(port_mc.mlp_params_from_jax(padded, "deep"), x),
        jax_mc.predict_classes(padded, x))
    with pytest.raises(ValueError, match="keys"):
        port_mc.mlp_params_from_jax(jax_params("shallow"), "deep")


def test_init_draws_like_nn_linear():
    """Each layer's weight then bias from the generator, U(±1/√fan_in), as
    ``nn.Linear`` draws them; LayerNorm γ = 1, β = 0."""
    p = port_mc.mlp_init(torch.Generator().manual_seed(3), DIM, N_CLASSES, "deep")
    g = torch.Generator().manual_seed(3)
    for name, (n_in, n_out) in zip(("fc1", "fc2", "fc3"), ((DIM, 256), (256, 128),
                                                             (128, N_CLASSES))):
        bound = 1.0 / np.sqrt(n_in)
        w = torch.empty(n_out, n_in).uniform_(-bound, bound, generator=g)
        b = torch.empty(n_out).uniform_(-bound, bound, generator=g)
        assert torch.equal(p[name]["w"], w.t()) and torch.equal(p[name]["b"], b)
    assert torch.equal(p["ln2"]["gamma"], torch.ones(128))
    assert list(p) == ["fc1", "ln1", "fc2", "ln2", "fc3"]


@pytest.mark.parametrize("arch", ("deep", "shallow"))
def test_mlp_apply_matches_jax(arch):
    p = jax_params(arch, seed=1)
    x, _ = blobs(1, n=BATCH)
    port = port_mc.mlp_params_from_jax(p, arch)
    np.testing.assert_allclose(port_mc.mlp_apply(port, t(x), arch=arch).numpy(),
                               jax_mc.mlp_apply(p, jnp.asarray(x), arch=arch), **LAYER)
    key = jax.random.PRNGKey(9)
    want = jax_mc.mlp_apply(p, jnp.asarray(x), arch=arch, train=True, key=key)
    got = port_mc.mlp_apply(port, t(x), arch=arch, train=True,
                            masks=tuple(t(m) for m in jax_masks(arch, key)))
    np.testing.assert_allclose(got.numpy(), want, **LAYER)
    # a member axis: two stacked members, each its own forward
    both = tree_map(lambda a: torch.stack([a, 2.0 * a]), port)
    got2 = port_mc.mlp_apply(both, torch.stack([t(x), t(x[::-1].copy())]), arch=arch)
    np.testing.assert_array_equal(got2[0].numpy(), port_mc.mlp_apply(port, t(x), arch=arch))


def test_layernorm_and_weighted_ce_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(BATCH, 48)) * 3 + 1).astype(np.float32)
    p = {"gamma": rng.uniform(0.5, 1.5, 48).astype(np.float32),
         "beta": rng.normal(size=48).astype(np.float32)}
    np.testing.assert_allclose(port_nn.layernorm_apply({k: t(v) for k, v in p.items()}, t(x)),
                               jax_mc._layernorm_apply(p, jnp.asarray(x)), **LAYER)
    stacked = {k: torch.stack([t(v), t(v)]) for k, v in p.items()}
    np.testing.assert_array_equal(port_nn.layernorm_apply(stacked, torch.stack([t(x)] * 2))[1],
                                  port_nn.layernorm_apply({k: t(v) for k, v in p.items()}, t(x)))
    logits = rng.normal(size=(BATCH, N_CLASSES)).astype(np.float32) * 4
    y = rng.integers(0, N_CLASSES, BATCH)
    cw = rng.uniform(0.3, 3.0, N_CLASSES).astype(np.float32)
    np.testing.assert_allclose(
        port_mc.weighted_ce_mean(t(logits), t(y, torch.int64), t(cw)).item(),
        float(jax_mc.weighted_ce_mean(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(cw))),
        **LAYER)


def moments(p, seed):
    """A non-zero Adam state (away from the first step's ±lr)."""
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda a: rng.normal(scale=1e-2, size=a.shape).astype(np.float32), p)
    v = jax.tree.map(lambda a: rng.uniform(1e-5, 1e-3, size=a.shape).astype(np.float32), p)
    return {"step": np.int32(3), "m": m, "v": v}


def port_state(s):
    return {"step": torch.tensor(int(s["step"]), dtype=torch.int32),
            "m": port_mc.mlp_params_from_jax(s["m"], "deep"),
            "v": port_mc.mlp_params_from_jax(s["v"], "deep")}


def test_adam_update_matches_jax_with_coupled_decay():
    p = jax_params("deep", seed=4)
    rng = np.random.default_rng(4)
    g = jax.tree.map(lambda a: rng.normal(scale=0.1, size=a.shape).astype(np.float32), p)
    s = moments(p, 4)
    want_p, want_s = jax_optim.adam_update(p, g, s, jnp.float32(1e-3), jnp.float32(1e-4))
    got_p, got_s = port_optim.adam_update(port_mc.mlp_params_from_jax(p, "deep"),
                                          port_mc.mlp_params_from_jax(g, "deep"), port_state(s),
                                          torch.tensor(1e-3), 1e-4)
    assert int(got_s["step"]) == int(want_s["step"]) == 4
    for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]), (got_s["v"], want_s["v"])):
        for k in want:
            for n in want[k]:
                np.testing.assert_allclose(got[k][n].numpy(), want[k][n], **LAYER)
    # a member axis with one rate and one step a member: each member its own update
    stack = lambda tree: tree_map(lambda a: torch.stack([a, a]), tree)  # noqa: E731
    pp = stack(port_mc.mlp_params_from_jax(p, "deep"))
    ss = {"step": torch.tensor([3, 3], dtype=torch.int32),
          "m": stack(port_state(s)["m"]), "v": stack(port_state(s)["v"])}
    pop_p, pop_s = port_optim.adam_update(pp, stack(port_mc.mlp_params_from_jax(g, "deep")), ss,
                                          torch.tensor([1e-3, 1e-3]), 1e-4)
    assert pop_s["step"].tolist() == [4, 4]
    assert same_bits(tree_map(lambda a: a[1], pop_p), got_p)


def jax_grad_fn(arch, n_train, n_val):
    """JAX's own ``value_and_grad(loss_fn)`` of the fold fit (a free
    variable of the fit function `_make_fold_fit` returns)."""
    fit = jax_mc._make_fold_fit(arch, 1, BATCH, n_train, n_val, arch == "deep")
    cells = dict(zip(fit.__code__.co_freevars, (c.cell_contents for c in fit.__closure__)))
    return cells["grad_fn"]


@pytest.mark.parametrize("arch", ("deep", "shallow"))
def test_one_training_step_matches_jax(arch):
    """The weighted loss over a batch with masked rows (weight 0), its
    gradients, then Adam with coupled decay, on the same rows and dropout
    masks."""
    p = jax_params(arch, seed=5)
    x, y = blobs(5, n=BATCH)
    mask = (np.arange(BATCH) < 27).astype(np.float32)  # a last batch of 27 rows
    cw = np.random.default_rng(5).uniform(0.5, 2.0, N_CLASSES).astype(np.float32)
    key = jax.random.PRNGKey(11)
    loss, grads = jax_grad_fn(arch, 90, 30)(p, key, jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(cw), jnp.asarray(mask))
    port = port_mc.mlp_params_from_jax(p, arch)
    got_loss, got_grads = port_mc._grads(port, t(x), t(y, torch.int64), t(cw), t(mask) > 0,
                                         tuple(t(m) for m in jax_masks(arch, key)), arch)
    np.testing.assert_allclose(got_loss.item(), float(loss), **LAYER)
    held(got_grads, jax.tree.map(np.asarray, grads), 1e-5)
    s = jax.tree.map(np.asarray, jax_optim.adamw_init(p))
    want_p, _ = jax_optim.adam_update(p, grads, s, jnp.float32(1e-3), jnp.float32(1e-4))
    got_p, _ = port_optim.adam_update(port, got_grads, {
        "step": torch.tensor(0, dtype=torch.int32),
        "m": port_mc.mlp_params_from_jax(s["m"], arch),
        "v": port_mc.mlp_params_from_jax(s["v"], arch)}, torch.tensor(1e-3), 1e-4)
    held(got_p, jax.tree.map(np.asarray, want_p), 1e-5)


# --- the fit against JAX's fit_classifier, given JAX's draws -------------------

FIT = {"deep": dict(weight_decay=1e-4, early_stop=True),
       "shallow": dict(weight_decay=0.0, early_stop=False)}


def jax_noise(arch, key, n_train):
    """`_fit`'s ``noise`` seam fed with ``_make_fold_fit``'s own draws:
    epoch e's permutation from ``fold_in(key, e)``'s first split (a masked
    argsort of uniforms), batch b's masks from ``fold_in`` of its second."""
    def noise(member, epoch, n_batches):
        pkey, dkey = jax.random.split(jax.random.fold_in(key, epoch))
        perm = np.array(jnp.argsort(jax.random.uniform(pkey, (n_train,))))
        per_batch = [jax_masks(arch, jax.random.fold_in(dkey, b)) for b in range(n_batches)]
        masks = tuple(torch.stack([t(m[k]) for m in per_batch]) for k in range(len(per_batch[0])))
        return torch.as_tensor(perm, dtype=torch.int64), masks
    return noise


@pytest.fixture(scope="module", params=("deep", "shallow"))
def jax_fit(request):
    """JAX's ``fit_classifier`` of 90 training and 30 validation rows (a
    partial last batch of 26), rows and columns at their true sizes, for
    `JAX_EPOCHS`: on these overlapping blobs the validation loss turns, so
    the plateau halves the rate in both fits and the deep one stops early;
    waited on."""
    arch = request.param
    x, y = blobs(6, spread=6.0)
    cw = compute_class_weight("balanced", classes=np.arange(N_CLASSES), y=y[:90])
    cw = cw.astype(np.float32)
    key = jax.random.PRNGKey(3)
    mp = pytest.MonkeyPatch()
    mp.setenv("EVAL_BUCKET", "0")
    mp.setenv("DOWNSTREAM_DIM_BUCKET", "0")
    try:
        fit = jax_mc.fit_classifier(x[:90], y[:90], x[90:], y[90:], N_CLASSES, cw, key,
                                    arch=arch, num_epochs=JAX_EPOCHS, batch_size=BATCH, lr=1e-3,
                                    **FIT[arch])
        fit = jax.tree.map(np.asarray, jax.block_until_ready(fit))
    finally:
        mp.undo()
    return arch, (x, y, cw, key), fit


def test_fit_matches_jax_given_its_draws(jax_fit, monkeypatch):
    """A population of one given JAX's draws: the validation accuracies
    equal (the NaNs after the deep fit's stop in the same epochs), the
    plateau's halving in both, and the final parameters (the deep fit's
    best snapshot, ten epochs before its stop) within 1e-5 of each
    tensor's largest entry, but for an fp32 tie (`held`)."""
    arch, (x, y, cw, key), want = jax_fit
    p0 = jax.tree.map(np.asarray, jax_mc.mlp_init(key, DIM, N_CLASSES, arch))  # the fit's init
    params0 = tree_map(lambda a: a[None], port_mc.mlp_params_from_jax(p0, arch))
    rates, plateau_step = [], port_optim.plateau_step

    def spy(*args):
        out = plateau_step(*args)
        rates.append(float(out["lr"][0]))
        return out

    monkeypatch.setattr(port_optim, "plateau_step", spy)
    one = lambda a, dtype=torch.float32: t(a, dtype)[None]  # noqa: E731
    got = port_mc._fit(params0, one(x[:90]), one(y[:90], torch.int64), [90], one(x[90:]),
                       one(y[90:], torch.int64), [30], one(cw), [3], arch=arch,
                       num_epochs=JAX_EPOCHS, batch_size=BATCH, lr=1e-3,
                       noise=jax_noise(arch, key, 90), **FIT[arch])
    np.testing.assert_array_equal(got.val_accs[0], want.val_accs)  # NaN positions included
    assert len(set(got.val_accs[0].tolist())) > 1  # the accuracies move
    assert min(rates) <= np.float32(5e-4)  # the plateau halved the rate
    ran = np.flatnonzero(~np.isnan(want.val_accs))
    if arch == "deep":  # stopped, rolled back to the epoch of its best accuracy
        assert len(ran) < JAX_EPOCHS
        assert int(np.argmax(want.val_accs[ran])) == ran[-1] - port_mc.STOP_PATIENCE
    else:
        assert len(ran) == JAX_EPOCHS
    assert got.best_val_acc[0] == want.best_val_acc
    held(tree_map(lambda a: a[0], got.params), want.params, 1e-5, tie_step=1e-3)


# --- populations against single fits -------------------------------------------

def folds_of(x, y, n_folds=3):
    splits = port_splits.stratified_kfold_indices(y, n_folds, 42)
    return [(x[tr], y[tr], x[va], y[va],
             port_ds.fold_class_weights(y, [(tr, va)], N_CLASSES)[0]) for tr, va in splits]


@pytest.mark.parametrize("arch", ("deep", "shallow"))
def test_population_of_one_is_its_single_fit(arch):
    """`fit_classifier`, a population of one through the stacked and masked
    loop, equals the single fit written plainly (``chip_smoke``'s 2-D
    loop, which the card holds it against too) bit for bit, through an
    early stop (deep) or the fixed epochs (shallow)."""
    import chip_smoke

    x, y = blobs(7, n=100, spread=0.8)
    fold = folds_of(x, y)[1]
    kw = dict(arch=arch, num_epochs=16, batch_size=BATCH, lr=1e-3, device="cpu", **FIT[arch])
    one = chip_smoke.plain_classifier_fit(fold, N_CLASSES, 1, **kw)
    pop = port_mc.fit_classifier(*fold[:4], N_CLASSES, fold[4], 1, **kw)
    assert chip_smoke.same_fit(one, pop)
    if arch == "deep":
        assert np.isnan(one.val_accs).any()  # the early stop and its rollback ran


def test_uneven_population_matches_each_single_fit():
    """Three uneven folds (66/67/67 training rows, 34/33/33 validation),
    separable enough that members stop at different epochs: each member is
    its single fit to fp32 order, its accuracies exactly."""
    x, y = blobs(8, n=100, spread=0.8)
    folds = folds_of(x, y)
    assert len({len(f[0]) for f in folds}) > 1 and len({len(f[2]) for f in folds}) > 1
    pop = port_mc.fit_classifier_folds(folds, N_CLASSES, num_epochs=30, device="cpu")
    stops = np.isnan(pop.val_accs).sum(1)
    assert stops.min() > 0 and len(set(stops.tolist())) > 1, stops  # the stops differ
    for i, f in enumerate(folds):
        one = port_mc.fit_classifier(*f[:4], N_CLASSES, f[4], i, num_epochs=30, device="cpu")
        np.testing.assert_array_equal(one.val_accs, pop.val_accs[i])
        held(tree_map(lambda a: a[i], pop.params), tree_to_numpy(one.params), 1e-5)
    preds = port_mc.predict_classes_folds(pop.params, [f[2] for f in folds])
    assert preds.shape == (3, 34)
    np.testing.assert_array_equal(preds[2, :33], port_mc.predict_classes(
        tree_map(lambda a: a[2], pop.params), folds[2][2]))


def test_population_refusals_and_padding_rules():
    x, y = blobs(9, n=60)
    f = folds_of(x, y)
    with pytest.raises(ValueError, match="one feature width"):
        port_mc.fit_classifier_folds([f[0], (f[1][0][:, :5],) + f[1][1:]], N_CLASSES,
                                     device="cpu")
    with pytest.raises(ValueError, match="arch"):
        port_mc.fit_classifier(*f[0][:4], N_CLASSES, f[0][4], 0, arch="wide", device="cpu")
    fit = port_mc.fit_classifier(*f[0][:4], N_CLASSES, f[0][4], 0, num_epochs=1, device="cpu")
    narrow = port_mc.predict_classes(fit.params, f[0][2][:, :30])  # zero-padded columns
    assert narrow.shape == (len(f[0][2]),)
    with pytest.raises(ValueError, match="wider"):
        port_mc.predict_classes(fit.params, np.zeros((2, DIM + 1), np.float32))


def test_grouped_scenarios_equal_each_scenario_and_each_fold():
    """`run_scenarios_grouped` (widths 36 and 20, one population each),
    one population a scenario (`run_classification_scenario`) and each
    fold alone (`train_and_evaluate_fold`) give the same reports."""
    x, y = blobs(10, n=70)
    labels = y
    le = port_splits.LabelCodes().fit(np.arange(N_CLASSES))
    scenarios = {"a": x, "b": x[:, :20] * 2.0, "c": x[::-1].copy()}
    grouped = port_ds.run_scenarios_grouped(scenarios, labels, N_CLASSES, le, n_folds=3,
                                            device="cpu")
    assert list(grouped) == ["a", "b", "c"]
    splits = port_splits.stratified_kfold_indices(labels, 3, 42)
    cws = port_ds.fold_class_weights(labels, splits, N_CLASSES)
    for name, feats in scenarios.items():
        alone = port_ds.run_classification_scenario(feats, labels, N_CLASSES, name, le,
                                                    n_folds=3, device="cpu")
        assert alone == grouped[name]
        scaled = port_splits.standard_scale(feats)
        reports = [port_ds.train_and_evaluate_fold(
            scaled[tr], scaled[va], labels[tr], labels[va], N_CLASSES, cw, le, seed=f,
            device="cpu") for f, ((tr, va), cw) in enumerate(zip(splits, cws))]
        assert port_ds._aggregate_fold_reports(reports, le) == grouped[name]
    assert 0.0 <= grouped["a"]["accuracy"] <= 1.0 and "weighted avg" in grouped["a"]


def test_directional_population_equals_each_scenario():
    x, y = blobs(11, n=80)
    le = port_splits.LabelCodes().fit(np.arange(N_CLASSES))
    cw = np.ones(N_CLASSES, np.float32)
    scenarios = {"a": x, "b": x * 0.5, "c": x[:, :12]}
    pop = port_dd.run_scenarios_vmapped(scenarios, y, N_CLASSES, cw, le, device="cpu")
    for name, feats in scenarios.items():
        assert pop[name] == port_dd.run_classification_scenario(feats, y, N_CLASSES, cw, name, le,
                                                                device="cpu")


# --- the entry points on a tiny cohort -------------------------------------------

DIM_A, DIM_B, N_SITES, LATENT = 24, 32, 4, 6


@pytest.fixture
def cohort(tmp_path):
    """Arrays of 130 samples and random-weight checkpoints of the three
    models, their run-id files in ``tmp_path``."""
    data = generate_synthetic_arrays(n_samples=130, dim_a=DIM_A, dim_b=DIM_B, n_sites=N_SITES,
                                     seed=4)
    for name, init, seed in (("multivae", multimodal_vae_init, 0), ("rna2dna", rna2dna_vae_init, 1),
                             ("dna2rna", dna2rna_vae_init, 2)):
        params, state = init(torch.Generator().manual_seed(seed), DIM_A, DIM_B, N_SITES, LATENT)
        port_ckpt.save_best(name, "20260102_030405", tree_to_numpy(params),
                            tree_to_numpy(state), str(tmp_path / "checkpoints"))
        port_ckpt.write_run_id(name, "20260102_030405", str(tmp_path))
    cfg = PortConfig(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT,
                     checkpoint_dir=str(tmp_path / "checkpoints"), plots_dir=str(tmp_path / "p"))
    return data, cfg


def test_prepare_filtered_val_data_matches_jax(tmp_path):
    """The kept validation rows, re-encoded labels, class names and
    original site codes equal the JAX package's on its own pickle (classes
    of one validation row dropped); with ``data=`` arrays the same rows and
    codes, the codes standing for the names."""
    write_synthetic_artifacts(str(tmp_path), n_samples=70, dim_a=DIM_A, dim_b=DIM_B, n_sites=12,
                              n_unmatched=2)
    want = jax_ds.prepare_filtered_val_data(JaxConfig(data_dir=str(tmp_path)), True)
    got = port_ds.prepare_filtered_val_data(PortConfig(data_dir=str(tmp_path)), True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3].classes_, want[3].classes_)
    np.testing.assert_array_equal(got[4], want[4])
    assert len(want[4]) < 14 and len(np.unique(want[4])) < 12  # classes were dropped
    ds = MultiModalDataset.from_pickle(str(tmp_path / "processed_data.pkl"))
    arrays = port_ds.prepare_filtered_val_data(
        PortConfig(), True, data=(ds.tpm_data, ds.beta_data, ds.primary_site))
    np.testing.assert_array_equal(arrays[0], want[0])
    np.testing.assert_array_equal(arrays[4], want[4])
    np.testing.assert_array_equal(arrays[3].classes_[arrays[2]], want[4])


def test_downstream_main_on_the_cpu(cohort, tmp_path, monkeypatch, capsys):
    data, cfg = cohort
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on the card's machine
    got = port_ds.main(cfg, n_folds=3, data=data, device="cpu", root=str(tmp_path))
    assert list(got) == list(port_ds.scenarios_of(*[np.zeros((1, 1))] * 4))
    _, _, labels, le = port_ds.prepare_filtered_val_data(cfg, data=data)
    assert le.classes_.tolist() == sorted(set(le.classes_.tolist()))  # the site codes
    for agg in got.values():
        assert 0.0 <= agg["accuracy"] <= 1.0 and np.isfinite(agg["weighted avg"]["f1-score"])
    assert capsys.readouterr().out.count("matplotlib unavailable") == 2


def test_downstream_directional_main_on_the_cpu(cohort, tmp_path, monkeypatch):
    """The directional flow conditions the models on the ORIGINAL site
    codes (the kept validation rows' own), not the re-encoded labels, and
    writes its two plots."""
    data, cfg = cohort
    seen = []
    real = port_dd.generate_estimated_dna
    monkeypatch.setattr(port_dd, "generate_estimated_dna",
                        lambda m, x, s: seen.append(np.asarray(s)) or real(m, x, s))
    got = port_dd.main(cfg, data=data, device="cpu", root=str(tmp_path))
    assert list(got) == ["Orig. RNA", "Orig. RNA + Est. DNA", "Orig. DNA + Est. RNA",
                         "Orig. RNA + Orig. DNA"]
    _, _, labels, le, orig = port_ds.prepare_filtered_val_data(cfg, True, data=data)
    np.testing.assert_array_equal(seen[0], orig)
    np.testing.assert_array_equal(le.classes_[labels], orig)
    for report in got.values():
        assert 0.0 <= report["accuracy"] <= 1.0
    out = tmp_path / "p" / "downstream_task_directional"
    assert len(list(out.glob("*.png"))) == 2


def test_entry_points_raise_without_a_card(cohort, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("DEVICE", raising=False)
    data, cfg = cohort
    x, y = blobs(12, n=40)
    calls = (lambda: port_ds.main(cfg, data=data, root=str(tmp_path)),
             lambda: port_dd.main(cfg, data=data, root=str(tmp_path)),
             lambda: port_mc.fit_classifier(x, y, x, y, N_CLASSES, np.ones(N_CLASSES), 0),
             lambda: port_mc.fit_classifier_folds(folds_of(x, y), N_CLASSES))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    monkeypatch.setenv("DEVICE", "cpu")
    assert port_dd.main(PortConfig.from_env().replace(
        input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT,
        checkpoint_dir=cfg.checkpoint_dir, plots_dir=str(tmp_path / "q")), data=data,
        root=str(tmp_path)) is not None
    assert os.path.isdir(tmp_path / "q")
