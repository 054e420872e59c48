"""The tri-modal MultiModalVAE slice against the JAX package: the losses,
the model over its 7 modality subsets, the plain versions of the train step
and the epoch (``ops/kernels/fused_train.py``, ``ops/kernels/fused_epoch.py``)
against the JAX Pallas kernels in interpret mode and ``jax.grad`` of an XLA
forward, the balanced class weights, the engine, the CLI, the loader and
the evaluation. The CUDA kernels are held against these plain versions on
the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Widths are the JAX tests' (``tests/test_pallas_multimodal.py``): RNA 36 and
DNA 52 (so a swap of a and b raises on shape), 5 sites, latent 8, embedding
16, the fixed hidden widths; γ = 1.7 and class weights uniform(0.5, 2.0).
Each interpret-mode JAX kernel runs once in this module and is waited on
before anything else is dispatched.

Tolerances are the JAX tests': the step's loss rtol 1e-5, the 39 gradients
atol 1e-3 + rtol 1e-4 (2e-3 for the three biases that feed train-mode BN,
whose true gradient is zero), BN stats atol 1e-5; the epoch (4 steps of 8)
losses rtol 1e-5, params and m atol 5e-5 (5e-3 for those three biases),
BN atol 2e-4."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
from vae_los_angeles_torch.evaluation import evaluate as port_eval
from vae_los_angeles_torch.evaluation import loading as port_loading
from vae_los_angeles_torch.models import MultiModalVAE
from vae_los_angeles_torch.models import vae as port_vae
from vae_los_angeles_torch.ops import losses as port_losses
from vae_los_angeles_torch.ops import optim as port_optim
from vae_los_angeles_torch.ops.kernels import fused_epoch as fe
from vae_los_angeles_torch.ops.kernels import fused_train as ft
from vae_los_angeles_torch.ops.metrics import compute_imputation_metrics
from vae_los_angeles_torch.training import checkpoint as port_ckpt
from vae_los_angeles_torch.training import cli as port_cli
from vae_los_angeles_torch.training import engine as port_engine
from vae_los_angeles_torch.training import tasks
from vae_los_angeles_torch.utils.tree import tree_map
from vae_los_angeles_torch.utils.weights import (
    jax_from_state_dict,
    state_dict_from_jax,
    tree_from_numpy,
    tree_to_numpy,
)
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.data.dataset import MultiModalArrays
from vae_los_angeles_tpu.evaluation import loading as jax_loading
from vae_los_angeles_tpu.models import vae as jvae
from vae_los_angeles_tpu.ops import losses as jlosses
from vae_los_angeles_tpu.ops.nn import batchnorm_apply, linear_apply, relu
from vae_los_angeles_tpu.ops.pallas import fused_epoch_multimodal as jfe
from vae_los_angeles_tpu.ops.pallas import fused_train_multimodal as jft
from vae_los_angeles_tpu.training import engine as jax_engine

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, EMBED, B = 36, 52, 5, 8, 16, 16
HA, HB1, HB2 = 128, 512, 256
GAMMA, BETA, LR, WD = 1.7, 1e-3, 5e-4, 1e-5
BATCH, N_BATCHES, STEP0 = 8, 4, 3
GRAD = dict(atol=1e-3, rtol=1e-4)
CHAIN = dict(atol=1e-5, rtol=1e-5)
ZERO_GRAD = {"a_b1", "b_b1", "b_b2"}  # the encoder fc biases feeding train-mode BatchNorm
SUBSETS = [(a, b, s) for a in (0, 1) for b in (0, 1) for s in (0, 1) if a or b or s]


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def make_case(seed=0, rows=B):
    """JAX-initialised weights with moved BN stats, RNA and DNA rows, sites,
    class weights and injected noise, all from a numpy seed."""
    rng = np.random.default_rng(seed)
    params, state = jvae.multimodal_vae_init(jax.random.PRNGKey(seed), DIM_A, DIM_B, N_SITES,
                                             LATENT, EMBED)
    state = jax.tree.map(
        lambda x: x + 0.2 * jax.random.uniform(jax.random.PRNGKey(seed + 1), x.shape), state)
    data = dict(
        a=rng.normal(size=(rows, DIM_A)).astype(np.float32),
        b=rng.uniform(0.02, 0.98, size=(rows, DIM_B)).astype(np.float32),
        site=rng.integers(0, N_SITES, size=(rows,)),
        eps=rng.normal(size=(rows, LATENT)).astype(np.float32),
        drop_a=(rng.uniform(size=(rows, HA)) < 0.9).astype(np.float32),
        drop_b1=(rng.uniform(size=(rows, HB1)) < 0.9).astype(np.float32),
        drop_b2=(rng.uniform(size=(rows, HB2)) < 0.9).astype(np.float32),
    )
    cw = rng.uniform(0.5, 2.0, size=N_SITES).astype(np.float32)
    return _np(params), _np(state), data, cw


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


NOISE = ("eps", "drop_a", "drop_b1", "drop_b2")


def port_step(params, state, d, cw, **kw):
    t = _t(d)
    return ft.multimodal_fused_train_step(
        tree_from_numpy(params), tree_from_numpy(state), t["a"], t["b"], t["site"], N_SITES,
        beta=BETA, gamma=GAMMA, class_weights=torch.from_numpy(cw),
        **{k: t[k] for k in NOISE}, **kw)


@pytest.fixture(scope="module")
def case():
    params, state, d, cw = make_case()
    # the Pallas kernel in interpret mode, waited for before any other JAX work
    pallas = jax.block_until_ready(jft.multimodal_fused_train_step(
        params, state, jnp.asarray(d["a"]), jnp.asarray(d["b"]), jnp.asarray(d["site"]),
        N_SITES, beta=BETA, gamma=GAMMA, class_weights=jnp.asarray(cw),
        **{k: jnp.asarray(d[k]) for k in NOISE}))
    return params, state, d, cw, _np(pallas), port_step(params, state, d, cw)


def _grad_tol(name):
    return dict(atol=2e-3, rtol=1e-4) if name in ZERO_GRAD else GRAD


def test_plain_step_matches_pallas_kernel(case):
    *_, (j_loss, j_grads, j_state), (loss, grads, state) = case
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    names = {path: name for name, path in ft.PARAM_ORDER_MM}
    paths = [p for p, _ in _leaves(j_grads)]
    assert len(paths) == len(ft.PARAM_ORDER_MM) == 39
    for path in paths:
        np.testing.assert_allclose(_at(grads, path).numpy(), _at(j_grads, path),
                                   **_grad_tol(names[path]), err_msg=str(path))
    for path, w in _leaves(j_state):
        np.testing.assert_allclose(_at(state, path).numpy(), w, atol=1e-5, err_msg=str(path))


def _jax_forward(p, state, d, cw):
    """The train-mode forward and loss in XLA, with the injected noise."""
    enc_a, enc_b, enc_c = p["encoder_a"], p["encoder_b"], p["encoder_c"]
    h, bn_a = batchnorm_apply(enc_a["bn"], state["encoder_a"]["bn"],
                              linear_apply(enc_a["fc"], d["a"]), train=True)
    ad = relu(h) * d["drop_a"] / 0.9
    h, bn_b1 = batchnorm_apply(enc_b["bn1"], state["encoder_b"]["bn1"],
                               linear_apply(enc_b["fc1"], d["b"]), train=True)
    h, bn_b2 = batchnorm_apply(enc_b["bn2"], state["encoder_b"]["bn2"],
                               linear_apply(enc_b["fc2"], relu(h) * d["drop_b1"] / 0.9),
                               train=True)
    bd2 = relu(h) * d["drop_b2"] / 0.9
    e = jnp.take(enc_c["embedding"]["table"], d["site"], axis=0)
    mu = (linear_apply(enc_a["mu"], ad) + linear_apply(enc_b["mu"], bd2)
          + linear_apply(enc_c["mu"], e)) / 3.0
    lv = (linear_apply(enc_a["logvar"], ad) + linear_apply(enc_b["logvar"], bd2)
          + linear_apply(enc_c["logvar"], e)) / 3.0
    z = mu + d["eps"] * jnp.exp(0.5 * lv)
    dec_a, dec_b, dec_c = p["decoder_a"], p["decoder_b"], p["decoder_c"]
    recon_a = linear_apply(dec_a["fc2"], relu(linear_apply(dec_a["fc1"], z)))
    hb = relu(linear_apply(dec_b["fc2"], relu(linear_apply(dec_b["fc1"], z))))
    logits_c = linear_apply(dec_c["fc2"], relu(linear_apply(dec_c["fc1"], z)))
    total, _ = jlosses.vae_loss(recon_a, d["a"], linear_apply(dec_b["fc3"], hb), d["b"], logits_c,
                                d["site"], mu, lv, beta=BETA, gamma=GAMMA,
                                class_weights=jnp.asarray(cw))
    return total, {"encoder_a": {"bn": bn_a}, "encoder_b": {"bn1": bn_b1, "bn2": bn_b2}}


def test_cpu_wrapper_runs_the_plain_version_and_no_graph(case):
    """On CPU tensors the wrapper is the plain version (held against the
    Pallas kernel above): bit for bit, no step graph captured, no launch
    counted."""
    params, state, d, cw, _, (loss, grads, new) = case
    before, graphs = dict(ft.launches), dict(ft.step_graphs)
    again = port_step(params, state, d, cw)
    assert ft.launches == before and ft.step_graphs == graphs and "multimodal" not in graphs
    t = _t(d)
    flat = ft.flatten_params(tree_from_numpy(params), ft.PARAM_ORDER_MM)
    want = ft.multimodal_train_step_reference(flat, ft.bn_mm(tree_from_numpy(state)), t["a"],
                                              t["b"], t["site"], torch.from_numpy(cw),
                                              *(t[k] for k in NOISE), BETA, GAMMA)
    assert torch.equal(again[0], loss) and torch.equal(loss, want[0])
    got = ft.flatten_params(again[1], ft.PARAM_ORDER_MM)
    for name, _ in ft.PARAM_ORDER_MM:
        assert torch.equal(got[name], want[1][name]), name
    assert all(torch.equal(a, b) for a, b in zip(ft.bn_mm(again[2]), want[2]))


def test_plain_step_matches_autograd_of_the_port_and_jax_forward(case):
    """The hand-derived gradients equal autograd through the port's own
    train-mode forward (the ``multimodal`` task's loss) and jax.grad of the
    JAX package's XLA forward."""
    params, state, d, cw, _, (loss, grads, new_state) = case
    (j_loss, j_bn), j_grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_forward(p, state, d, cw), has_aux=True))(params)
    j_grads, j_bn = _np(j_grads), _np(j_bn)
    leaves = tree_from_numpy(params)
    for _, t in _leaves(leaves):
        t.requires_grad_(True)
    t = _t(d)
    a_loss, a_state = tasks.TASKS["multimodal"].loss(
        leaves, tree_from_numpy(state), tasks.Batch(t["a"], t["b"], t["site"]), BETA, True, None,
        gamma=GAMMA, class_weights=torch.from_numpy(cw), **{k: t[k] for k in NOISE})
    paths = [p for p, _ in _leaves(leaves)]
    a_grads = dict(zip(paths, torch.autograd.grad(a_loss, [v for _, v in _leaves(leaves)])))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(a_loss.item(), float(j_loss), rtol=1e-5)
    names = {path: name for name, path in ft.PARAM_ORDER_MM}
    assert len(a_grads) == 39
    for path, g in a_grads.items():
        tol = _grad_tol(names[path])
        np.testing.assert_allclose(_at(grads, path).numpy(), _at(j_grads, path), **tol,
                                   err_msg=str(path))
        np.testing.assert_allclose(g.numpy(), _at(j_grads, path), **tol, err_msg=str(path))
    for path, w in _leaves(j_bn):
        np.testing.assert_allclose(_at(new_state, path).numpy(), w, atol=1e-5)
        np.testing.assert_allclose(_at(a_state, path).detach().numpy(), w, atol=1e-5)


@pytest.fixture(scope="module")
def epoch_case():
    params, state, d, cw = make_case(seed=4, rows=BATCH * N_BATCHES)
    rng = np.random.default_rng(7)
    m0 = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-3).astype(np.float32), params)
    v0 = jax.tree.map(lambda a: (rng.uniform(size=a.shape) * 1e-6).astype(np.float32), params)
    pallas = jax.block_until_ready(jfe.multimodal_fused_epoch(
        params, m0, v0, state, d["a"], d["b"], d["site"], N_SITES, beta=BETA, gamma=GAMMA,
        class_weights=cw, lr=LR, weight_decay=WD, step0=STEP0, n_batches=N_BATCHES,
        eps_ep=d["eps"], dropa_ep=d["drop_a"], dropb1_ep=d["drop_b1"], dropb2_ep=d["drop_b2"]))
    tt = _t(d)
    port = fe.multimodal_fused_epoch(
        tree_from_numpy(params), tree_from_numpy(m0), tree_from_numpy(v0),
        tree_from_numpy(state), tt["a"], tt["b"], tt["site"], N_SITES, beta=BETA, gamma=GAMMA,
        class_weights=torch.from_numpy(cw), lr=LR, weight_decay=WD, step0=STEP0,
        n_batches=N_BATCHES, eps_ep=tt["eps"], dropa_ep=tt["drop_a"], dropb1_ep=tt["drop_b1"],
        dropb2_ep=tt["drop_b2"])
    return params, state, m0, v0, tt, cw, _np(pallas), port


def test_plain_epoch_matches_pallas_epoch_kernel(epoch_case):
    *_, (j_losses, j_p, j_m, j_v, j_bn), (losses, p, m, v, bn) = epoch_case
    assert losses.shape == (N_BATCHES,)
    np.testing.assert_allclose(losses.numpy(), j_losses, rtol=1e-5)
    names = {path: name for name, path in ft.PARAM_ORDER_MM}
    for got, want in ((p, j_p), (m, j_m)):
        for path, w in _leaves(want):
            atol = 5e-3 if names[path] in ZERO_GRAD else 5e-5
            np.testing.assert_allclose(_at(got, path).numpy(), w, atol=atol, err_msg=str(path))
    for path, w in _leaves(j_v):
        np.testing.assert_allclose(_at(v, path).numpy(), w, atol=1e-8, rtol=1e-3,
                                   err_msg=str(path))
    for path, w in _leaves(j_bn):
        np.testing.assert_allclose(_at(bn, path).numpy(), w, atol=2e-4, err_msg=str(path))


def test_plain_epoch_equals_a_loop_of_the_step_and_adamw(epoch_case):
    params, state, m0, v0, tt, cw, _, (losses, p, m, v, bn) = epoch_case
    p_ref, s_ref = tree_from_numpy(params), tree_from_numpy(state)
    opt = {"step": torch.tensor(STEP0, dtype=torch.int32), "m": tree_from_numpy(m0),
           "v": tree_from_numpy(v0)}
    ref_losses = []
    for i in range(N_BATCHES):
        rows = slice(i * BATCH, (i + 1) * BATCH)
        loss, grads, s_ref = ft.multimodal_fused_train_step(
            p_ref, s_ref, tt["a"][rows], tt["b"][rows], tt["site"][rows], N_SITES, beta=BETA,
            gamma=GAMMA, class_weights=torch.from_numpy(cw), **{k: tt[k][rows] for k in NOISE})
        ref_losses.append(loss)
        p_ref, opt = port_optim.adamw_update(p_ref, grads, opt, LR, WD)
    assert torch.equal(torch.stack(ref_losses), losses)
    for got, want in ((p, p_ref), (m, opt["m"]), (v, opt["v"]), (bn, s_ref)):
        tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), got, want)


def test_philox_mode_matches_a_loop_of_philox_steps():
    """Without injected noise, step i draws what the train step draws at
    (seed, step i), with no class weights meaning ones."""
    params, state, d, _ = make_case(seed=5, rows=3 * BATCH)
    t = _t(d)
    p0 = tree_from_numpy(params)
    zeros = tree_map(torch.zeros_like, p0)
    losses, p, *_ = fe.multimodal_fused_epoch(p0, zeros, zeros, tree_from_numpy(state), t["a"],
                                              t["b"], t["site"], N_SITES, seed=9, n_batches=3)
    p_ref, s_ref, opt = p0, tree_from_numpy(state), port_optim.adamw_init(p0)
    for i in range(3):
        rows = slice(i * BATCH, (i + 1) * BATCH)
        loss, grads, s_ref = ft.multimodal_fused_train_step(
            p_ref, s_ref, t["a"][rows], t["b"][rows], t["site"][rows], N_SITES, seed=9, step=i,
            class_weights=torch.ones(N_SITES))
        assert loss.item() == losses[i].item()
        p_ref, opt = port_optim.adamw_update(p_ref, grads, opt, 5e-4, 1e-5)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), p, p_ref)
    args = (p0, tree_from_numpy(state), t["a"][:BATCH], t["b"][:BATCH], t["site"][:BATCH],
            N_SITES)
    again = ft.multimodal_fused_train_step(*args, seed=9)
    other = ft.multimodal_fused_train_step(*args, seed=10)
    assert again[0].item() == losses[0].item() != other[0].item()


def test_wrappers_reject_what_the_kernels_do_not_take():
    params, state, d, cw = make_case(seed=2)
    p, s = tree_from_numpy(params), tree_from_numpy(state)
    t = _t(d)
    a, b, site = t["a"], t["b"], t["site"]
    step = ft.multimodal_fused_train_step
    with pytest.raises(ValueError, match="all-or-nothing"):
        step(p, s, a, b, site, N_SITES, eps=t["eps"], drop_a=t["drop_a"])
    with pytest.raises(ValueError, match="shape"):  # RNA and DNA swapped
        step(p, s, b, a, site, N_SITES)
    with pytest.raises(ValueError, match="shape"):
        step(p, s, a, b, site, N_SITES, eps=t["eps"], drop_a=t["drop_a"], drop_b1=t["drop_b2"],
             drop_b2=t["drop_b1"])
    with pytest.raises(ValueError, match="shape"):
        step(p, s, a, b, site, N_SITES, class_weights=torch.ones(N_SITES + 1))
    with pytest.raises(TypeError):
        step(p, s, a, b, site, N_SITES, class_weights=torch.ones(N_SITES, dtype=torch.float64))
    with pytest.raises(ValueError, match=r"site labels must lie in \[0, 5\)"):
        step(p, s, a, b, torch.where(site == site[0], N_SITES, site), N_SITES)
    with pytest.raises(ValueError, match="site labels"):
        step(p, s, a, b, torch.where(site == site[0], -1, site), N_SITES)
    with pytest.raises(TypeError):
        step(p, s, a, b, site.int(), N_SITES)
    with pytest.raises(ValueError, match="n_sites"):
        step(p, s, a, b, site, N_SITES + 1)
    with pytest.raises(ValueError, match="batch size"):
        step(p, s, a[:1], b[:1], site[:1], N_SITES)
    zeros = tree_map(torch.zeros_like, p)
    with pytest.raises(ValueError, match="not divisible"):
        fe.multimodal_fused_epoch(p, zeros, zeros, s, a[:-1], b[:-1], site[:-1], N_SITES,
                                  n_batches=2)
    with pytest.raises(ValueError, match="not divisible"):
        zj = _np(jax.tree.map(np.zeros_like, params))
        jfe.multimodal_fused_epoch(params, zj, zj, state, d["a"][:-1], d["b"][:-1],
                                   d["site"][:-1], N_SITES, n_batches=2)
    with pytest.raises(ValueError, match="all-or-nothing"):
        fe.multimodal_fused_epoch(p, zeros, zeros, s, a, b, site, N_SITES, n_batches=2,
                                  eps_ep=t["eps"])
    with pytest.raises(ValueError, match="shape"):  # the epoch takes (a = RNA, b = DNA)
        fe.multimodal_fused_epoch(p, zeros, zeros, s, b, a, site, N_SITES, n_batches=2)
    with pytest.raises(ValueError, match="m/a_w1"):
        fe.multimodal_fused_epoch(p, tree_map(lambda x: x[..., :1].contiguous(), zeros), zeros,
                                  s, a, b, site, N_SITES, n_batches=2)


def test_param_order_and_flat_layout_match_the_jax_package():
    assert ft.PARAM_ORDER_MM == [(n, tuple(p)) for n, p in jft.PARAM_ORDER_MM]
    params, _, _, _ = make_case()
    flat = ft.flatten_params(tree_from_numpy(params), ft.PARAM_ORDER_MM)
    assert ft.dims_of_mm(flat) == (DIM_A, DIM_B, HA, HB1, HB2, LATENT, N_SITES, EMBED, 128, 256,
                                   512, 64)
    buf = ft.pack(flat, ft.PARAM_ORDER_MM)
    assert buf.numel() == sum(v.numel() for v in flat.values())
    back = ft.unflatten(ft.unpack(buf, flat, ft.PARAM_ORDER_MM), ft.PARAM_ORDER_MM)
    for path, v in _leaves(params):
        np.testing.assert_array_equal(_at(back, path).numpy(), v)


def test_port_init_is_a_function_of_its_seed_at_the_live_width():
    cfg = PortConfig()
    args = (cfg.input_dim_a, cfg.input_dim_b, 24, cfg.latent_dim, cfg.embed_dim)
    a = port_vae.multimodal_vae_init(torch.Generator().manual_seed(3), *args)
    b = port_vae.multimodal_vae_init(torch.Generator().manual_seed(3), *args)
    j, js = jvae.multimodal_vae_init(jax.random.PRNGKey(0), *args)
    assert [p for p, _ in _leaves(a[0])] == [p for p, _ in _leaves(j)]
    for (path, x), (_, y) in zip(_leaves(a[0]), _leaves(b[0])):
        assert torch.equal(x, y) and tuple(x.shape) == np.shape(_at(j, path)), path
    assert sum(x.numel() for _, x in _leaves(a[0])) == 1_837_604
    assert tree_to_numpy(a[1]).keys() == js.keys()
    assert [p for p, _ in _leaves(a[1])] == [p for p, _ in _leaves(_np(js))]


# ---- losses, model, weights --------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("terms", ["all", "no_a", "no_b", "no_c"])
def test_losses_match_the_jax_package(weighted, terms):
    rng = np.random.default_rng(3)
    n = 11
    x = dict(ra=rng.normal(size=(n, DIM_A)), a=rng.normal(size=(n, DIM_A)),
             lb=rng.normal(size=(n, DIM_B)) * 3, b=rng.uniform(size=(n, DIM_B)),
             lc=rng.normal(size=(n, N_SITES)) * 2, mu=rng.normal(size=(n, LATENT)),
             lv=rng.normal(size=(n, LATENT)) * 0.5)
    x = {k: v.astype(np.float32) for k, v in x.items()}
    site = rng.integers(0, N_SITES, size=n)
    cw = rng.uniform(0.5, 2.0, size=N_SITES).astype(np.float32) if weighted else None
    drop = {"no_a": ("ra", "a"), "no_b": ("lb", "b"), "no_c": ("lc",)}.get(terms, ())
    args = [None if k in drop else x[k] for k in ("ra", "a", "lb", "b", "lc")]
    s = None if terms == "no_c" else site
    j_total, j_aux = jlosses.vae_loss(*args, s, x["mu"], x["lv"], beta=2e-3, gamma=GAMMA,
                                      class_weights=cw)
    t = lambda v: None if v is None else torch.from_numpy(np.asarray(v))  # noqa: E731
    total, aux = port_losses.vae_loss(*map(t, args), t(s), t(x["mu"]), t(x["lv"]), beta=2e-3,
                                      gamma=GAMMA, class_weights=t(cw))
    np.testing.assert_allclose(total.item(), float(j_total), rtol=1e-6)
    for k in ("recon", "class", "kld"):
        np.testing.assert_allclose(aux[k].item(), float(j_aux[k]), rtol=1e-6, atol=1e-6)
    ce = port_losses.cross_entropy_sum(t(x["lc"]), t(site), None if cw is None else cw)
    np.testing.assert_allclose(ce.item(), float(jlosses.cross_entropy_sum(
        x["lc"], site, cw)), rtol=1e-6)


def jax_noise(key, n):
    """The noise the JAX apply draws from ``key``: ``k_da, k_db, k_z =
    split(key, 3)``, EncoderB splitting k_db once more."""
    k_da, k_db, k_z = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_db)
    masks = {"drop_a": jax.random.bernoulli(k_da, 0.9, (n, HA)),
             "drop_b1": jax.random.bernoulli(k1, 0.9, (n, HB1)),
             "drop_b2": jax.random.bernoulli(k2, 0.9, (n, HB2))}
    masks = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in masks.items()}
    return masks, torch.from_numpy(np.array(jax.random.normal(k_z, (n, LATENT), jnp.float32)))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("subset", SUBSETS, ids=lambda s: "".join(
    n for n, on in zip("abs", s) if on))
def test_model_matches_the_jax_apply_over_every_subset(subset, train):
    params, state, d, _ = make_case(seed=6)
    use_a, use_b, use_s = subset
    key = jax.random.PRNGKey(9)
    out = jvae.multimodal_vae_apply(
        params, state, key, a=jnp.asarray(d["a"]) if use_a else None,
        b=jnp.asarray(d["b"]) if use_b else None,
        site=jnp.asarray(d["site"]) if use_s else None, train=train)
    masks, eps = jax_noise(key, B)
    t = _t(d)
    got = port_vae.multimodal_vae_apply(
        tree_from_numpy(params), tree_from_numpy(state), a=t["a"] if use_a else None,
        b=t["b"] if use_b else None, site=t["site"] if use_s else None, train=train, eps=eps,
        **masks)
    for name in ("out_a", "out_b", "out_b_logits", "out_c", "mu", "logvar"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(out, name)),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    want_state = _np(out.state)
    assert tree_to_numpy(got.state).keys() == want_state.keys()
    for path, w in _leaves(want_state):
        np.testing.assert_allclose(_at(got.state, path).numpy(), w, **CHAIN, err_msg=str(path))
    if not train:  # eval mode returns the state as it was
        for path, w in _leaves(state):
            np.testing.assert_array_equal(_at(got.state, path).numpy(), w)


def test_module_forward_and_masks_not_ported():
    params, state, d, _ = make_case(seed=7)
    model = MultiModalVAE(DIM_A, DIM_B, N_SITES, LATENT, EMBED).eval()
    model.load_state_dict(state_dict_from_jax(params, state, "multivae"), strict=True)
    t = _t(d)
    eps = torch.zeros(B, LATENT)
    with torch.no_grad():
        out_a, out_b, out_c, mu, lv = model(t["a"], t["b"], t["site"], eps=eps)
    ref = port_vae.multimodal_vae_apply(tree_from_numpy(params), tree_from_numpy(state), t["a"],
                                        t["b"], t["site"], eps=eps)
    for got, want in ((out_a, ref.out_a), (out_b, ref.out_b), (out_c, ref.out_c), (mu, ref.mu),
                      (lv, ref.logvar)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="at least one modality"):
        model()
    # the latent mask is ported (the padded HPO populations): all ones is the unmasked forward
    masked = port_vae.multimodal_vae_apply(tree_from_numpy(params), tree_from_numpy(state),
                                           t["a"], t["b"], t["site"], eps=eps,
                                           latent_mask=torch.ones(LATENT))
    for name in ("out_a", "out_b", "out_c", "mu", "logvar"):
        assert torch.equal(getattr(masked, name), getattr(ref, name)), name
    # the row mask is ported (the masked-size populations): all true is the unmasked
    # forward bit for bit, in train mode (its BatchNorm statistics) too
    for train in (False, True):
        plain, rowed = (port_vae.multimodal_vae_apply(
            tree_from_numpy(params), tree_from_numpy(state), t["a"], t["b"], t["site"],
            train=train, eps=eps, generator=torch.Generator().manual_seed(3), **kw)
            for kw in ({}, {"row_mask": torch.ones(B, dtype=torch.bool)}))
        for name in ("out_a", "out_b", "out_c", "mu", "logvar"):
            assert torch.equal(getattr(rowed, name), getattr(plain, name)), name
        for path, w in _leaves(tree_to_numpy(plain.state)):
            np.testing.assert_array_equal(_at(rowed.state, path).numpy(), w)
    p2, s2 = jax_from_state_dict(model.state_dict(), "multivae")
    back = dict(_leaves(p2)) | dict(_leaves(s2))
    want = dict(_leaves(params)) | dict(_leaves(state))
    assert back.keys() == want.keys() and len(want) == 45
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], w)


# ---- class weights, engine, checkpoints, CLI, loader, evaluation -------------

@pytest.mark.parametrize("labels", [
    [0, 0, 1, 3, 3, 3, 4], [2] * 5, list(range(N_SITES)) * 3 + [1]], ids=["gaps", "one", "all"])
def test_compute_class_weights_matches_sklearn(labels):
    class_weight = pytest.importorskip("sklearn.utils.class_weight")
    labels = np.asarray(labels)
    present = np.unique(labels)
    want = np.ones(N_SITES, np.float32)
    want[present] = class_weight.compute_class_weight("balanced", classes=present, y=labels)
    got = port_cli.compute_class_weights(labels, N_SITES)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.fixture(scope="module")
def cohort():
    return generate_synthetic_arrays(n_samples=200, dim_a=DIM_A, dim_b=DIM_B, n_sites=N_SITES,
                                     seed=0)


DIMS = dict(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT, embed_dim=EMBED,
            batch_size=16)


def test_port_fit_agrees_with_the_jax_engine(cohort):
    """Three epochs of each engine (the port's plain path, the JAX XLA path)
    from the same weights with the same class weights: the same epoch count,
    β and learning rate, and losses within 5% (the noise streams differ)."""
    tpm, beta, site = cohort
    cw = port_cli.compute_class_weights(site[:160], N_SITES)
    params, state = jvae.multimodal_vae_init(jax.random.PRNGKey(0), DIM_A, DIM_B, N_SITES, LATENT,
                                             EMBED)
    tr = MultiModalArrays(jnp.asarray(tpm[:160]), jnp.asarray(beta[:160]), jnp.asarray(site[:160]))
    va = MultiModalArrays(jnp.asarray(tpm[160:]), jnp.asarray(beta[160:]), jnp.asarray(site[160:]))
    res = jax.device_get(jax_engine.fit("multimodal", JaxConfig(**DIMS), tr, va,
                                        jax.random.PRNGKey(1), N_SITES, num_epochs=3,
                                        init_params=params, init_state=state,
                                        class_weights=cw))
    got = port_engine.fit("multimodal", PortConfig(**DIMS), (tpm[:160], beta[:160], site[:160]),
                          (tpm[160:], beta[160:], site[160:]), 1, N_SITES, num_epochs=3,
                          init_params=_np(params), init_state=_np(state), device="cpu",
                          class_weights=cw)
    assert got.epochs_ran == int(res.epochs_ran) == 3
    np.testing.assert_array_equal(got.betas, np.asarray(res.betas))
    np.testing.assert_array_equal(got.lrs, np.asarray(res.lrs))
    np.testing.assert_allclose(got.train_losses, np.asarray(res.train_losses), rtol=0.05)
    np.testing.assert_allclose(got.val_losses[-1], float(res.val_losses[-1]), rtol=0.05)
    assert got.val_losses[-1] < got.val_losses[0]
    assert set(got.carry["state"]) == {"encoder_a", "encoder_b"}


@pytest.mark.parametrize("path", ["fused_step", "fused_epoch"])
def test_kernel_paths_run_the_same_recipe(cohort, path):
    """On CPU tensors the kernel paths run their plain versions; both draw
    the same noise for one seed, so they train the same run, and γ and the
    class weights reach them."""
    tpm, beta, site = cohort
    cfg = PortConfig(**DIMS, beta_warmup_epochs=0)
    args = ("multimodal", cfg, (tpm[:160], beta[:160], site[:160]),
            (tpm[160:], beta[160:], site[160:]), 4, N_SITES)
    cw = np.linspace(0.5, 2.0, N_SITES)
    other = {"fused_step": "fused_epoch", "fused_epoch": "fused_step"}[path]
    a = port_engine.fit(*args, num_epochs=2, device="cpu", class_weights=cw, **{path: True})
    b = port_engine.fit(*args, num_epochs=2, device="cpu", class_weights=cw, **{other: True})
    c = port_engine.fit(*args, num_epochs=2, device="cpu", **{path: True})
    np.testing.assert_allclose(a.train_losses, b.train_losses, rtol=1e-6)
    assert not np.allclose(a.train_losses, c.train_losses)


def test_cli_checkpoints_loader_and_evaluation(cohort, tmp_path, monkeypatch):
    """``main_multimodal``'s run: the four artifacts, the best checkpoint and
    resume carry with the three BN states and 39 tensors, the JAX loader and
    the port's loader imputing the same at z = mu, and ``evaluate.main``'s
    JSON."""
    monkeypatch.chdir(tmp_path)
    cfg = PortConfig(**DIMS, checkpoint_dir=str(tmp_path / "checkpoints"),
                     plots_dir=str(tmp_path / "plots"))
    result, run_id, _ = port_cli.run_training("multimodal", "multivae", cfg=cfg,
                                              argv=["--epochs", "2", "--seed", "3"], data=cohort,
                                              n_sites=N_SITES, device="cpu",
                                              use_class_weights=True)
    assert result.epochs_ran == 2
    for name in (f"checkpoints/best_multivae_{run_id}.npz",
                 f"checkpoints/resume_multivae_{run_id}.npz",
                 f"plots/metrics_multivae_{run_id}.jsonl"):
        assert os.path.exists(tmp_path / name), name
    assert (tmp_path / "latest_multivae_run_id.txt").read_text() == run_id
    assert port_eval.get_run_id() == run_id
    p, s, _ = port_ckpt.load_best("multivae", run_id, cfg.checkpoint_dir)
    assert len(list(_leaves(p))) == 39
    assert [q for q, _ in _leaves(s)] == [
        ("encoder_a", "bn", "mean"), ("encoder_a", "bn", "var"),
        ("encoder_b", "bn1", "mean"), ("encoder_b", "bn1", "var"),
        ("encoder_b", "bn2", "mean"), ("encoder_b", "bn2", "var")]
    carry, epochs, _, seed = port_ckpt.load_resume("multivae", run_id, cfg.checkpoint_dir)
    assert (epochs, seed) == (2, 3)
    for tree in (carry["params"], carry["best"]["params"], carry["opt"]["m"]):
        assert len(list(_leaves(tree))) == 39
    for path, v in _leaves(tree_to_numpy(result.state)):
        np.testing.assert_array_equal(_at(s, path), v)
        np.testing.assert_array_equal(_at(carry["best"]["state"], path), v)

    tpm, beta, site = cohort
    rows = slice(160, 193)
    monkeypatch.setattr(jvae, "reparameterize", lambda key, mu, logvar, noise_scale=None: mu)
    monkeypatch.setattr(port_vae, "reparameterize", lambda mu, lv, eps=None, generator=None: mu)
    jax_loading._jitted_multimodal.cache_clear()
    try:
        j_model = jax_loading.load_multimodal(
            cfg=JaxConfig(**DIMS, checkpoint_dir=cfg.checkpoint_dir))
        j_out = j_model(a=tpm[rows], site=site[rows])
        j_b = j_model(b=beta[rows])
    finally:
        jax_loading._jitted_multimodal.cache_clear()
    model = port_loading.load_multimodal(cfg=cfg, device="cpu")
    for got, want in ((model(a=tpm[rows], site=site[rows]), j_out), (model(b=beta[rows]), j_b)):
        assert len(got) == 5
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="site labels"):
        model(site=np.array([N_SITES]))
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)

    out = tmp_path / "eval.json"
    records = port_eval.main(cfg=cfg, output_path=str(out), data=cohort, device="cpu")
    saved = json.loads(out.read_text())
    assert saved["run_id"] == run_id and saved["results"] == records
    assert [r["Modality"] for r in records] == ["DNA methylation", "RNA expression"]
    loaded, (v_tpm, v_beta, _), rid = port_eval.load_model_and_data(cfg, cohort, device="cpu")
    assert rid == run_id
    _, est_dna, _, _, _ = loaded(a=v_tpm)
    est_rna, _, _, _, _ = loaded(b=v_beta)
    want = [compute_imputation_metrics(v_beta, est_dna, "DNA methylation", "MultiModalVAE"),
            compute_imputation_metrics(v_tpm, est_rna, "RNA expression", "MultiModalVAE")]
    assert records == want
    for rec in records:
        assert all(np.isfinite(rec[k]) for k in ("MSE", "MAE", "CosineSimilarity",
                                                  "PearsonMean"))
    assert port_cli.main_multimodal.__module__ == port_cli.__name__
