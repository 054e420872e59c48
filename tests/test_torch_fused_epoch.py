"""The epoch's plain version (``ops/kernels/fused_epoch.py``) against the
JAX package's whole-epoch Pallas kernel (interpret mode) with the same
injected noise over 20 steps of 8 rows (crossing the kernel's 8-step loss
blocks, as ``tests/test_pallas_epoch.py`` does), and against a loop of the
port's train step plus ``adamw_update``.

Tolerances are the JAX test's: per-step losses rtol 1e-5; params and m
atol 2e-5, except the encoder fc bias (and the BN running mean, which moves
1:1 with it) at 5e-3: its true gradient through train-mode BatchNorm is
zero, so what is computed is fp32 cancellation noise that Adam's
normalisation turns into implementation-dependent steps; BN var atol 2e-4.

On the card every epoch is a CUDA graph, one cached a task; here the epoch
args it reads (the directional host loops' bias-correction bits) and the
cache's key logic, with a stand-in library in place of the built one."""

import ctypes
import ctypes.util

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

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

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


def test_directional_epoch_args_hold_the_host_loops_bias_corrections():
    """The directional graphs' epoch args (γ unused: 0) hold, for t = 1..300,
    the bits the host loops they replace computed on the host,
    ``(float)(1 - pow((double)β, t))`` with the C library's pow; an epoch
    from step0 holds the same bits as the same steps of a longer epoch."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.pow.argtypes, libm.pow.restype = [ctypes.c_double] * 2, ctypes.c_double
    args = fe.epoch_args(2**40 + 3, 1e-3, 0.0, 5e-4, 1e-5, 0, 300)
    np.testing.assert_array_equal(args[2:6], np.float32([1e-3, 0.0, 5e-4, 1e-5]))
    for k, beta in enumerate((0.9, 0.999)):
        host = np.float32([1.0 - libm.pow(float(np.float32(beta)), float(t))
                           for t in range(1, 301)])
        np.testing.assert_array_equal(args[6 + k::2], host)
    later = fe.epoch_args(5, 2e-3, 0.0, 1e-4, 0.0, 100, 200)
    np.testing.assert_array_equal(later[6:], args[6 + 200:])


class _StandInLibrary:
    """What the graph cache calls of the built library: the destroy entry."""

    def __init__(self):
        self.freed = []

    def graph_destroy(self, handle):
        self.freed.append(handle)


def _stand_in_graph(lib, handle, log):
    """A build function of `fe.epoch_graph`: an `_EpochGraph` holding only
    its handle; it logs (handle, graphs freed before it was captured)."""
    def build():
        log.append((handle, list(lib.freed)))
        g = fe._EpochGraph.__new__(fe._EpochGraph)
        g.lib, g.handle = lib, handle
        return g
    return build


def test_epoch_graph_cache_keeps_one_graph_a_task(monkeypatch):
    monkeypatch.setattr(fe, "graphs", {})
    lib, log = _StandInLibrary(), []
    key = ("cuda:0", (40, 56), 16, 5, True, False)
    first = {task: fe.epoch_graph(task, key, _stand_in_graph(lib, h, log))
             for h, task in enumerate(("rna2dna", "dna2rna", "multimodal"), 1)}
    for _ in range(2):  # the tasks alternate, epoch by epoch: nothing is captured again
        for task in first:
            assert fe.epoch_graph(task, key, _stand_in_graph(lib, 99, log)) is first[task]
    assert [h for h, _ in log] == [1, 2, 3] and lib.freed == []
    del first
    other = ("cuda:0", (40, 56), 16, 6, True, False)  # another n_batches
    fe.epoch_graph("dna2rna", other, _stand_in_graph(lib, 4, log))
    assert log[-1] == (4, [2])  # the task's old graph was freed before the capture
    assert lib.freed == [2]  # and no other task's
    assert {t: g.handle for t, (_, g) in fe.graphs.items()} == {
        "rna2dna": 1, "dna2rna": 4, "multimodal": 3}


def test_a_capture_that_raises_leaves_no_graph_of_its_task(monkeypatch):
    monkeypatch.setattr(fe, "graphs", {})
    lib, log = _StandInLibrary(), []
    key = ("cuda:0", (40, 56), 16, 5, False, False)
    kept = fe.epoch_graph("rna2dna", key, _stand_in_graph(lib, 1, log))
    fe.epoch_graph("dna2rna", key, _stand_in_graph(lib, 2, log))

    def failing():
        raise RuntimeError("dna2rna_epoch_graph_create failed to launch: CUDA error 1")

    with pytest.raises(RuntimeError, match="CUDA error"):
        fe.epoch_graph("dna2rna", key[:3] + (6,) + key[4:], failing)
    assert "dna2rna" not in fe.graphs and lib.freed == [2]
    assert fe.graphs["rna2dna"][1] is kept
