"""The DNA→RNA train step and epoch's plain versions
(``ops/kernels/fused_train.py``, ``ops/kernels/fused_epoch.py``) against the
JAX package: its Pallas DNA→RNA train-step and whole-epoch kernels
(interpret mode, as the JAX tests run them) and ``jax.grad`` of an XLA
train-mode forward, all with the same injected noise. The CUDA kernels are
held against these plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

EncoderB's hidden widths (512, 256) are fixed in both packages; the other
widths are small, with DIM_A != DIM_B so that a swap of the DNA input and
the RNA target raises on shape.

Tolerances are the JAX tests' (``tests/test_pallas_train.py``,
``tests/test_pallas_epoch.py``): loss rtol 1e-5; the 21 gradients atol 1e-3,
rtol 1e-4; BN stats atol 1e-5. The epoch over 10 steps of 8 rows (crossing
the Pallas kernel's 8-step loss block): per-step losses rtol 1e-5; params
and m atol 5e-5, except both encoder fc biases and the BN running means at
5e-3 (their true gradient through train-mode BatchNorm is zero, so what is
computed is fp32 cancellation noise that Adam turns into
implementation-dependent steps); BN var atol 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.models import directional_vae as port_dv
from vae_los_angeles_torch.ops import optim as port_optim
from vae_los_angeles_torch.ops.kernels import fused_epoch as fe
from vae_los_angeles_torch.ops.kernels import fused_train as ft
from vae_los_angeles_torch.training import tasks
from vae_los_angeles_torch.utils.tree import tree_map
from vae_los_angeles_torch.utils.weights import tree_from_numpy, tree_to_numpy
from vae_los_angeles_tpu.models.directional_vae import dna2rna_vae_init
from vae_los_angeles_tpu.ops.pallas import fused_epoch as jfe
from vae_los_angeles_tpu.ops.pallas import fused_train as jft

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, B = 40, 56, 5, 8, 16
H1, H2 = 512, 256
GRAD = dict(atol=1e-3, rtol=1e-4)
BATCH, N_BATCHES = 8, 10
LR, WD, BETA, STEP0 = 5e-4, 1e-5, 1e-3, 3
ZERO_GRAD = {"b1", "b2"}  # the encoder fc biases feeding train-mode BatchNorm


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
    """JAX-initialised weights with moved BN stats; DNA (β-values) in, RNA
    (log-expression) out, and injected noise, all from a numpy seed."""
    rng = np.random.default_rng(seed)
    params, state = dna2rna_vae_init(jax.random.PRNGKey(seed), DIM_A, DIM_B, N_SITES, LATENT)
    state = jax.tree.map(
        lambda x: x + 0.2 * jax.random.uniform(jax.random.PRNGKey(seed + 1), x.shape), state)
    data = dict(
        dna=rng.uniform(0.02, 0.98, size=(rows, DIM_B)).astype(np.float32),
        rna=rng.normal(size=(rows, DIM_A)).astype(np.float32),
        site=rng.integers(0, N_SITES, size=(rows,)),
        eps=rng.normal(size=(rows, LATENT)).astype(np.float32),
        drop1=(rng.uniform(size=(rows, H1)) < 0.9).astype(np.float32),
        drop2=(rng.uniform(size=(rows, H2)) < 0.9).astype(np.float32),
    )
    return _np(params), _np(state), data


def port_step(params, state, d, **kw):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    return ft.dna2rna_fused_train_step(
        tree_from_numpy(params), tree_from_numpy(state), t["rna"], t["dna"], t["site"], N_SITES,
        eps=t["eps"], drop_mask1=t["drop1"], drop_mask2=t["drop2"], **kw)


@pytest.fixture(scope="module")
def case():
    params, state, d = make_case()
    # the Pallas kernel in interpret mode, waited for before any other JAX work
    pallas = jax.block_until_ready(jft.dna2rna_fused_train_step(
        params, state, jnp.asarray(d["rna"]), jnp.asarray(d["dna"]), jnp.asarray(d["site"]),
        N_SITES, beta=BETA, eps=jnp.asarray(d["eps"]), drop_mask1=jnp.asarray(d["drop1"]),
        drop_mask2=jnp.asarray(d["drop2"])))
    return params, state, d, _np(pallas), port_step(params, state, d, beta=BETA)


def test_plain_step_matches_pallas_kernel(case):
    _, _, _, (j_loss, j_grads, j_state), (loss, grads, state) = case
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    paths = [p for p, _ in _leaves(j_grads)]
    assert len(paths) == len(ft.PARAM_ORDER_D2R) == 21
    for path in paths:
        np.testing.assert_allclose(_at(grads, path).numpy(), _at(j_grads, path), **GRAD,
                                   err_msg=str(path))
    for path, w in _leaves(j_state):
        np.testing.assert_allclose(_at(state, path).numpy(), w, atol=1e-5, err_msg=str(path))


def test_cpu_wrapper_runs_the_plain_version_and_no_graph(case):
    """On CPU tensors the wrapper is the plain version (held against the
    Pallas kernel above): bit for bit, no step graph captured, no launch
    counted."""
    params, state, d, _, (loss, grads, new) = case
    before, graphs = dict(ft.launches), dict(ft.step_graphs)
    again = port_step(params, state, d, beta=BETA)
    assert ft.launches == before and ft.step_graphs == graphs and "dna2rna" not in graphs
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    flat = ft.flatten_params(tree_from_numpy(params), ft.PARAM_ORDER_D2R)
    want = ft.dna2rna_train_step_reference(flat, ft.bn_d2r(tree_from_numpy(state)), t["dna"],
                                           t["rna"], t["site"], t["eps"], t["drop1"],
                                           t["drop2"], BETA)
    assert torch.equal(again[0], loss) and torch.equal(loss, want[0])
    got = ft.flatten_params(again[1], ft.PARAM_ORDER_D2R)
    for name, _ in ft.PARAM_ORDER_D2R:
        assert torch.equal(got[name], want[1][name]), name
    assert all(torch.equal(a, b) for a, b in zip(ft.bn_d2r(again[2]), want[2]))


def test_plain_step_matches_autograd_of_the_port_and_jax_forward(case):
    """The hand-derived gradients equal autograd through the port's own
    train-mode forward (`dna2rna_vae_apply` + `dna2rna_loss`) and jax.grad
    of the JAX package's XLA forward."""
    params, state, d, _, (loss, grads, new_state) = case
    from vae_los_angeles_tpu.ops.losses import dna2rna_loss as j_loss_fn
    from vae_los_angeles_tpu.ops.nn import batchnorm_apply, linear_apply, relu

    def j_forward(p):
        enc, bn = p["encoder_dna"], state["encoder_dna"]
        h, bn1 = batchnorm_apply(enc["bn1"], bn["bn1"], linear_apply(enc["fc1"], d["dna"]),
                                 train=True)
        h, bn2 = batchnorm_apply(enc["bn2"], bn["bn2"],
                                 linear_apply(enc["fc2"], relu(h) * d["drop1"] / 0.9), train=True)
        h = relu(h) * d["drop2"] / 0.9
        est = p["encoder_site"]
        e = jnp.take(est["embedding"]["table"], d["site"], axis=0)
        mu = 0.5 * (linear_apply(enc["mu"], h) + linear_apply(est["mu"], e))
        lv = 0.5 * (linear_apply(enc["logvar"], h) + linear_apply(est["logvar"], e))
        z = mu + d["eps"] * jnp.exp(0.5 * lv)
        dec = p["decoder_rna"]
        recon = linear_apply(dec["fc2"], relu(linear_apply(dec["fc1"], z)))
        return j_loss_fn(recon, d["rna"], mu, lv, beta=BETA)[0], {"bn1": bn1, "bn2": bn2}

    (j_loss, j_bn), j_grads = jax.value_and_grad(j_forward, has_aux=True)(params)
    j_grads, j_bn = _np(j_grads), _np(j_bn)

    leaves = tree_from_numpy(params)
    for _, t in _leaves(leaves):
        t.requires_grad_(True)
    batch = tasks.Batch(torch.from_numpy(d["rna"]), torch.from_numpy(d["dna"]),
                        torch.from_numpy(d["site"]))
    a_loss, a_state = tasks.TASKS["dna2rna"].loss(
        leaves, tree_from_numpy(state), batch, BETA, True, None, eps=torch.from_numpy(d["eps"]),
        drop_mask1=torch.from_numpy(d["drop1"]), drop_mask2=torch.from_numpy(d["drop2"]))
    flat = [t for _, t in _leaves(leaves)]
    a_grads = dict(zip([p for p, _ in _leaves(leaves)], torch.autograd.grad(a_loss, flat)))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(a_loss.item(), float(j_loss), rtol=1e-5)
    assert len(a_grads) == 21
    for path, g in a_grads.items():
        np.testing.assert_allclose(_at(grads, path).numpy(), _at(j_grads, path), **GRAD,
                                   err_msg=str(path))
        np.testing.assert_allclose(g.numpy(), _at(j_grads, path), **GRAD, err_msg=str(path))
    for path, w in _leaves(j_bn):
        np.testing.assert_allclose(_at(new_state["encoder_dna"], path).numpy(), w, atol=1e-5)
        np.testing.assert_allclose(_at(a_state["encoder_dna"], path).detach().numpy(), w,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def epoch_case():
    params, state, d = make_case(seed=4, rows=BATCH * N_BATCHES)
    rng = np.random.default_rng(7)
    m0 = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-3).astype(np.float32), params)
    v0 = jax.tree.map(lambda a: (rng.uniform(size=a.shape) * 1e-6).astype(np.float32), params)
    pallas = jax.block_until_ready(jfe.dna2rna_fused_epoch(
        params, m0, v0, state, d["dna"], d["rna"], d["site"], N_SITES, beta=BETA, lr=LR,
        weight_decay=WD, step0=STEP0, n_batches=N_BATCHES, eps_ep=d["eps"], drop1_ep=d["drop1"],
        drop2_ep=d["drop2"]))
    tt = {k: torch.from_numpy(v) for k, v in d.items()}
    port = fe.dna2rna_fused_epoch(
        tree_from_numpy(params), tree_from_numpy(m0), tree_from_numpy(v0),
        tree_from_numpy(state), tt["dna"], tt["rna"], tt["site"], N_SITES, beta=BETA, lr=LR,
        weight_decay=WD, step0=STEP0, n_batches=N_BATCHES, eps_ep=tt["eps"],
        drop1_ep=tt["drop1"], drop2_ep=tt["drop2"])
    return params, state, m0, v0, tt, _np(pallas), port


def test_plain_epoch_matches_pallas_epoch_kernel(epoch_case):
    *_, (j_losses, j_p, j_m, j_v, j_bn), (losses, p, m, v, bn) = epoch_case
    assert losses.shape == (N_BATCHES,)
    np.testing.assert_allclose(losses.numpy(), j_losses, rtol=1e-5)
    names = dict((path, name) for name, path in ft.PARAM_ORDER_D2R)
    for got, want in ((p, j_p), (m, j_m)):
        for path, w in _leaves(want):
            atol = 5e-3 if names[path] in ZERO_GRAD else 5e-5
            np.testing.assert_allclose(_at(got, path).numpy(), w, atol=atol, err_msg=str(path))
    for path, w in _leaves(j_v):
        np.testing.assert_allclose(_at(v, path).numpy(), w, atol=1e-8, rtol=1e-3,
                                   err_msg=str(path))
    for path, w in _leaves(j_bn):
        atol = 5e-3 if path[-1] == "mean" else 2e-4
        np.testing.assert_allclose(_at(bn, path).numpy(), w, atol=atol, err_msg=str(path))


def test_plain_epoch_equals_a_loop_of_the_step_and_adamw(epoch_case):
    params, state, m0, v0, tt, _, (losses, p, m, v, bn) = epoch_case
    p_ref, s_ref = tree_from_numpy(params), tree_from_numpy(state)
    opt = {"step": torch.tensor(STEP0, dtype=torch.int32), "m": tree_from_numpy(m0),
           "v": tree_from_numpy(v0)}
    ref_losses = []
    for b in range(N_BATCHES):
        rows = slice(b * BATCH, (b + 1) * BATCH)
        loss, grads, s_ref = ft.dna2rna_fused_train_step(
            p_ref, s_ref, tt["rna"][rows], tt["dna"][rows], tt["site"][rows], N_SITES, beta=BETA,
            eps=tt["eps"][rows], drop_mask1=tt["drop1"][rows], drop_mask2=tt["drop2"][rows])
        ref_losses.append(loss)
        p_ref, opt = port_optim.adamw_update(p_ref, grads, opt, LR, WD)
    assert torch.equal(torch.stack(ref_losses), losses)
    for got, want in ((p, p_ref), (m, opt["m"]), (v, opt["v"]), (bn, s_ref)):
        tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), got, want)


def test_philox_mode_matches_a_loop_of_philox_steps():
    """Without injected noise, step i draws what the train step draws at
    (seed, step i): the epoch equals a loop of those steps and AdamW."""
    params, state, d = make_case(seed=5, rows=3 * BATCH)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    p0 = tree_from_numpy(params)
    zeros = tree_map(torch.zeros_like, p0)
    losses, p, *_ = fe.dna2rna_fused_epoch(p0, zeros, zeros, tree_from_numpy(state), t["dna"],
                                           t["rna"], t["site"], N_SITES, seed=9, n_batches=3)
    p_ref, s_ref, opt = p0, tree_from_numpy(state), port_optim.adamw_init(p0)
    for b in range(3):
        rows = slice(b * BATCH, (b + 1) * BATCH)
        loss, grads, s_ref = ft.dna2rna_fused_train_step(
            p_ref, s_ref, t["rna"][rows], t["dna"][rows], t["site"][rows], N_SITES, seed=9,
            step=b)
        assert loss.item() == losses[b].item()
        p_ref, opt = port_optim.adamw_update(p_ref, grads, opt, 5e-4, 1e-5)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), p, p_ref)
    again = ft.dna2rna_fused_train_step(p0, tree_from_numpy(state), t["rna"][:BATCH],
                                        t["dna"][:BATCH], t["site"][:BATCH], N_SITES, seed=9)
    other = ft.dna2rna_fused_train_step(p0, tree_from_numpy(state), t["rna"][:BATCH],
                                        t["dna"][:BATCH], t["site"][:BATCH], N_SITES, seed=10)
    assert again[0].item() == losses[0].item() != other[0].item()


def test_wrappers_reject_what_the_kernels_do_not_take():
    params, state, d = make_case(seed=2)
    p, s = tree_from_numpy(params), tree_from_numpy(state)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    rna, dna, site = t["rna"], t["dna"], t["site"]
    with pytest.raises(ValueError, match="all-or-nothing"):
        ft.dna2rna_fused_train_step(p, s, rna, dna, site, N_SITES, eps=t["eps"],
                                    drop_mask1=t["drop1"])
    with pytest.raises(ValueError, match="all-or-nothing"):
        jft.check_noise_args(eps=1, drop_mask1=1, drop_mask2=None)
    with pytest.raises(ValueError, match="shape"):  # DNA and RNA swapped
        ft.dna2rna_fused_train_step(p, s, dna, rna, site, N_SITES)
    with pytest.raises(ValueError, match="shape"):
        ft.dna2rna_fused_train_step(p, s, rna, dna, site, N_SITES, eps=t["eps"],
                                    drop_mask1=t["drop2"], drop_mask2=t["drop1"])
    with pytest.raises(TypeError):
        ft.dna2rna_fused_train_step(p, s, rna, dna.double(), site, N_SITES)
    with pytest.raises(TypeError):
        ft.dna2rna_fused_train_step(p, s, rna, dna, site.int(), N_SITES)
    with pytest.raises(ValueError, match="n_sites"):
        ft.dna2rna_fused_train_step(p, s, rna, dna, site, N_SITES + 1)
    with pytest.raises(ValueError, match="batch size"):
        ft.dna2rna_fused_train_step(p, s, rna[:1], dna[:1], site[:1], N_SITES)
    with pytest.raises(ValueError, match="contiguous"):
        ft.dna2rna_fused_train_step(p, s, rna, dna.t().contiguous().t(), site, N_SITES)
    zeros = tree_map(torch.zeros_like, p)
    with pytest.raises(ValueError, match="not divisible"):
        fe.dna2rna_fused_epoch(p, zeros, zeros, s, dna[:-1], rna[:-1], site[:-1], N_SITES,
                               n_batches=2)
    with pytest.raises(ValueError, match="not divisible"):
        jfe.dna2rna_fused_epoch(params, _np(jax.tree.map(np.zeros_like, params)),
                                _np(jax.tree.map(np.zeros_like, params)), state, d["dna"][:-1],
                                d["rna"][:-1], d["site"][:-1], N_SITES, n_batches=2)
    with pytest.raises(ValueError, match="all-or-nothing"):
        fe.dna2rna_fused_epoch(p, zeros, zeros, s, dna, rna, site, N_SITES, n_batches=2,
                               eps_ep=t["eps"], drop1_ep=t["drop1"])
    with pytest.raises(ValueError, match="shape"):  # the epoch takes (x = DNA, t = RNA)
        fe.dna2rna_fused_epoch(p, zeros, zeros, s, rna, dna, site, N_SITES, n_batches=2)
    with pytest.raises(ValueError, match="m/w1"):
        fe.dna2rna_fused_epoch(p, tree_map(lambda a: a[..., :1].contiguous(), zeros), zeros, s,
                               dna, rna, site, N_SITES, n_batches=2)


def test_param_order_and_flat_layout_match_the_jax_package():
    assert ft.PARAM_ORDER_D2R == [(n, tuple(p)) for n, p in jft.PARAM_ORDER_D2R]
    params, _, _ = make_case()
    flat = ft.flatten_params(tree_from_numpy(params), ft.PARAM_ORDER_D2R)
    assert ft.dims_of_d2r(flat) == (DIM_B, H1, H2, LATENT, N_SITES, 32, 128, DIM_A)
    buf = ft.pack(flat, ft.PARAM_ORDER_D2R)
    assert buf.numel() == sum(v.numel() for v in flat.values())
    back = ft.unflatten(ft.unpack(buf, flat, ft.PARAM_ORDER_D2R), ft.PARAM_ORDER_D2R)
    assert tree_to_numpy(back).keys() == params.keys()
    for path, v in _leaves(params):
        np.testing.assert_array_equal(_at(back, path).numpy(), v)


def test_port_init_is_a_function_of_its_seed():
    a = port_dv.dna2rna_vae_init(torch.Generator().manual_seed(3), DIM_A, DIM_B, N_SITES, LATENT)
    b = port_dv.dna2rna_vae_init(torch.Generator().manual_seed(3), DIM_A, DIM_B, N_SITES, LATENT)
    j, js = dna2rna_vae_init(jax.random.PRNGKey(0), DIM_A, DIM_B, N_SITES, LATENT)
    assert [p for p, _ in _leaves(a[0])] == [p for p, _ in _leaves(j)]
    for (path, x), (_, y) in zip(_leaves(a[0]), _leaves(b[0])):
        assert torch.equal(x, y) and tuple(x.shape) == np.shape(_at(j, path)), path
    for k in ("bn1", "bn2"):
        assert a[1]["encoder_dna"][k]["var"].eq(1).all()
        assert a[1]["encoder_dna"][k]["mean"].eq(0).all()
    assert tree_to_numpy(a[1]).keys() == js.keys()
