"""The train step's plain version (``ops/kernels/fused_train.py``) against
the JAX package: the Pallas train-step kernel (interpret mode, as the JAX
tests run it) and ``jax.grad`` of the XLA train-mode forward, both with the
same injected noise. The CUDA kernel is held against this plain version on
the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Tolerances are the JAX tests' (``tests/test_pallas_train.py``): loss
rtol 1e-5; the 19 gradients atol 5e-4, rtol 1e-4; BN stats atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.models import directional_vae as port_dv
from vae_los_angeles_torch.ops.kernels import fused_train as ft
from vae_los_angeles_torch.training import tasks
from vae_los_angeles_torch.utils.weights import tree_from_numpy, tree_to_numpy
from vae_los_angeles_tpu.models.directional_vae import rna2dna_vae_init
from vae_los_angeles_tpu.ops.pallas import fused_train as jft

DIM_A, DIM_B, N_SITES, LATENT, B = 40, 56, 5, 8, 16
GRAD = dict(atol=5e-4, rtol=1e-4)


def make_case(seed=0):
    rng = np.random.default_rng(seed)
    params, state = rna2dna_vae_init(jax.random.PRNGKey(seed), DIM_A, DIM_B, N_SITES, LATENT)
    state = jax.tree.map(
        lambda x: x + 0.2 * jax.random.uniform(jax.random.PRNGKey(seed + 1), x.shape), state)
    data = dict(
        rna=rng.normal(size=(B, DIM_A)).astype(np.float32),
        dna=rng.uniform(0.02, 0.98, size=(B, DIM_B)).astype(np.float32),
        site=rng.integers(0, N_SITES, size=(B,)),
        eps=rng.normal(size=(B, LATENT)).astype(np.float32),
        drop=(rng.uniform(size=(B, 128)) < 0.9).astype(np.float32),
    )
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state), data


@pytest.fixture(scope="module")
def case():
    params, state, d = make_case()
    # the Pallas kernel in interpret mode, waited for before any other JAX work
    pallas = jax.block_until_ready(jft.rna2dna_fused_train_step(
        params, state, jnp.asarray(d["rna"]), jnp.asarray(d["dna"]), jnp.asarray(d["site"]),
        N_SITES, beta=1e-3, eps=jnp.asarray(d["eps"]), drop_mask=jnp.asarray(d["drop"])))
    port = ft.rna2dna_fused_train_step(
        tree_from_numpy(params), tree_from_numpy(state), torch.from_numpy(d["rna"]),
        torch.from_numpy(d["dna"]), torch.from_numpy(d["site"]), N_SITES, beta=1e-3,
        eps=torch.from_numpy(d["eps"]), drop_mask=torch.from_numpy(d["drop"]))
    return params, state, d, jax.tree.map(np.asarray, pallas), port


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


def test_plain_step_matches_pallas_kernel(case):
    _, _, _, (j_loss, j_grads, j_state), (loss, grads, state) = case
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    paths = [p for p, _ in _leaves(j_grads)]
    assert len(paths) == len(ft.PARAM_ORDER) == 19
    for path in paths:
        np.testing.assert_allclose(_at(grads, path).numpy(), _at(j_grads, path), **GRAD,
                                   err_msg=str(path))
    for k in ("mean", "var"):
        np.testing.assert_allclose(state["encoder_rna"]["bn"][k].numpy(),
                                   j_state["encoder_rna"]["bn"][k], atol=1e-5)


def test_plain_step_matches_autograd_of_the_port_and_jax_forward(case):
    """The hand-derived gradients equal autograd through the port's own
    train-mode forward and jax.grad of the JAX package's XLA forward."""
    params, state, d, _, (loss, grads, new_state) = case
    from vae_los_angeles_tpu.ops.losses import rna2dna_loss as j_loss_fn
    from vae_los_angeles_tpu.ops.nn import batchnorm_apply, linear_apply, relu

    def j_forward(p):
        enc = p["encoder_rna"]
        h, new_bn = batchnorm_apply(enc["bn"], state["encoder_rna"]["bn"],
                                    linear_apply(enc["fc"], d["rna"]), train=True)
        dd = relu(h) * d["drop"] / 0.9
        est = p["encoder_site"]
        e = jnp.take(est["embedding"]["table"], d["site"], axis=0)
        mu = 0.5 * (linear_apply(enc["mu"], dd) + linear_apply(est["mu"], e))
        lv = 0.5 * (linear_apply(enc["logvar"], dd) + linear_apply(est["logvar"], e))
        z = mu + d["eps"] * jnp.exp(0.5 * lv)
        dec = p["decoder_dna"]
        logits = linear_apply(dec["fc3"], relu(linear_apply(dec["fc2"], relu(
            linear_apply(dec["fc1"], z)))))
        return j_loss_fn(logits, d["dna"], mu, lv, beta=1e-3)[0], new_bn

    (j_loss, j_bn), j_grads = jax.value_and_grad(j_forward, has_aux=True)(params)
    j_grads = jax.tree.map(np.asarray, j_grads)

    leaves = tree_from_numpy(params)
    for _, t in _leaves(leaves):
        t.requires_grad_(True)
    batch = tasks.Batch(torch.from_numpy(d["rna"]), torch.from_numpy(d["dna"]),
                        torch.from_numpy(d["site"]))
    a_loss, a_state = tasks.TASKS["rna2dna"].loss(
        leaves, tree_from_numpy(state), batch, 1e-3, True, None,
        eps=torch.from_numpy(d["eps"]), drop_mask=torch.from_numpy(d["drop"]))
    flat = [t for _, t in _leaves(leaves)]
    a_grads = dict(zip([p for p, _ in _leaves(leaves)], torch.autograd.grad(a_loss, flat)))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(a_loss.item(), float(j_loss), rtol=1e-5)
    for path, g in a_grads.items():
        np.testing.assert_allclose(_at(grads, path).numpy(), _at(j_grads, path), **GRAD,
                                   err_msg=str(path))
        np.testing.assert_allclose(g.numpy(), _at(j_grads, path), **GRAD, err_msg=str(path))
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_state["encoder_rna"]["bn"][k].numpy(), np.asarray(j_bn[k]),
                                   atol=1e-5)
        np.testing.assert_allclose(a_state["encoder_rna"]["bn"][k].detach().numpy(),
                                   np.asarray(j_bn[k]), atol=1e-5)


def test_out_of_range_site_gives_zero_embedding_gradient():
    params, state, d = make_case(3)
    site = d["site"].copy()
    site[2] = N_SITES + 1
    loss, grads, _ = ft.rna2dna_fused_train_step(
        tree_from_numpy(params), tree_from_numpy(state), torch.from_numpy(d["rna"]),
        torch.from_numpy(d["dna"]), torch.from_numpy(site), N_SITES,
        eps=torch.from_numpy(d["eps"]), drop_mask=torch.from_numpy(d["drop"]))
    j_loss, j_grads, _ = jax.block_until_ready(jft.rna2dna_fused_train_step(
        params, state, d["rna"], d["dna"], site, N_SITES, eps=d["eps"], drop_mask=d["drop"]))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(grads["encoder_site"]["embedding"]["table"].numpy(),
                               np.asarray(j_grads["encoder_site"]["embedding"]["table"]), **GRAD)


def test_noise_is_all_or_nothing_and_philox_mode_is_reproducible():
    params, state, d = make_case(1)
    p, s = tree_from_numpy(params), tree_from_numpy(state)
    args = (p, s, torch.from_numpy(d["rna"]), torch.from_numpy(d["dna"]),
            torch.from_numpy(d["site"]), N_SITES)
    with pytest.raises(ValueError, match="all-or-nothing"):
        ft.rna2dna_fused_train_step(*args, eps=torch.from_numpy(d["eps"]))
    with pytest.raises(ValueError, match="all-or-nothing"):
        jft.check_noise_args(eps=1, drop_mask=None)
    assert ft.check_noise_args(eps=None, drop_mask=None) is True
    a = ft.rna2dna_fused_train_step(*args, seed=4, step=2)
    b = ft.rna2dna_fused_train_step(*args, seed=4, step=2)
    c = ft.rna2dna_fused_train_step(*args, seed=4, step=3)
    assert a[0].item() == b[0].item() and a[0].item() != c[0].item()
    assert all(torch.isfinite(g).all() for _, g in _leaves(a[1]))
    before = ft.launches["rna2dna_train_step"]
    ft.rna2dna_fused_train_step(*args, seed=1)
    assert ft.launches["rna2dna_train_step"] == before  # CPU tensors: the plain version


def test_param_order_and_flat_layout_match_the_jax_package():
    assert ft.PARAM_ORDER == [(n, tuple(p)) for n, p in jft.PARAM_ORDER]
    assert ft.DROPOUT_RATE == jft.DROPOUT_RATE
    params, _, _ = make_case()
    flat = ft.flatten_params(tree_from_numpy(params))
    buf = ft.pack(flat)
    assert buf.numel() == sum(v.numel() for v in flat.values())
    back = ft.unflatten(ft.unpack(buf, flat))
    assert tree_to_numpy(back).keys() == params.keys()
    for path, v in _leaves(params):
        np.testing.assert_array_equal(_at(back, path).numpy(), v)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    params, state, d = make_case(2)
    p, s = tree_from_numpy(params), tree_from_numpy(state)
    rna, dna, site = (torch.from_numpy(d[k]) for k in ("rna", "dna", "site"))
    with pytest.raises(TypeError):
        ft.rna2dna_fused_train_step(p, s, rna.double(), dna, site, N_SITES)
    with pytest.raises(ValueError):
        ft.rna2dna_fused_train_step(p, s, rna[:, :-1], dna, site, N_SITES)
    with pytest.raises(TypeError):
        ft.rna2dna_fused_train_step(p, s, rna, dna, site.int(), N_SITES)
    with pytest.raises(ValueError, match="n_sites"):
        ft.rna2dna_fused_train_step(p, s, rna, dna, site, N_SITES + 1)
    with pytest.raises(ValueError, match="batch size"):
        ft.rna2dna_fused_train_step(p, s, rna[:1], dna[:1], site[:1], N_SITES)
    with pytest.raises(ValueError, match="contiguous"):
        ft.rna2dna_fused_train_step(p, s, rna.t().contiguous().t(), dna, site, N_SITES)
    with pytest.raises(ValueError, match="seed"):
        ft.rna2dna_fused_train_step(p, s, rna, dna, site, N_SITES, seed=-1)


def test_port_init_is_a_function_of_its_seed():
    a = port_dv.rna2dna_vae_init(torch.Generator().manual_seed(3), DIM_A, DIM_B, N_SITES, LATENT)
    b = port_dv.rna2dna_vae_init(torch.Generator().manual_seed(3), DIM_A, DIM_B, N_SITES, LATENT)
    j, js = rna2dna_vae_init(jax.random.PRNGKey(0), DIM_A, DIM_B, N_SITES, LATENT)
    for (path, x), (_, y) in zip(_leaves(a[0]), _leaves(b[0])):
        assert torch.equal(x, y) and tuple(x.shape) == np.shape(_at(j, path)), path
    assert a[1]["encoder_rna"]["bn"]["var"].eq(1).all()
    assert tree_to_numpy(a[1]).keys() == js.keys()
