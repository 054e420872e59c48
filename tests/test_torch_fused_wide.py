"""The wide head (``ops.kernels.fused_wide``, the port of the Pallas
``fused_wide_output_step``) against the JAX kernel, run in interpret mode on
the CPU as ``tests/test_pallas_wide.py`` runs it, on the same numpy inputs
and at that file's shapes: a full-block width, a width with a padded tail,
three chained steps and the padded tail's loss. On CPU tensors the wrapper
runs its plain version (autograd of the BCE sum + ``ops.optim.adamw_update``).

Tolerance: rtol 2e-5, atol 2e-6 for every output, the JAX test's own (fp32
on both sides, the products and sums taken in another order); the chain's
state rtol 5e-5, atol 5e-6 as there. Each JAX call is waited on
(``jax.block_until_ready``) before anything else is dispatched: the
interpret-mode kernel can deadlock when other JAX work runs beside it.

Also: the wrapper's input checks, and ``engine.fit``'s wide-head path (the
trunk by autograd, DecoderB's output layer through the wide head) training
the same run as the plain path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
from vae_los_angeles_torch.ops.kernels import fused_wide as fw
from vae_los_angeles_torch.training import engine
from vae_los_angeles_tpu.ops.losses import bce_with_logits_sum
from vae_los_angeles_tpu.ops.pallas.fused_wide import fused_wide_output_step as jax_step

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

NAMES = ["w", "b", "m_w", "v_w", "m_b", "v_b", "step", "dh", "loss"]
TOL = dict(rtol=2e-5, atol=2e-6)


def _inputs(n, d_in, D, seed=0):
    """numpy inputs drawn as ``tests/test_pallas_wide.py:_inputs`` draws them."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f(rng.normal(size=(n, d_in))), f(rng.random((n, D))),
            f(rng.normal(scale=0.05, size=(d_in, D))), f(rng.normal(scale=0.05, size=(D,))),
            f(rng.normal(scale=0.01, size=(d_in, D))), f(rng.random((d_in, D)) * 1e-4),
            f(rng.normal(scale=0.01, size=(D,))), f(rng.random((D,)) * 1e-4))


def _jax(args, step, lr, wd, block_cols):
    out = jax_step(*(jnp.asarray(a) for a in args), jnp.int32(step), jnp.float32(lr),
                   jnp.float32(wd), block_cols=block_cols)
    return [np.asarray(x) for x in jax.block_until_ready(out)]


def _port(args, step, lr, wd):
    out = fw.fused_wide_output_step(*(torch.from_numpy(a) for a in args),
                                    torch.tensor(step, dtype=torch.int32), lr, wd)
    return [x.detach().numpy() for x in out]


@pytest.mark.parametrize("D,block_cols", [(384, 128), (300, 128)])
def test_plain_version_matches_the_jax_kernel(D, block_cols):
    args = _inputs(16, 8, D)
    before = dict(fw.launches)
    want = _jax(args, 0, 1e-3, 1e-2, block_cols)
    got = _port(args, 0, 1e-3, 1e-2)
    assert fw.launches == before  # CPU tensors: the plain version, no kernel
    for name, g, e in zip(NAMES, got, want):
        assert g.shape == e.shape, name
        np.testing.assert_allclose(g, e, **TOL, err_msg=f"{name} (D={D})")


def test_three_chained_steps_match_the_jax_kernel():
    h, t, *state = _inputs(8, 8, 256, seed=3)
    state_j, state_p = state + [0], state + [0]
    for i in range(3):
        out_j = _jax([h, t, *state_j[:6]], state_j[6], 5e-4, 1e-4, 128)
        out_p = _port([h, t, *state_p[:6]], state_p[6], 5e-4, 1e-4)
        np.testing.assert_allclose(out_p[8], out_j[8], rtol=1e-5, err_msg=f"loss at step {i}")
        state_j, state_p = out_j[:7], out_p[:7]
    for name, g, e in zip(NAMES, state_p, state_j):
        np.testing.assert_allclose(g, e, rtol=5e-5, atol=5e-6, err_msg=name)
    assert int(state_p[6]) == int(state_j[6]) == 3


def test_padded_tail_width_and_loss():
    """D = 200 is no multiple of the JAX kernel's block: both return exactly
    D columns, and the loss is the BCE of the valid columns alone."""
    args = _inputs(8, 8, 200, seed=5)
    want = _jax(args, 0, 1e-3, 0.0, 128)
    got = _port(args, 0, 1e-3, 0.0)
    assert got[0].shape == (8, 200) and got[1].shape == (200,)
    h, t, w, b = args[:4]
    exact = float(bce_with_logits_sum(jnp.asarray(h) @ jnp.asarray(w) + jnp.asarray(b),
                                      jnp.asarray(t)))
    np.testing.assert_allclose(float(got[8]), exact, rtol=1e-6)
    for name, g, e in zip(NAMES, got, want):
        np.testing.assert_allclose(g, e, **TOL, err_msg=name)


@pytest.mark.parametrize("fault", ["bf16 moments", "non-contiguous", "shape", "device"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(fault):
    h, t, w, b, mw, vw, mb, vb = (torch.from_numpy(a) for a in _inputs(4, 8, 40))
    if fault == "bf16 moments":
        mw = mw.to(torch.bfloat16)
        err = TypeError
    elif fault == "non-contiguous":
        w = torch.from_numpy(np.ascontiguousarray(w.numpy().T)).t()
        err = ValueError
    elif fault == "shape":
        t = t[:, :-1].contiguous()
        err = ValueError
    else:
        h = h.to("meta")
        err = ValueError
    with pytest.raises(err):
        fw.fused_wide_output_step(h, t, w, b, mw, vw, mb, vb, 0, 1e-3, 0.0)


def test_fit_through_the_wide_head_trains_the_plain_run(monkeypatch):
    """The kernel path of rna2dna at ``engine.WIDE_HEAD_MIN_DIM_B`` probes or
    more trains through the wide head, once a step (here at 40 probes, the
    threshold lowered to 40). Same seed, same noise: the train and
    validation losses agree with the plain path to rtol 1e-5 and every
    parameter to atol 1e-6, except the encoder fc bias, whose true gradient
    through train-mode BatchNorm is zero (its fp32 noise becomes Adam steps
    of up to lr in each run's own direction: 2·lr per step)."""
    assert not engine.uses_wide_head("rna2dna", Config())  # the cohort width
    assert engine.uses_wide_head("rna2dna", Config(input_dim_b=450_000))
    tpm, beta, site = generate_synthetic_arrays(n_samples=120, dim_a=24, dim_b=40, n_sites=4,
                                                seed=1)
    cfg = Config(input_dim_a=24, input_dim_b=40, latent_dim=6, batch_size=16)
    data = ("rna2dna", cfg, (tpm[:96], beta[:96], site[:96]), (tpm[96:], beta[96:], site[96:]),
            2, 4)
    plain = engine.fit(*data, num_epochs=2, device="cpu")
    calls = []
    step = fw.fused_wide_output_step
    monkeypatch.setattr(fw, "fused_wide_output_step", lambda *a: calls.append(1) or step(*a))
    monkeypatch.setattr(engine, "WIDE_HEAD_MIN_DIM_B", 40)
    head = engine.fit(*data, num_epochs=2, device="cpu", fused_epoch=True)
    assert len(calls) == 12
    np.testing.assert_allclose(head.train_losses, plain.train_losses, rtol=1e-5)
    np.testing.assert_allclose(head.val_losses, plain.val_losses, rtol=1e-5)
    assert int(head.carry["opt"]["step"]) == int(plain.carry["opt"]["step"]) == 12
    for part in plain.final_params:
        for layer in plain.final_params[part]:
            for leaf, x in plain.final_params[part][layer].items():
                y = head.final_params[part][layer][leaf]
                atol = 2 * 5e-4 * 12 if (part, layer, leaf) == ("encoder_rna", "fc", "b") else 1e-6
                np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5, atol=atol,
                                           err_msg=f"{part}/{layer}/{leaf}")
    assert not engine.uses_wide_head("dna2rna", cfg)
