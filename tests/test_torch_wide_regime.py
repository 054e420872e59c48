"""The whole-methylome-width regime's knobs against the JAX package, at small
widths on the same numpy inputs: bf16 optimizer moments, Adafactor, the bf16
forward (``cast_matmul_params`` + ``linear_apply``), ``engine.fit`` with each
knob, the kernel paths' refusals, the CLI's flags and downgrade, resume
carries with bf16 moments or Adafactor state moving between the packages,
and bf16 serving through the loaders.

Tolerances and why:
  * bf16 moments: bit-equal. Both packages compute the update in fp32 with
    the same operations and round to nearest even.
  * Adafactor: params and fp32 statistics rtol 2e-6 (rsqrt and the row and
    column means are summed and rounded in another order, measured 5e-7);
    bf16 statistics within one bf16 ulp (rtol 2**-8).
  * bf16 linear: output and gradients rtol 1e-6 (products of bf16 values
    are exact in fp32; the sums run in another order).
  * fit with a knob: the statistical oracle of ``test_torch_training.py``
    (the two engines' noise streams differ): the same epoch count, β and
    learning rates exactly, the train and final validation losses within 5%.
  * bf16 serving: both loaders serve z = mu; within atol 5e-3 + rtol 5e-3
    (each layer's fp32 output is rounded to bf16 before the next product, so
    an fp32 difference of one ulp can move an input by a bf16 ulp, 2**-8).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.config import Config as PortConfig
from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
from vae_los_angeles_torch.evaluation import loading as port_loading
from vae_los_angeles_torch.models import directional_vae as port_dv
from vae_los_angeles_torch.ops import nn as port_nn
from vae_los_angeles_torch.ops import optim as port_optim
from vae_los_angeles_torch.training import checkpoint as port_ckpt
from vae_los_angeles_torch.training import cli as port_cli
from vae_los_angeles_torch.training import engine as port_engine
from vae_los_angeles_torch.utils.weights import tree_from_numpy, tree_to_numpy
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.data.dataset import MultiModalArrays
from vae_los_angeles_tpu.evaluation import loading as jax_loading
from vae_los_angeles_tpu.models import directional_vae as jdv
from vae_los_angeles_tpu.ops import nn as jax_nn
from vae_los_angeles_tpu.ops import optim as jax_optim
from vae_los_angeles_tpu.training import checkpoint as jax_ckpt
from vae_los_angeles_tpu.training import engine as jax_engine

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, BATCH = 40, 56, 5, 8, 16
DIMS = dict(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT, batch_size=BATCH)
KNOBS = {
    "compute_bf16": {"compute_dtype": "bfloat16"},
    "moments_bf16": {"moments_dtype": "bfloat16"},
    "adafactor": {"optimizer": "adafactor"},
}
SHAPES = {"w": (6, 9), "t": (2, 3, 4), "b": (9,)}
T = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa: E731


def bits(x):
    """uint16 bit patterns of a bf16 torch tensor or JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.fixture(scope="module")
def cohort():
    return generate_synthetic_arrays(n_samples=200, dim_a=DIM_A, dim_b=DIM_B, n_sites=N_SITES,
                                     seed=0)


def _tree_and_grads(seed, steps):
    rng = np.random.default_rng(seed)
    draw = lambda: {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}  # noqa: E731
    return draw(), [draw() for _ in range(steps)]


def test_bf16_moments_are_bit_equal_to_jax():
    params, grads = _tree_and_grads(0, 5)
    p, st = T(params), port_optim.adamw_init(T(params), "bfloat16")
    jp, jst = params, jax_optim.adamw_init(params, jnp.bfloat16)
    for g in grads:
        p, st = port_optim.adamw_update(p, T(g), st, 3e-3, 1e-2)
        jp, jst = jax_optim.adamw_update(jp, g, jst, 3e-3, 1e-2)
    assert int(st["step"]) == int(jst["step"]) == 5
    for key in ("m", "v"):
        for name in SHAPES:
            assert st[key][name].dtype == torch.bfloat16
            np.testing.assert_array_equal(bits(st[key][name]), bits(jst[key][name]))
    for name in SHAPES:
        assert p[name].dtype == torch.float32
        np.testing.assert_allclose(p[name].numpy(), np.asarray(jp[name]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("moments", [None, "bfloat16"])
def test_adafactor_matches_jax(moments):
    params, grads = _tree_and_grads(1, 4)
    p, st = T(params), port_optim.adafactor_init(T(params), moments)
    jp, jst = params, jax_optim.adafactor_init(params, None if moments is None else jnp.bfloat16)
    for g in grads:
        p, st = port_optim.adafactor_update(p, T(g), st, 1e-2, 1e-2)
        jp, jst = jax_optim.adafactor_update(jp, g, jst, 1e-2, 1e-2)
    assert set(st) == set(jst) == {"step", "vr", "vc"} and int(st["step"]) == 4
    stat_tol = dict(rtol=2e-6) if moments is None else dict(rtol=2.0 ** -8)
    for name in SHAPES:
        np.testing.assert_allclose(p[name].numpy(), np.asarray(jp[name]), rtol=2e-6, atol=1e-7)
        for key in ("vr", "vc"):
            got, want = st[key][name], jst[key][name]
            assert tuple(got.shape) == want.shape, (key, name)
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       **stat_tol)
    assert st["vc"]["b"].shape == (0,)  # a 1-D leaf keeps a full statistic


def test_cast_matmul_params_and_linear_apply_match_jax():
    rng = np.random.default_rng(2)
    params = {"fc": {"w": rng.normal(size=(24, 8)).astype(np.float32),
                     "b": rng.normal(size=8).astype(np.float32)},
              "bn": {"gamma": np.ones(8, np.float32)},
              "emb": {"table": rng.normal(size=(4, 24)).astype(np.float32)}}
    port = tree_from_numpy(params)
    cast = port_nn.cast_matmul_params(port, torch.bfloat16)
    assert cast["fc"]["w"].dtype == cast["emb"]["table"].dtype == torch.bfloat16
    assert cast["fc"]["b"].dtype == cast["bn"]["gamma"].dtype == torch.float32
    assert port_nn.cast_matmul_params(port, torch.float32) is port
    jcast = jax_nn.cast_matmul_params(params, jnp.bfloat16)
    np.testing.assert_array_equal(bits(cast["fc"]["w"]), bits(jcast["fc"]["w"]))

    x = rng.normal(size=(16, 24)).astype(np.float32)
    site = np.array([0, 3, 1, 2] * 4)

    def jax_fn(w, b, table, x):
        p = jax_nn.cast_matmul_params({"w": w, "b": b, "table": table}, jnp.bfloat16)
        h = jnp.take(p["table"], site, axis=0)  # bf16 rows meet the bf16 weight
        return jnp.sum(jnp.sin(jax_nn.linear_apply(p, x) + jax_nn.linear_apply(p, h)))

    jy = jax_nn.linear_apply(jcast["fc"], jnp.asarray(x))
    jgrads = jax.grad(jax_fn, argnums=(0, 1, 2, 3))(params["fc"]["w"], params["fc"]["b"],
                                                    params["emb"]["table"], x)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (params["fc"]["w"], params["fc"]["b"], params["emb"]["table"], x)]
    p = port_nn.cast_matmul_params({"w": leaves[0], "b": leaves[1], "table": leaves[2]},
                                   torch.bfloat16)
    y = port_nn.linear_apply(cast["fc"], torch.from_numpy(x))
    assert y.dtype == torch.float32 and jy.dtype == jnp.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    out = torch.sin(port_nn.linear_apply(p, leaves[3])
                    + port_nn.linear_apply(p, p["table"][torch.from_numpy(site)])).sum()
    for got, want in zip(torch.autograd.grad(out, leaves), jgrads):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _split(cohort):
    tpm, beta, site = cohort
    return (tpm[:160], beta[:160], site[:160]), (tpm[160:], beta[160:], site[160:])


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_fit_with_each_knob_agrees_with_jax(cohort, knob):
    (tr, va), kw = _split(cohort), KNOBS[knob]
    params, state = jdv.rna2dna_vae_init(jax.random.PRNGKey(0), DIM_A, DIM_B, N_SITES, LATENT)
    j_arrays = lambda a: MultiModalArrays(*(jnp.asarray(x) for x in a))  # noqa: E731
    want = jax.device_get(jax_engine.fit(
        "rna2dna", JaxConfig(**DIMS, **kw), j_arrays(tr), j_arrays(va), jax.random.PRNGKey(1),
        N_SITES, num_epochs=3, init_params=params, init_state=state))
    got = port_engine.fit("rna2dna", PortConfig(**DIMS, **kw), tr, va, 1, N_SITES, num_epochs=3,
                          init_params=jax.tree.map(np.asarray, params),
                          init_state=jax.tree.map(np.asarray, state), device="cpu")
    assert got.epochs_ran == int(want.epochs_ran) == 3
    np.testing.assert_array_equal(got.betas, np.asarray(want.betas))
    np.testing.assert_array_equal(got.lrs, np.asarray(want.lrs))
    np.testing.assert_allclose(got.train_losses, np.asarray(want.train_losses), rtol=0.05)
    np.testing.assert_allclose(got.val_losses[-1], float(want.val_losses[-1]), rtol=0.05)
    assert got.train_losses[-1] < got.train_losses[0]
    opt, jopt = got.carry["opt"], want.carry["opt"]
    assert set(opt) == set(jopt)
    for key in set(opt) - {"step"}:
        dtypes = {str(leaf.dtype).removeprefix("torch.")
                  for leaf in jax.tree.leaves(tree_to_numpy(opt[key]))}
        assert dtypes == {str(leaf.dtype) for leaf in jax.tree.leaves(jopt[key])}, key


@pytest.mark.parametrize("path", ["fused_step", "fused_epoch", "fused_head"])
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_kernel_paths_refuse_each_knob(cohort, knob, path, monkeypatch):
    """``fused_head``: the epoch kernel's request at a width that takes the
    wide head (the threshold lowered to this cohort's width)."""
    tr, va = _split(cohort)
    cfg = PortConfig(**DIMS, **KNOBS[knob])
    if path == "fused_head":
        monkeypatch.setattr(port_engine, "WIDE_HEAD_MIN_DIM_B", DIM_B)
        assert port_engine.uses_wide_head("rna2dna", cfg)
    with pytest.raises(ValueError, match="plain path only"):
        port_engine.fit("rna2dna", cfg, tr, va, 0, N_SITES, num_epochs=1, device="cpu",
                        **{"fused_step" if path == "fused_step" else "fused_epoch": True})


def test_kernel_paths_refuse_a_resume_carry_with_bf16_moments(cohort):
    tr, va = _split(cohort)
    res = port_engine.fit("rna2dna", PortConfig(**DIMS, moments_dtype="bfloat16"), tr, va, 0,
                          N_SITES, num_epochs=1, device="cpu")
    with pytest.raises(ValueError, match="reduced moments"):
        port_engine.fit("rna2dna", PortConfig(**DIMS), tr, va, 0, N_SITES, num_epochs=1,
                        device="cpu", resume_carry=tree_to_numpy(res.carry), start_epoch=1,
                        fused_epoch=True)


def _cli_cfg(tmp_path, **kw):
    return PortConfig(**DIMS, checkpoint_dir=str(tmp_path / "checkpoints"),
                      plots_dir=str(tmp_path / "plots"), **kw)


def test_cli_flags_downgrade_and_bf16_resume_between_the_packages(cohort, tmp_path,
                                                                   monkeypatch, capsys):
    """``--moments_dtype bfloat16`` beats MOMENTS_DTYPE=float32 in the
    environment; with USE_PALLAS the CLI says it trains on the plain path;
    the resume file stores the bf16 moments as JAX does and JAX's
    ``load_resume`` reads them bit for bit; a JAX-written bf16 carry resumes
    in the port, with the note that MOMENTS_DTYPE is ignored on resume."""
    monkeypatch.setenv("MOMENTS_DTYPE", "float32")
    monkeypatch.chdir(tmp_path)
    cfg = PortConfig.from_env(**DIMS, checkpoint_dir=str(tmp_path / "checkpoints"),
                              plots_dir=str(tmp_path / "plots"), use_pallas=True)
    assert cfg.moments_dtype == "float32"
    result, run_id, _ = port_cli.run_training(
        cfg=cfg, argv=["--epochs", "1", "--moments_dtype", "bfloat16"], data=cohort,
        n_sites=N_SITES, device="cpu")
    assert "MOMENTS_DTYPE=bfloat16: using the plain path" in capsys.readouterr().out
    assert result.carry["opt"]["m"]["decoder_dna"]["fc3"]["w"].dtype == torch.bfloat16
    with np.load(tmp_path / "checkpoints" / f"resume_rna2dna_{run_id}.npz") as f:
        assert "carry/opt/m/decoder_dna/fc3/w.__bf16__" in f.files
    carry, epochs, _, _ = jax_ckpt.load_resume("rna2dna", run_id, str(tmp_path / "checkpoints"))
    assert epochs == 1 and carry["opt"]["v"]["encoder_rna"]["fc"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        bits(carry["opt"]["m"]["decoder_dna"]["fc3"]["w"]),
        bits(result.carry["opt"]["m"]["decoder_dna"]["fc3"]["w"]))

    # back: the JAX package writes the carry, the port resumes from it
    jax_ckpt.save_resume("rna2dna", "20260101_000009", carry, 1, str(tmp_path / "checkpoints"),
                         seed=0)
    port_ckpt.write_run_id("rna2dna", "20260101_000009")
    again, rid, _ = port_cli.run_training(cfg=cfg.replace(use_pallas=False),
                                          argv=["--resume", "--epochs", "1"], data=cohort,
                                          n_sites=N_SITES, device="cpu")
    out = capsys.readouterr().out
    assert rid == "20260101_000009" and again.epochs_ran == 1
    assert "Config.moments_dtype='float32' is ignored for this run" in out
    assert again.carry["opt"]["m"]["encoder_rna"]["fc"]["w"].dtype == torch.bfloat16
    assert int(again.carry["opt"]["step"]) == 2 * (160 // BATCH)


def test_cli_adafactor_run_resumes_and_refuses_another_optimizer(cohort, tmp_path,
                                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _cli_cfg(tmp_path)
    first, run_id, _ = port_cli.run_training(cfg=cfg, argv=["--epochs", "1", "--optimizer",
                                                            "adafactor"],
                                             data=cohort, n_sites=N_SITES, device="cpu")
    assert set(first.carry["opt"]) == {"step", "vr", "vc"}
    carry, _, _, _ = jax_ckpt.load_resume("rna2dna", run_id, str(tmp_path / "checkpoints"))
    assert carry["opt"]["vc"]["decoder_dna"]["fc3"]["b"].shape == (0,)
    again, _, _ = port_cli.run_training(cfg=cfg, argv=["--resume", "--epochs", "1",
                                                       "--optimizer", "adafactor"],
                                        data=cohort, n_sites=N_SITES, device="cpu")
    assert again.epochs_ran == 1 and set(again.carry["opt"]) == {"step", "vr", "vc"}
    with pytest.raises(ValueError, match="optimizer state"):
        port_cli.run_training(cfg=cfg, argv=["--resume", "--epochs", "1"], data=cohort,
                              n_sites=N_SITES, device="cpu")


@pytest.mark.parametrize("model_type,kw,width", [("rna2dna", "rna", DIM_A),
                                                 ("dna2rna", "dna", DIM_B)])
def test_bf16_serving_matches_the_jax_loader(model_type, kw, width, tmp_path, monkeypatch,
                                             capsys):
    init = {"rna2dna": jdv.rna2dna_vae_init, "dna2rna": jdv.dna2rna_vae_init}[model_type]
    params, state = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3), DIM_A, DIM_B,
                                                  N_SITES, LATENT))
    jax_ckpt.save_best(model_type, "20260101_000003", params, state, str(tmp_path))
    port_ckpt.write_run_id(model_type, "20260101_000003", str(tmp_path))
    x = np.random.default_rng(4).random((9, width)).astype(np.float32)
    site = np.arange(9) % N_SITES
    monkeypatch.setattr(jdv, "reparameterize", lambda key, mu, logvar, noise_scale=None: mu)
    monkeypatch.setattr(port_dv, "reparameterize", lambda mu, logvar, eps=None, generator=None: mu)
    jax_loading._jitted_directional.cache_clear()
    try:
        j_model = getattr(jax_loading, f"load_{model_type}")(
            cfg=JaxConfig(**DIMS, checkpoint_dir=str(tmp_path), compute_dtype="bfloat16"),
            root=str(tmp_path))
        want = j_model(**{kw: x}, site=site)
    finally:
        jax_loading._jitted_directional.cache_clear()
    cfg = PortConfig(**DIMS, checkpoint_dir=str(tmp_path), compute_dtype="bfloat16",
                     use_pallas=True)
    model = getattr(port_loading, f"load_{model_type}")(cfg=cfg, root=str(tmp_path),
                                                        device="cpu")
    assert "COMPUTE_DTYPE=bfloat16: serving via the plain path" in capsys.readouterr().out
    assert model._fused is None
    weights = jax.tree.leaves(tree_to_numpy(model._plain[0]))
    assert {str(w.dtype) for w in weights if w.ndim == 2} == {"torch.bfloat16"}
    assert {str(w.dtype) for w in weights if w.ndim == 1} == {"float32"}
    got = model(**{kw: x}, site=site)
    for g, e in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(e), atol=5e-3, rtol=5e-3)
    fp32 = getattr(port_loading, f"load_{model_type}")(
        cfg=cfg.replace(compute_dtype="float32"), root=str(tmp_path), device="cpu")
    assert fp32._fused is not None
    assert 0.0 < float(np.max(np.abs(fp32(**{kw: x}, site=site, )[1] - got[1]))) < 0.15
    assert os.path.exists(tmp_path / f"best_{model_type}_20260101_000003.npz")
