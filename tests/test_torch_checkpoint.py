"""Checkpoint format and run-id protocol shared by both packages: a
checkpoint either one writes loads in the other, and the port's loader
serves a JAX-written checkpoint with the JAX loader's posterior."""

import os

import jax
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.evaluation import loading as port_loading
from vae_los_angeles_torch.training import checkpoint as port_ckpt
from vae_los_angeles_tpu.config import Config
from vae_los_angeles_tpu.evaluation import loading as jax_loading
from vae_los_angeles_tpu.models.directional_vae import dna2rna_vae_init, rna2dna_vae_init
from vae_los_angeles_tpu.training import checkpoint as jax_ckpt

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT = 40, 56, 5, 8
CHAIN = dict(atol=1e-4, rtol=1e-4)
FAMILIES = {
    "rna2dna": (rna2dna_vae_init, "rna", DIM_A, port_loading.load_rna2dna,
                jax_loading.load_rna2dna),
    "dna2rna": (dna2rna_vae_init, "dna", DIM_B, port_loading.load_dna2rna,
                jax_loading.load_dna2rna),
}


def jax_model(model_type, seed=0):
    params, state = FAMILIES[model_type][0](jax.random.PRNGKey(seed), DIM_A, DIM_B, N_SITES, LATENT)
    state = jax.tree.map(
        lambda x: x + 0.3 * jax.random.uniform(jax.random.PRNGKey(seed + 1), x.shape), state
    )
    return jax.tree.map(np.asarray, (params, state))


def assert_same_tree(a, b):
    fa, fb = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (a, b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_jax_checkpoint_serves_in_the_port(model_type, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, kw, din, port_load, jax_load = FAMILIES[model_type]
    params, state = jax_model(model_type)
    cfg = Config(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT,
                 checkpoint_dir=str(tmp_path / "ckpt"))
    run_id = jax_ckpt.new_run_id()
    jax_ckpt.save_best(model_type, run_id, params, state, cfg.checkpoint_dir)
    jax_ckpt.write_run_id(model_type, run_id)

    rng = np.random.default_rng(0)
    x = rng.uniform(size=(16, din)).astype(np.float32)
    site = rng.integers(0, N_SITES, size=(16,))
    port_model = port_load(cfg=cfg, device="cpu")
    jax_model_ = jax_load(cfg=cfg)
    assert port_model.run_id == jax_model_.run_id == run_id
    recon, mu, logvar = port_model(**{kw: x}, site=site)
    _, jmu, jlv = jax_model_(**{kw: x}, site=site)
    assert isinstance(recon, np.ndarray) and recon.shape == (16, DIM_B if kw == "rna" else DIM_A)
    np.testing.assert_allclose(mu, jmu, **CHAIN)
    np.testing.assert_allclose(logvar, jlv, **CHAIN)
    # a fixed default seed, and a caller's generator picks another draw
    again, _, _ = port_model(**{kw: x}, site=site)
    np.testing.assert_array_equal(recon, again)
    other, _, _ = port_model(**{kw: x}, site=site, generator=torch.Generator().manual_seed(9))
    assert not np.array_equal(recon, other)
    with pytest.raises(ValueError):
        port_model(**{kw: x}, site=np.full(16, N_SITES))
    # site-only imputation is served, as the JAX loader serves it
    _, smu, slv = port_model(site=site)
    _, jsmu, jslv = jax_model_(site=site)
    np.testing.assert_allclose(smu, jsmu, **CHAIN)
    np.testing.assert_allclose(slv, jslv, **CHAIN)
    with pytest.raises(ValueError):
        port_model()


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_port_checkpoint_loads_in_the_jax_package(model_type, tmp_path):
    params, state = jax_model(model_type, seed=3)
    as_tensors = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), (params, state))
    path = port_ckpt.save_best(model_type, "20260101_000000", *as_tensors, str(tmp_path))
    port_ckpt.write_run_id(model_type, "20260101_000000", str(tmp_path))
    assert path == jax_ckpt.checkpoint_path(model_type, "20260101_000000", str(tmp_path))
    p2, s2, rid = jax_ckpt.load_best(model_type, None, str(tmp_path), str(tmp_path))
    assert rid == "20260101_000000"
    assert_same_tree((params, state), (p2, s2))
    p3, s3, _ = port_ckpt.load_best(model_type, None, str(tmp_path), str(tmp_path))
    assert_same_tree((params, state), (p3, s3))


def test_flat_format_is_identical(tmp_path):
    tree = {"a": {"b": np.arange(3, dtype=np.float32), "empty": {}}, "c": np.float32(2.0)}
    port_ckpt.save(str(tmp_path / "p.npz"), tree, {"s": {}})
    jax_ckpt.save(str(tmp_path / "j.npz"), tree, {"s": {}})
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        assert "params/a/empty/__empty_dict__" in p.files
        for k in p.files:
            np.testing.assert_array_equal(p[k], j[k])
    params, state = port_ckpt.load(str(tmp_path / "j.npz"))
    assert params["a"]["empty"] == {} and state == {"s": {}}


def test_bfloat16_is_refused(tmp_path):
    """A bf16 leaf round-trips bit for bit as JAX's uint16 + ``.__bf16__``
    format, in both directions between the packages; what is still refused
    is a key that ends with that reserved marker (JAX
    ``test_checkpoint_rejects_reserved_bf16_marker``), a '/' in a key and a
    list node."""
    import jax.numpy as jnp

    vals = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    jax_ckpt.save(str(tmp_path / "bf16.npz"), {"w": jnp.asarray(vals, jnp.bfloat16)},
                  {"s": jnp.ones(2)})
    params, state = port_ckpt.load(str(tmp_path / "bf16.npz"))
    assert params["w"].dtype == torch.bfloat16
    want = torch.from_numpy(vals).to(torch.bfloat16)  # round to nearest even, as astype
    assert torch.equal(params["w"].view(torch.int16), want.view(torch.int16))
    np.testing.assert_array_equal(state["s"], np.ones(2, np.float32))
    port_ckpt.save(str(tmp_path / "p.npz"), {"w": want, "b": torch.ones(2)})
    with np.load(tmp_path / "p.npz") as f:
        assert sorted(f.files) == ["params/b", "params/w.__bf16__"]
    back, _ = jax_ckpt.load(str(tmp_path / "p.npz"))
    assert back["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["w"]).view(np.uint16),
                                  want.view(torch.int16).numpy().view(np.uint16))
    with pytest.raises(ValueError, match="reserved bfloat16 storage marker"):
        port_ckpt.save(str(tmp_path / "x.npz"), {"w.__bf16__": np.zeros(1)})
    with pytest.raises(ValueError):
        port_ckpt.save(str(tmp_path / "x.npz"), {"a/b": np.zeros(1)})
    with pytest.raises(TypeError):
        port_ckpt.save(str(tmp_path / "x.npz"), {"a": [np.zeros(1)]})


def test_run_id_protocol(tmp_path):
    assert port_ckpt.get_run_id("rna2dna", str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        port_ckpt.load_best("rna2dna", None, str(tmp_path), str(tmp_path))
    rid = port_ckpt.new_run_id()
    assert len(rid) == 15 and rid[8] == "_" and rid.replace("_", "").isdigit()
    port_ckpt.write_run_id("rna2dna", rid, str(tmp_path))
    assert port_ckpt.get_run_id("rna2dna", str(tmp_path)) == rid
    assert jax_ckpt.get_run_id("rna2dna", str(tmp_path)) == rid
    assert os.path.basename(port_ckpt.run_id_file("dna2rna")) == "latest_dna2rna_run_id.txt"
    with pytest.raises(FileNotFoundError):  # run id recorded, checkpoint missing
        port_ckpt.load_best("rna2dna", None, str(tmp_path), str(tmp_path))
    cfg = Config(checkpoint_dir=str(tmp_path / "none"))
    assert port_loading.load_rna2dna(cfg=cfg, root=str(tmp_path), device="cpu") is None
