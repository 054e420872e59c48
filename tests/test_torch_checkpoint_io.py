"""Reference ``.pt`` checkpoints in and out of the port
(``vae_los_angeles_torch/utils/torch_import.py``), held against the JAX
package's ``utils/torch_import.py``: for each of the five model types, a
state_dict of the reference architecture (the torch-only builders of
``benchmarks/parity_vs_torch.py`` for the directional VAEs, the port's
modules, which carry the reference's key names, for the tri-modal VAE and
the autoencoders; random weights and
BatchNorm statistics from a seed) is imported by both packages (the same ``.npz`` leaf for leaf)
and exported back by both (the same ``.pt`` key for key and value for
value), the export loads with ``strict=True``, and a leftover key raises."""

import importlib.util
import pathlib

import jax  # noqa: F401  (the JAX package's checkpoint module is imported with it)
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.models import DNA2RNAAE, RNA2DNAAE, RNA2DNAVAE, MultiModalVAE
from vae_los_angeles_torch.training import checkpoint as port_ckpt
from vae_los_angeles_torch.utils import torch_import as port_ti
from vae_los_angeles_torch.utils.weights import state_dict_from_jax
from vae_los_angeles_tpu.training import checkpoint as jax_ckpt
from vae_los_angeles_tpu.utils import torch_import as jax_ti

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
DIM_A, DIM_B, N_SITES, LATENT = 16, 24, 5, 6
RUN_ID = "20240101_120000"


def _builders():
    spec = importlib.util.spec_from_file_location("parity_vs_torch",
                                                  REPO / "benchmarks" / "parity_vs_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {
        "rna2dna": lambda: mod.build_torch_model(DIM_A, DIM_B, N_SITES, LATENT),
        "dna2rna": lambda: mod.build_torch_model_d2r(DIM_A, DIM_B, N_SITES, LATENT),
        # that file's tri-modal and autoencoder oracles name their modules
        # otherwise (enc_a, to_latent, dec, ...); the port's modules carry
        # the reference's vae.py and directional_ae.py key names
        "multivae": lambda: MultiModalVAE(DIM_A, DIM_B, N_SITES, LATENT),
        "rna2dna_ae": lambda: RNA2DNAAE(DIM_A, DIM_B, N_SITES, LATENT),
        "dna2rna_ae": lambda: DNA2RNAAE(DIM_A, DIM_B, N_SITES, LATENT),
    }


BUILDERS = _builders()


def reference_pt(model_type, directory, seed=0):
    """A reference state_dict with seeded weights and BatchNorm statistics,
    saved as ``best_<model>_<run_id>.pt``."""
    torch.manual_seed(seed)
    model = BUILDERS[model_type]()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.rand(buf.shape, generator=gen) - 0.5)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
            elif name.endswith("num_batches_tracked"):
                buf.fill_(7)
    path = directory / f"best_{model_type}_{RUN_ID}.pt"
    torch.save(model.state_dict(), path)
    return path, model


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in leaves(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("model_type", sorted(BUILDERS))
def test_import_and_export_match_jax(model_type, tmp_path):
    pt, _ = reference_pt(model_type, tmp_path)
    assert port_ti.infer_model_type(str(pt)) == jax_ti.infer_model_type(str(pt)) == model_type

    port_npz, jax_npz = tmp_path / "port.npz", tmp_path / "jax.npz"
    port_ti.import_main([str(pt), "--model", model_type, "--out", str(port_npz)])
    jax_ti.import_main([str(pt), "--model", model_type, "--out", str(jax_npz)])
    got, want = port_ckpt.load(str(port_npz)), jax_ckpt.load(str(jax_npz))
    for g, w in zip(got, want):  # params, then state
        g, w = leaves(g), leaves(w)
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)

    port_pt, jax_pt = tmp_path / "port.pt", tmp_path / "jax.pt"
    port_ti.export_main([str(port_npz), "--model", model_type, "--out", str(port_pt)])
    jax_ti.export_main([str(jax_npz), "--model", model_type, "--out", str(jax_pt)])
    got_sd = torch.load(port_pt, weights_only=True)
    want_sd = torch.load(jax_pt, weights_only=True)
    assert list(got_sd) == list(want_sd) or sorted(got_sd) == sorted(want_sd)
    for key, want_t in want_sd.items():
        assert got_sd[key].dtype == want_t.dtype, key
        assert got_sd[key].shape == want_t.shape, key
        assert torch.equal(got_sd[key], want_t), key

    # the export loads strictly into the reference architecture, and gives
    # back the original weights and statistics (num_batches_tracked is 0)
    model = BUILDERS[model_type]()
    model.load_state_dict(got_sd, strict=True)
    original = torch.load(pt, weights_only=True)
    for key, value in original.items():
        if key.endswith("num_batches_tracked"):
            assert int(got_sd[key]) == 0
        else:
            assert torch.equal(got_sd[key], value), key


@pytest.mark.parametrize("model_type", sorted(BUILDERS))
def test_leftover_and_missing_keys_raise_as_in_jax(model_type, tmp_path):
    pt, _ = reference_pt(model_type, tmp_path)
    sd = port_ti.load_torch_state_dict(str(pt))
    extra = dict(sd, **{"decoder_x.fc.0.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unconsumed"):
        port_ti.convert_state_dict(extra, model_type)
    with pytest.raises(ValueError, match="unconsumed"):
        jax_ti.convert_state_dict(extra, model_type)
    missing = dict(sd)
    missing.pop(next(k for k in sd if k.endswith(".bias")))
    with pytest.raises(KeyError):
        port_ti.convert_state_dict(missing, model_type)
    with pytest.raises(KeyError):
        jax_ti.convert_state_dict(missing, model_type)


def test_wrong_model_and_bad_files_raise(tmp_path):
    pt, _ = reference_pt("rna2dna", tmp_path)
    sd = port_ti.load_torch_state_dict(str(pt))
    with pytest.raises((KeyError, ValueError)):
        port_ti.convert_state_dict(sd, "dna2rna")
    with pytest.raises(ValueError, match="unknown model type"):
        port_ti.convert_state_dict(sd, "rna2dna_unified")  # a port task, not a reference file
    with pytest.raises(ValueError, match="unknown model type"):
        port_ti.export_state_dict({}, {}, "nope")
    torch.save({"epoch": 3}, tmp_path / "not_a_state_dict.pt")
    with pytest.raises(ValueError, match="did not contain a state_dict"):
        port_ti.load_torch_state_dict(str(tmp_path / "not_a_state_dict.pt"))
    wrapped = tmp_path / "wrapped.pt"
    torch.save({"state_dict": torch.load(pt, weights_only=True), "epoch": 3}, wrapped)
    assert port_ti.load_torch_state_dict(str(wrapped)).keys() == sd.keys()
    with pytest.raises(SystemExit):
        port_ti.import_main([str(wrapped)])  # the model cannot be inferred from the name


def test_write_run_id_registers_and_serves(tmp_path, monkeypatch):
    """``--write-run-id``: the run id of the file name, the protocol's path,
    the run-id file in the working directory, and the port's module serves
    the imported weights as the reference model does."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CHECKPOINT_DIR", str(tmp_path / "ckpts"))
    pt, reference = reference_pt("rna2dna", tmp_path)
    with pytest.raises(SystemExit):  # --out elsewhere conflicts with the protocol's path
        port_ti.import_main([str(pt), "--write-run-id", "--out", str(tmp_path / "x.npz")])
    assert not (tmp_path / "ckpts").exists()
    port_ti.import_main([str(pt), "--write-run-id"])
    assert port_ckpt.get_run_id("rna2dna", str(tmp_path)) == RUN_ID
    params, state, run_id = port_ckpt.load_best("rna2dna", checkpoint_dir=str(tmp_path / "ckpts"),
                                                root=str(tmp_path))
    assert run_id == RUN_ID
    module = RNA2DNAVAE(DIM_A, DIM_B, N_SITES, LATENT, 32).eval()
    module.load_state_dict(state_dict_from_jax(params, state, "rna2dna"))
    reference.eval()
    x = torch.rand(9, DIM_A, generator=torch.Generator().manual_seed(3))
    s = torch.arange(9) % N_SITES
    with torch.no_grad():
        recon, _, mu, logvar = module(x, s, eps=torch.zeros(9, LATENT))
        want = reference(x, s, sample=False)
    for got, ref in ((recon, want[0]), (mu, want[1]), (logvar, want[2])):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
