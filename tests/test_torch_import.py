"""Reference-checkpoint migration: torch .pt state_dicts → framework pytrees.

Each test builds the torch architecture EXACTLY as the reference defines it
(module attribute names drive state_dict keys — src/models/encoders.py,
decoders.py, directional_vae.py:12-75, directional_ae.py:10-99, vae.py:29-35),
randomizes it, exports the state_dict, converts with
`utils/torch_import.convert_state_dict`, and checks the framework forward
reproduces the torch forward on the deterministic paths (mu/logvar for the
VAEs, the full recon for the AEs, all six decoder heads for the tri-modal).
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp

from vae_los_angeles_tpu.models import directional_ae, directional_vae, vae
from vae_los_angeles_tpu.utils.torch_import import (
    convert_state_dict,
    load_torch_state_dict,
)

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, EMBED = 23, 31, 5, 7, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


# -- reference architectures, names exactly as upstream ---------------------


class _EncoderA(tnn.Module):  # encoders.py:10-24
    def __init__(self, input_dim, latent_dim):
        super().__init__()
        self.fc = tnn.Sequential(
            tnn.Linear(input_dim, 128), tnn.BatchNorm1d(128), tnn.ReLU(),
            tnn.Dropout(0.1),
        )
        self.fc_mu = tnn.Linear(128, latent_dim)
        self.fc_logvar = tnn.Linear(128, latent_dim)

    def forward(self, x):
        h = self.fc(x)
        return self.fc_mu(h), self.fc_logvar(h)


class _EncoderB(tnn.Module):  # encoders.py:27-46
    def __init__(self, input_dim, latent_dim):
        super().__init__()
        self.fc = tnn.Sequential(
            tnn.Linear(input_dim, 512), tnn.BatchNorm1d(512), tnn.ReLU(),
            tnn.Dropout(0.1), tnn.Linear(512, 256), tnn.BatchNorm1d(256),
            tnn.ReLU(), tnn.Dropout(0.1),
        )
        self.fc_mu = tnn.Linear(256, latent_dim)
        self.fc_logvar = tnn.Linear(256, latent_dim)

    def forward(self, x):
        h = self.fc(x)
        return self.fc_mu(h), self.fc_logvar(h)


class _EncoderC(tnn.Module):  # encoders.py:49-62
    def __init__(self, n_sites, latent_dim, embed_dim):
        super().__init__()
        self.embedding = tnn.Embedding(n_sites, embed_dim)
        self.fc_mu = tnn.Linear(embed_dim, latent_dim)
        self.fc_logvar = tnn.Linear(embed_dim, latent_dim)

    def forward(self, x):
        h = self.embedding(x)
        return self.fc_mu(h), self.fc_logvar(h)


def _decoder_a(latent, out):  # decoders.py:8-19
    return tnn.Sequential(tnn.Linear(latent, 128), tnn.ReLU(),
                          tnn.Linear(128, out))


def _decoder_b(latent, out):  # decoders.py:22-37
    return tnn.Sequential(tnn.Linear(latent, 256), tnn.ReLU(),
                          tnn.Linear(256, 512), tnn.ReLU(),
                          tnn.Linear(512, out), tnn.Sigmoid())


def _decoder_c(latent, n_sites):  # decoders.py:40-51
    return tnn.Sequential(tnn.Linear(latent, 64), tnn.ReLU(),
                          tnn.Linear(64, n_sites))


class _DecWrap(tnn.Module):
    """Reference decoders are `self.fc = Sequential(...)` modules."""

    def __init__(self, seq):
        super().__init__()
        self.fc = seq

    def forward(self, z):
        return self.fc(z)


def _mean_fuse(pairs):
    mus = torch.stack([p[0] for p in pairs]).mean(0)
    lvs = torch.stack([p[1] for p in pairs]).mean(0)
    return mus, lvs


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    rna = rng.standard_normal((6, DIM_A)).astype(np.float32)
    dna = rng.random((6, DIM_B)).astype(np.float32)
    site = rng.integers(0, N_SITES, 6).astype(np.int32)
    return rna, dna, site


def test_rna2dna_vae_import(data):
    rna, _, site = data
    torch.manual_seed(1)

    class Ref(tnn.Module):  # directional_vae.py:12-24
        def __init__(self):
            super().__init__()
            self.encoder_rna = _EncoderA(DIM_A, LATENT)
            self.encoder_site = _EncoderC(N_SITES, LATENT, EMBED)
            self.decoder_dna = _DecWrap(_decoder_b(LATENT, DIM_B))

    ref = Ref().eval()
    params, state = convert_state_dict(_sd(ref), "rna2dna")

    with torch.no_grad():
        t_mu, t_lv = _mean_fuse([
            ref.encoder_rna(torch.from_numpy(rna)),
            ref.encoder_site(torch.from_numpy(site).long()),
        ])
        t_dec = ref.decoder_dna(t_mu)
    out = directional_vae.rna2dna_vae_apply(
        params, state, jax.random.PRNGKey(0), rna=jnp.asarray(rna),
        site=jnp.asarray(site), train=False,
    )
    np.testing.assert_allclose(np.asarray(out.mu), t_mu.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(out.logvar), t_lv.numpy(), **TOL)
    # decoder parity on the deterministic z=mu path
    from vae_los_angeles_tpu.models.decoders import decoder_b_apply

    np.testing.assert_allclose(
        np.asarray(decoder_b_apply(params["decoder_dna"], out.mu)),
        t_dec.numpy(), **TOL,
    )


def test_dna2rna_vae_import(data):
    _, dna, site = data
    torch.manual_seed(2)

    class Ref(tnn.Module):  # directional_vae.py:63-75
        def __init__(self):
            super().__init__()
            self.encoder_dna = _EncoderB(DIM_B, LATENT)
            self.encoder_site = _EncoderC(N_SITES, LATENT, EMBED)
            self.decoder_rna = _DecWrap(_decoder_a(LATENT, DIM_A))

    ref = Ref().eval()
    params, state = convert_state_dict(_sd(ref), "dna2rna")

    with torch.no_grad():
        t_mu, t_lv = _mean_fuse([
            ref.encoder_dna(torch.from_numpy(dna)),
            ref.encoder_site(torch.from_numpy(site).long()),
        ])
        t_dec = ref.decoder_rna(t_mu)
    out = directional_vae.dna2rna_vae_apply(
        params, state, jax.random.PRNGKey(0), dna=jnp.asarray(dna),
        site=jnp.asarray(site), train=False,
    )
    np.testing.assert_allclose(np.asarray(out.mu), t_mu.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(out.logvar), t_lv.numpy(), **TOL)
    from vae_los_angeles_tpu.models.decoders import decoder_a_apply

    np.testing.assert_allclose(
        np.asarray(decoder_a_apply(params["decoder_rna"], out.mu)),
        t_dec.numpy(), **TOL,
    )


def test_rna2dna_ae_import(data):
    rna, _, site = data
    torch.manual_seed(3)

    class Ref(tnn.Module):  # directional_ae.py:10-35
        def __init__(self):
            super().__init__()
            self.encoder_rna = tnn.Sequential(
                tnn.Linear(DIM_A, 128), tnn.BatchNorm1d(128), tnn.ReLU(),
                tnn.Dropout(0.1), tnn.Linear(128, LATENT),
            )
            self.site_embedding = tnn.Embedding(N_SITES, EMBED)
            self.site_projection = tnn.Linear(EMBED, LATENT)
            self.decoder_dna = _DecWrap(_decoder_b(LATENT, DIM_B))

    ref = Ref().eval()
    params, state = convert_state_dict(_sd(ref), "rna2dna_ae")

    with torch.no_grad():
        lat = torch.stack([
            ref.encoder_rna(torch.from_numpy(rna)),
            ref.site_projection(ref.site_embedding(torch.from_numpy(site).long())),
        ]).mean(0)
        t_rec = ref.decoder_dna(lat)
    out = directional_ae.rna2dna_ae_apply(
        params, state, jax.random.PRNGKey(0), rna=jnp.asarray(rna),
        site=jnp.asarray(site), train=False,
    )
    # the AE eval forward is fully deterministic → compare end to end
    np.testing.assert_allclose(np.asarray(out.latent), lat.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(out.recon), t_rec.numpy(), **TOL)


def test_dna2rna_ae_import(data):
    _, dna, site = data
    torch.manual_seed(4)

    class Ref(tnn.Module):  # directional_ae.py:73-99
        def __init__(self):
            super().__init__()
            self.encoder_dna = tnn.Sequential(
                tnn.Linear(DIM_B, 512), tnn.BatchNorm1d(512), tnn.ReLU(),
                tnn.Dropout(0.1), tnn.Linear(512, 256), tnn.BatchNorm1d(256),
                tnn.ReLU(), tnn.Dropout(0.1), tnn.Linear(256, LATENT),
            )
            self.site_embedding = tnn.Embedding(N_SITES, EMBED)
            self.site_projection = tnn.Linear(EMBED, LATENT)
            self.decoder_rna = _DecWrap(_decoder_a(LATENT, DIM_A))

    ref = Ref().eval()
    params, state = convert_state_dict(_sd(ref), "dna2rna_ae")

    with torch.no_grad():
        lat = torch.stack([
            ref.encoder_dna(torch.from_numpy(dna)),
            ref.site_projection(ref.site_embedding(torch.from_numpy(site).long())),
        ]).mean(0)
        t_rec = ref.decoder_rna(lat)
    out = directional_ae.dna2rna_ae_apply(
        params, state, jax.random.PRNGKey(0), dna=jnp.asarray(dna),
        site=jnp.asarray(site), train=False,
    )
    np.testing.assert_allclose(np.asarray(out.latent), lat.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(out.recon), t_rec.numpy(), **TOL)


def test_multivae_import(data):
    rna, dna, site = data
    torch.manual_seed(5)

    class Ref(tnn.Module):  # vae.py:29-35
        def __init__(self):
            super().__init__()
            self.encoder_a = _EncoderA(DIM_A, LATENT)
            self.encoder_b = _EncoderB(DIM_B, LATENT)
            self.encoder_c = _EncoderC(N_SITES, LATENT, EMBED)
            self.decoder_a = _DecWrap(_decoder_a(LATENT, DIM_A))
            self.decoder_b = _DecWrap(_decoder_b(LATENT, DIM_B))
            self.decoder_c = _DecWrap(_decoder_c(LATENT, N_SITES))

    ref = Ref().eval()
    params, state = convert_state_dict(_sd(ref), "multivae")

    with torch.no_grad():
        t_mu, t_lv = _mean_fuse([
            ref.encoder_a(torch.from_numpy(rna)),
            ref.encoder_b(torch.from_numpy(dna)),
            ref.encoder_c(torch.from_numpy(site).long()),
        ])
        t_a = ref.decoder_a(t_mu)
        t_b = ref.decoder_b(t_mu)
        t_c = ref.decoder_c(t_mu)
    out = vae.multimodal_vae_apply(
        params, state, jax.random.PRNGKey(0), a=jnp.asarray(rna),
        b=jnp.asarray(dna), site=jnp.asarray(site), train=False,
    )
    np.testing.assert_allclose(np.asarray(out.mu), t_mu.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(out.logvar), t_lv.numpy(), **TOL)
    from vae_los_angeles_tpu.models.decoders import (
        decoder_a_apply,
        decoder_b_apply,
        decoder_c_apply,
    )

    np.testing.assert_allclose(
        np.asarray(decoder_a_apply(params["decoder_a"], out.mu)),
        t_a.numpy(), **TOL)
    np.testing.assert_allclose(
        np.asarray(decoder_b_apply(params["decoder_b"], out.mu)),
        t_b.numpy(), **TOL)
    np.testing.assert_allclose(
        np.asarray(decoder_c_apply(params["decoder_c"], out.mu)),
        t_c.numpy(), **TOL)


def test_wrong_model_type_fails_loudly(data):
    torch.manual_seed(6)
    enc = _EncoderA(DIM_A, LATENT)
    with pytest.raises((KeyError, ValueError)):
        convert_state_dict(_sd(enc), "rna2dna")  # missing decoder keys
    with pytest.raises(ValueError, match="unknown model type"):
        convert_state_dict({}, "nope")


def test_cli_roundtrip(tmp_path, monkeypatch, data):
    """scripts/import_torch_checkpoint.py --write-run-id must land the .npz
    at the EXACT path the run-id protocol consumers resolve
    (<CHECKPOINT_DIR>/best_<model>_<run_id>.npz) — wherever the .pt lives —
    and register the run id, so load_best() finds the migrated model."""
    rna, _, site = data
    torch.manual_seed(7)

    class Ref(tnn.Module):
        def __init__(self):
            super().__init__()
            self.encoder_rna = _EncoderA(DIM_A, LATENT)
            self.encoder_site = _EncoderC(N_SITES, LATENT, EMBED)
            self.decoder_dna = _DecWrap(_decoder_b(LATENT, DIM_B))

    ref = Ref().eval()
    backup = tmp_path / "backup"
    backup.mkdir()
    pt = backup / "best_rna2dna_20240101_120000.pt"  # NOT in checkpoints/
    torch.save(ref.state_dict(), pt)

    monkeypatch.chdir(tmp_path)
    from scripts.import_torch_checkpoint import main as import_main

    import_main([str(pt), "--write-run-id"])

    from vae_los_angeles_tpu.training import checkpoint

    assert (tmp_path / "latest_rna2dna_run_id.txt").read_text() == \
        "20240101_120000"
    # consumer-resolved path, not the .pt's directory
    params, state = checkpoint.load(
        str(tmp_path / "checkpoints" / "best_rna2dna_20240101_120000.npz")
    )
    direct_p, direct_s = convert_state_dict(_sd(ref), "rna2dna")
    jax.tree.map(np.testing.assert_array_equal, params, direct_p)
    jax.tree.map(np.testing.assert_array_equal, state, direct_s)
    # and the loaded tree drives the framework forward
    out = directional_vae.rna2dna_vae_apply(
        params, state, jax.random.PRNGKey(0), rna=jnp.asarray(rna),
        site=jnp.asarray(site), train=False,
    )
    assert np.isfinite(np.asarray(out.recon)).all()

    # a name with no timestamp mints a fresh run id instead of erroring
    pt2 = backup / "best_rna2dna_migrated.pt"
    torch.save(ref.state_dict(), pt2)
    import_main([str(pt2), "--write-run-id"])
    rid = (tmp_path / "latest_rna2dna_run_id.txt").read_text()
    assert (tmp_path / "checkpoints" / f"best_rna2dna_{rid}.npz").exists()

    # --out conflicting with the protocol path fails BEFORE conversion
    with pytest.raises(SystemExit):
        import_main([str(pt), "--write-run-id", "--out", "elsewhere.npz"])


def test_container_state_dict_unwrap(tmp_path):
    """torch.save({'state_dict': ..., 'epoch': n}) checkpoints unwrap; a
    non-state-dict payload gets the diagnostic error, not an AttributeError."""
    torch.manual_seed(8)
    enc = _EncoderA(DIM_A, LATENT)
    pt = tmp_path / "wrapped.pt"
    torch.save({"state_dict": enc.state_dict(), "epoch": 3}, pt)
    sd = load_torch_state_dict(str(pt))
    assert "fc.0.weight" in sd

    bad = tmp_path / "bad.pt"
    torch.save({"optimizer": {"lr": 0.1}}, bad)
    with pytest.raises(ValueError, match="did not contain a state_dict"):
        load_torch_state_dict(str(bad))


def _ref_builders():
    class R2D(tnn.Module):
        def __init__(self):
            super().__init__()
            self.encoder_rna = _EncoderA(DIM_A, LATENT)
            self.encoder_site = _EncoderC(N_SITES, LATENT, EMBED)
            self.decoder_dna = _DecWrap(_decoder_b(LATENT, DIM_B))

    class D2R(tnn.Module):
        def __init__(self):
            super().__init__()
            self.encoder_dna = _EncoderB(DIM_B, LATENT)
            self.encoder_site = _EncoderC(N_SITES, LATENT, EMBED)
            self.decoder_rna = _DecWrap(_decoder_a(LATENT, DIM_A))

    class R2DAE(tnn.Module):
        def __init__(self):
            super().__init__()
            self.encoder_rna = tnn.Sequential(
                tnn.Linear(DIM_A, 128), tnn.BatchNorm1d(128), tnn.ReLU(),
                tnn.Dropout(0.1), tnn.Linear(128, LATENT))
            self.site_embedding = tnn.Embedding(N_SITES, EMBED)
            self.site_projection = tnn.Linear(EMBED, LATENT)
            self.decoder_dna = _DecWrap(_decoder_b(LATENT, DIM_B))

    class D2RAE(tnn.Module):
        def __init__(self):
            super().__init__()
            self.encoder_dna = tnn.Sequential(
                tnn.Linear(DIM_B, 512), tnn.BatchNorm1d(512), tnn.ReLU(),
                tnn.Dropout(0.1), tnn.Linear(512, 256), tnn.BatchNorm1d(256),
                tnn.ReLU(), tnn.Dropout(0.1), tnn.Linear(256, LATENT))
            self.site_embedding = tnn.Embedding(N_SITES, EMBED)
            self.site_projection = tnn.Linear(EMBED, LATENT)
            self.decoder_rna = _DecWrap(_decoder_a(LATENT, DIM_A))

    class MV(tnn.Module):
        def __init__(self):
            super().__init__()
            self.encoder_a = _EncoderA(DIM_A, LATENT)
            self.encoder_b = _EncoderB(DIM_B, LATENT)
            self.encoder_c = _EncoderC(N_SITES, LATENT, EMBED)
            self.decoder_a = _DecWrap(_decoder_a(LATENT, DIM_A))
            self.decoder_b = _DecWrap(_decoder_b(LATENT, DIM_B))
            self.decoder_c = _DecWrap(_decoder_c(LATENT, N_SITES))

    return {"rna2dna": R2D, "dna2rna": D2R, "rna2dna_ae": R2DAE,
            "dna2rna_ae": D2RAE, "multivae": MV}


@pytest.mark.parametrize("model_type", sorted(
    __import__("vae_los_angeles_tpu.utils.torch_import",
               fromlist=["MODEL_TYPES"]).MODEL_TYPES))
def test_export_roundtrip(model_type):
    """sd → convert → export must reproduce the original state_dict exactly
    (transposes undone, BN buffers restored) for every family — the spec
    consumer guarantees the two directions share one definition."""
    from vae_los_angeles_tpu.utils.torch_import import export_state_dict

    torch.manual_seed(11)
    ref = _ref_builders()[model_type]().eval()
    sd = _sd(ref)
    params, state = convert_state_dict(sd, model_type)
    back = export_state_dict(params, state, model_type)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_export_serves_in_reference(data):
    """The real use case: a model initialized (stand-in for trained) HERE is
    exported and loaded by the reference's torch assembly with strict=True;
    the torch forward must reproduce the framework forward."""
    from vae_los_angeles_tpu.utils.torch_import import export_state_dict

    rna, _, site = data
    params, state = directional_vae.rna2dna_vae_init(
        jax.random.PRNGKey(42), DIM_A, DIM_B, N_SITES, LATENT, EMBED
    )
    sd = export_state_dict(params, state, "rna2dna")
    ref = _ref_builders()["rna2dna"]()
    ref.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    ref.eval()

    with torch.no_grad():
        t_mu, t_lv = _mean_fuse([
            ref.encoder_rna(torch.from_numpy(rna)),
            ref.encoder_site(torch.from_numpy(site).long()),
        ])
    out = directional_vae.rna2dna_vae_apply(
        params, state, jax.random.PRNGKey(0), rna=jnp.asarray(rna),
        site=jnp.asarray(site), train=False,
    )
    np.testing.assert_allclose(np.asarray(out.mu), t_mu.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(out.logvar), t_lv.numpy(), **TOL)


def test_export_cli_roundtrip(tmp_path, data):
    from vae_los_angeles_tpu.training import checkpoint

    params, state = directional_vae.rna2dna_vae_init(
        jax.random.PRNGKey(7), DIM_A, DIM_B, N_SITES, LATENT, EMBED
    )
    npz = tmp_path / "best_rna2dna_20260817_000000.npz"
    checkpoint.save(str(npz), params, state)

    from scripts.export_torch_checkpoint import main as export_main

    export_main([str(npz)])
    pt = str(npz)[:-4] + ".pt"
    ref = _ref_builders()["rna2dna"]()
    ref.load_state_dict(torch.load(pt, weights_only=True))  # strict=True
