"""The hand-written CUDA kernels (``csrc/fused_vae.cu``, ``csrc/fused_train.cu``,
``csrc/fused_loss.cu``) against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips, with a
reason, where ``torch.cuda.is_available()`` is False. The file imports no
jax, since the card's machine has none, and runs there on its own
(``tests/conftest.py`` sets up jax, hence ``--noconftest``):

    python -m pytest --noconftest -o markers=cuda -p no:cacheprovider -q tests/test_torch_kernels_cuda.py

``chip_smoke.py`` runs the same comparison at the full model width. Here the
widths are small and no multiple of four, so the zero padding of every
dimension is exercised, and B = 2100 reaches the 16-row tiles. Tolerance:
atol = rtol = 1e-4 (fp32 on both sides, summed in different orders). The
training kernels use the JAX tests' tolerances (``tests/test_pallas_train.py``,
``tests/test_pallas_epoch.py``), with the encoder fc bias and the BN running
mean at 2·lr per step (their true gradient is zero; Adam turns its fp32
noise into steps of up to lr that differ between implementations)."""

import numpy as np
import pytest
import torch

from vae_los_angeles_torch import device as port_device
from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.evaluation import loading
from vae_los_angeles_torch.models import DNA2RNAVAE, RNA2DNAVAE
from vae_los_angeles_torch.ops.kernels import fused_epoch as fe
from vae_los_angeles_torch.ops.kernels import fused_loss as fl
from vae_los_angeles_torch.ops.kernels import fused_train as ft
from vae_los_angeles_torch.ops.kernels import fused_vae as fv
from vae_los_angeles_torch.training import engine
from vae_los_angeles_torch.ops.nn import reset_parameters
from vae_los_angeles_torch.training import checkpoint
from vae_los_angeles_torch.utils.weights import jax_from_state_dict

DIM_A, DIM_B, N_SITES, LATENT, EMBED = 37, 53, 5, 7, 6
CHAIN = dict(atol=1e-4, rtol=1e-4)
BATCHES = (1, 17, 40, 2100)
FAMILIES = {
    "rna2dna": (fv.FusedRNA2DNA, RNA2DNAVAE, "rna", DIM_A, DIM_B, loading.load_rna2dna),
    "dna2rna": (fv.FusedDNA2RNA, DNA2RNAVAE, "dna", DIM_B, DIM_A, loading.load_dna2rna),
}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this file runs on the card (module docstring)")
    return port_device.require_cuda()


def port_weights(model_type, seed=0):
    """(params, state) of a seeded port-initialised model with BN running
    stats moved off their defaults, so the folding is exercised."""
    model_cls = FAMILIES[model_type][1]
    g = torch.Generator().manual_seed(seed)
    model = reset_parameters(model_cls(DIM_A, DIM_B, N_SITES, LATENT, EMBED), g).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return jax_from_state_dict(model.state_dict(), model_type)


def inputs(din, n, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand((n, din), generator=g, device=dev) * 2,
            torch.randint(0, N_SITES, (n,), generator=g, device=dev),
            torch.randn((n, LATENT), generator=g, device=dev))


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_kernel_matches_plain_version_on_the_card(model_type, cuda_device):
    port_cls, din = FAMILIES[model_type][0], FAMILIES[model_type][3]
    fused = port_cls(*port_weights(model_type), cuda_device)
    for n in BATCHES:
        x, site, eps = inputs(din, n, cuda_device)
        before = port_cls.launches
        for s in (None, site):
            for e, use_noise in ((None, False), (eps, True)):
                got = fused(x, s, use_noise=use_noise, eps=e)
                want = port_cls._reference(fused.folded, x, s,
                                           fv.NOISE_EPS if e is not None else fv.NOISE_NONE, e, 0)
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, **CHAIN)
        assert port_cls.launches == before + 4


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_philox_noise_on_the_card(model_type, cuda_device):
    port_cls, din = FAMILIES[model_type][0], FAMILIES[model_type][3]
    fused = port_cls(*port_weights(model_type, seed=1), cuda_device)
    x, site, _ = inputs(din, 64, cuda_device, seed=1)
    det = fused(x, site, use_noise=False)[0]
    draws = torch.stack([fused(x, site, seed=s)[0] for s in range(8)])
    assert torch.equal(draws[0], fused(x, site, seed=0)[0])
    assert not torch.equal(draws[0], draws[1])
    assert (draws.mean(0) - det).abs().mean() < (draws[0] - det).abs().mean()
    # the noise of a row is keyed by (seed, row, latent index), not by the batch
    torch.testing.assert_close(fused(x[:5], site[:5], seed=3)[0], fused(x, site, seed=3)[0][:5],
                               **CHAIN)
    if port_cls is fv.FusedRNA2DNA:
        assert ((draws >= 0) & (draws <= 1)).all()


def test_wrapper_refuses_tensors_the_kernel_does_not_take(cuda_device):
    params, state = port_weights("rna2dna")
    on_card = fv.FusedRNA2DNA(params, state, cuda_device)
    on_cpu = fv.FusedRNA2DNA(params, state, "cpu")
    x, site, _ = inputs(DIM_A, 4, cuda_device)
    with pytest.raises(ValueError):
        on_card(x.cpu())
    with pytest.raises(ValueError):
        on_cpu(x)
    with pytest.raises(TypeError):
        on_card(x, site.int())
    with pytest.raises(TypeError):
        on_card(x.half())


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_loader_serves_through_the_kernel(model_type, cuda_device, tmp_path):
    port_cls, _, kw, din, dout, load = FAMILIES[model_type]
    params, state = port_weights(model_type, seed=2)
    cfg = Config().replace(checkpoint_dir=str(tmp_path / "checkpoints"))
    checkpoint.save_best(model_type, "20260101_000000", params, state, cfg.checkpoint_dir)
    checkpoint.write_run_id(model_type, "20260101_000000", str(tmp_path))
    served = load(cfg=cfg, root=str(tmp_path), device=cuda_device)
    plain = load(cfg=cfg, root=str(tmp_path), device="cpu")
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(33, din)).astype(np.float32)
    site = rng.integers(0, N_SITES, size=(33,))
    before = port_cls.launches
    recon, mu, logvar = served(**{kw: x}, site=site)
    assert port_cls.launches == before + 1
    assert recon.shape == (33, dout) and np.isfinite(recon).all()
    _, pmu, plv = plain(**{kw: x}, site=site)
    np.testing.assert_allclose(mu, pmu, **CHAIN)
    np.testing.assert_allclose(logvar, plv, **CHAIN)


TRAIN_DIMS = dict(din=37, dout=53, sites=5, latent=7, embed=6)
GRAD = dict(atol=5e-4, rtol=1e-4)


def train_case(dev, batch, n_batches=1, seed=0):
    """Port-initialised (params, state) at small odd widths and a batch of rows."""
    from vae_los_angeles_torch.models.directional_vae import rna2dna_vae_init

    d = TRAIN_DIMS
    params, state = rna2dna_vae_init(torch.Generator().manual_seed(seed), d["din"], d["dout"],
                                     d["sites"], d["latent"], d["embed"], dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    n = batch * n_batches
    rows = dict(x=torch.randn((n, d["din"]), generator=g, device=dev),
                t=torch.rand((n, d["dout"]), generator=g, device=dev),
                site=torch.randint(0, d["sites"], (n,), generator=g, device=dev),
                eps=torch.randn((n, d["latent"]), generator=g, device=dev),
                drop=(torch.rand((n, 128), generator=g, device=dev) < 0.9).float())
    return params, state, rows


@pytest.mark.parametrize("batch", [2, 32, 45])
def test_train_step_kernel_matches_plain_version(batch, cuda_device):
    params, state, r = train_case(cuda_device, batch)
    before = ft.launches["rna2dna_train_step"]
    loss, grads, bn = ft.rna2dna_fused_train_step(params, state, r["x"], r["t"], r["site"],
                                                  TRAIN_DIMS["sites"], beta=1e-3, eps=r["eps"],
                                                  drop_mask=r["drop"])
    assert ft.launches["rna2dna_train_step"] == before + 1
    flat = ft.flatten_params(params)
    b0 = state["encoder_rna"]["bn"]
    want = ft.rna2dna_train_step_reference(flat, b0["mean"], b0["var"], r["x"], r["t"],
                                           r["site"], r["eps"], r["drop"], 1e-3)
    torch.testing.assert_close(loss, want[0], rtol=1e-5, atol=0)
    got = ft.flatten_params(grads)
    for name, _ in ft.PARAM_ORDER:
        torch.testing.assert_close(got[name], want[1][name], **GRAD, msg=name)
    torch.testing.assert_close(bn["encoder_rna"]["bn"]["mean"], want[2], atol=1e-5, rtol=0)
    torch.testing.assert_close(bn["encoder_rna"]["bn"]["var"], want[3], atol=1e-5, rtol=0)


def test_philox_noise_of_the_train_kernel(cuda_device):
    eps, keep = ft.philox_noise(7, 3, 1024, 128, 20, cuda_device)
    assert abs(keep.mean().item() - 0.9) < 0.005
    assert abs(eps.mean().item()) < 0.03 and abs(eps.var().item() - 1) < 0.03
    again, _ = ft.philox_noise(7, 3, 1024, 128, 20, cuda_device)
    other, _ = ft.philox_noise(8, 3, 1024, 128, 20, cuda_device)
    assert torch.equal(eps, again) and not torch.equal(eps, other)
    # the Philox step equals the injected step given the draws it makes
    params, state, r = train_case(cuda_device, 16, seed=2)
    args = (params, state, r["x"], r["t"], r["site"], TRAIN_DIMS["sites"])
    a = ft.rna2dna_fused_train_step(*args, seed=5, step=1)
    eps, keep = ft.philox_noise(5, 1, 16, 128, TRAIN_DIMS["latent"], cuda_device)
    b = ft.rna2dna_fused_train_step(*args, eps=eps, drop_mask=keep)
    assert torch.equal(a[0], b[0])


def test_epoch_kernel_matches_plain_version(cuda_device):
    n_batches, batch, lr = 6, 16, 5e-4
    params, state, r = train_case(cuda_device, batch, n_batches, seed=3)
    zeros = {k: torch.zeros_like(v) for k, v in ft.flatten_params(params).items()}
    zt = ft.unflatten(zeros)
    before = fe.launches["rna2dna_train_epoch"]
    got = fe.rna2dna_fused_epoch(params, zt, zt, state, r["x"], r["t"], r["site"],
                                 TRAIN_DIMS["sites"], lr=lr, step0=2, n_batches=n_batches,
                                 eps_ep=r["eps"], drop_ep=r["drop"])
    assert fe.launches["rna2dna_train_epoch"] == before + 1
    b0 = state["encoder_rna"]["bn"]
    want = fe.rna2dna_epoch_reference(ft.flatten_params(params), zeros, zeros, b0["mean"],
                                      b0["var"], r["x"], r["t"], r["site"], r["eps"], r["drop"],
                                      seed=0, beta=1e-3, lr=lr, weight_decay=1e-5, step0=2,
                                      n_batches=n_batches)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    loose = 2 * lr * n_batches
    for tree, ref in ((got[1], want[1]), (got[2], want[2])):
        flat = ft.flatten_params(tree)
        for name, _ in ft.PARAM_ORDER:
            atol = loose if name == "b1" else 2e-5
            torch.testing.assert_close(flat[name], ref[name], atol=atol, rtol=0, msg=name)
    bn = got[4]["encoder_rna"]["bn"]
    torch.testing.assert_close(bn["mean"], want[4], atol=loose, rtol=0)
    torch.testing.assert_close(bn["var"], want[5], atol=2e-4, rtol=0)


@pytest.mark.parametrize("batch", [3, 205])
def test_loss_kernels_match_plain_versions(batch, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(batch)
    logits = (torch.randn((batch, 53), generator=g, device=cuda_device) * 3).requires_grad_(True)
    t = torch.rand((batch, 53), generator=g, device=cuda_device)
    mu = torch.randn((batch, 7), generator=g, device=cuda_device).requires_grad_(True)
    lv = (torch.randn((batch, 7), generator=g, device=cuda_device) * 0.5).requires_grad_(True)
    beta = torch.tensor(2e-3, device=cuda_device, requires_grad=True)
    before = dict(fl.launches)
    val = fl.rna2dna_loss_fused(logits, t, mu, lv, beta)
    grads = torch.autograd.grad(val * 1.3, (logits, mu, lv, beta))
    assert fl.launches["rna2dna_loss_forward"] == before["rna2dna_loss_forward"] + 1
    assert fl.launches["rna2dna_loss_backward"] == before["rna2dna_loss_backward"] + 1
    with torch.no_grad():
        want, kld = fl.loss_forward_reference(logits, t, mu, lv, beta)
        g13 = torch.tensor(1.3, device=cuda_device)
        want_g = (*fl.loss_backward_reference(logits, t, mu, lv, beta, g13), kld * g13)
    torch.testing.assert_close(val, want, rtol=1e-5, atol=0)
    for a, b in zip(grads, want_g):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("path", ["plain", "fused_step", "fused_epoch"])
def test_fit_paths_launch_their_kernels(path, cuda_device):
    d = TRAIN_DIMS
    cfg = Config(input_dim_a=d["din"], input_dim_b=d["dout"], latent_dim=d["latent"],
                 embed_dim=d["embed"], batch_size=16)
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(96, d["din"])).astype(np.float32),
            rng.uniform(size=(96, d["dout"])).astype(np.float32),
            rng.integers(0, d["sites"], size=96))
    val = tuple(a[:40] for a in data)
    counts = (ft.launches, fe.launches, fl.launches)
    before = [dict(c) for c in counts]
    res = engine.fit("rna2dna", cfg, data, val, 0, d["sites"], num_epochs=2, device=cuda_device,
                     **({} if path == "plain" else {path: True}))
    delta = {k: c[k] - b[k] for c, b in zip(counts, before) for k in c}
    assert res.epochs_ran == 2 and np.isfinite(res.val_losses).all()
    assert delta["rna2dna_loss_forward"] >= 2  # the validation loss, every epoch
    assert delta["rna2dna_train_epoch"] == (2 if path == "fused_epoch" else 0)
    assert delta["rna2dna_train_step"] == (12 if path == "fused_step" else 0)
    assert delta["rna2dna_loss_backward"] == (12 if path == "plain" else 0)
