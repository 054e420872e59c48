"""The hand-written CUDA kernels (``csrc/fused_vae.cu``, ``csrc/fused_train.cu``,
``csrc/fused_loss.cu``, ``csrc/fused_wide.cu``) against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips, with a
reason, where ``torch.cuda.is_available()`` is False. The file imports no
jax, since the card's machine has none, and runs there on its own
(``tests/conftest.py`` sets up jax, hence ``--noconftest``):

    python -m pytest --noconftest -o markers=cuda -p no:cacheprovider -q tests/test_torch_kernels_cuda.py

``chip_smoke.py`` runs the same comparison at the full model width. Here the
widths are small and no multiple of four, so the zero padding of every
dimension is exercised, and B = 1600 and 2100 reach the 32-row trunk tiles;
the serving kernels are also held at a DNA input of 6,623 and a DecoderB
output of 8,191, each through the cluster trunk and through its sweep. Tolerance:
atol = rtol = 1e-4 (fp32 on both sides, summed in different orders). The
training kernels use the JAX tests' tolerances (``tests/test_pallas_train.py``,
``tests/test_pallas_epoch.py``; the DNA→RNA gradients atol 1e-3 + rtol 1e-4,
its epoch's params and m atol 5e-5; the tri-modal gradients atol 1e-3 +
rtol 1e-4, 2e-3 for the encoder fc biases), with the encoder fc biases and
the BN running means at 2·lr per step in the epochs (their true gradient is
zero; Adam turns its fp32 noise into steps of up to lr that differ between
implementations). The wide head over three chained steps, as
``chip_smoke.compare_wide`` holds it at 512 x 450,000: W and b atol 0.02·lr,
the moments and dh within 2e-5 of each tensor's largest magnitude, the loss
rtol 1e-5."""

import functools

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
from vae_los_angeles_torch.ops.kernels import fused_wide as fw
from vae_los_angeles_torch.training import engine
from vae_los_angeles_torch.ops.nn import reset_parameters
from vae_los_angeles_torch.training import checkpoint
from vae_los_angeles_torch.utils.tree import tree_map
from vae_los_angeles_torch.utils.weights import jax_from_state_dict

DIM_A, DIM_B, N_SITES, LATENT, EMBED = 37, 53, 5, 7, 6
CHAIN = dict(atol=1e-4, rtol=1e-4)
BATCHES = (1, 17, 40, 1600, 2100)
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


def port_weights(model_type, seed=0, dim_b=DIM_B):
    """(params, state) of a seeded port-initialised model with DNA width
    ``dim_b`` and BN running stats moved off their defaults, so the folding
    is exercised."""
    model_cls = FAMILIES[model_type][1]
    g = torch.Generator().manual_seed(seed)
    model = reset_parameters(model_cls(DIM_A, dim_b, N_SITES, LATENT, EMBED), g).eval()
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


# (model, DNA width, route): the wide layer in the cluster trunk or in its sweep
WIDE_CASES = [("dna2rna", 6623, "trunk"), ("dna2rna", 6623, "sweep"),
              ("rna2dna", 8191, "trunk"), ("rna2dna", 8191, "sweep")]


@pytest.mark.parametrize("model_type,dim_b,route", WIDE_CASES)
def test_kernel_matches_plain_version_at_a_wide_dna_width(model_type, dim_b, route, cuda_device,
                                                          monkeypatch):
    port_cls = FAMILIES[model_type][0]
    fused = port_cls(*port_weights(model_type, seed=3, dim_b=dim_b), cuda_device)
    swept = "SWEEP_MIN_IN" if model_type == "dna2rna" else "SWEEP_MIN_OUT"
    monkeypatch.setattr(fv, "SWEEP_MIN_IN", 1 << 30)
    monkeypatch.setattr(fv, "SWEEP_MIN_OUT", 1 << 30)
    if route == "sweep":
        monkeypatch.setattr(fv, swept, dim_b)
    for n in (3, 37, 205):
        x, site, eps = inputs(fused.in_dim, n, cuda_device, seed=n)
        assert fused.plan(n).plan.kernels == (2 if route == "sweep" else 1)
        for s in (None, site):
            for e, use_noise in ((None, False), (eps, True)):
                got = fused(x, s, use_noise=use_noise, eps=e)
                want = port_cls._reference(fused.folded, x, s,
                                           fv.NOISE_EPS if e is not None else fv.NOISE_NONE, e, 0)
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, **CHAIN)


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_philox_draws_equal_the_plain_emulation(model_type, cuda_device):
    """The kernel's Philox4x32-10 draw at (seed, global row, j) is the
    emulation's bit for bit: the Philox call equals the injected call."""
    port_cls, din = FAMILIES[model_type][0], FAMILIES[model_type][3]
    fused = port_cls(*port_weights(model_type, seed=4), cuda_device)
    for n in (1, 40, 2100):
        x, site, _ = inputs(din, n, cuda_device, seed=n + 1)
        for seed in (0, 11, 2**40 + 7):
            drawn = fused(x, site, seed=seed)
            injected = fused(x, site, eps=fv.philox_normal_reference(seed, n, LATENT, cuda_device))
            for a, b in zip(drawn, injected):
                assert torch.equal(a, b)


def test_loader_serves_a_wide_dna2rna_checkpoint_in_one_call(cuda_device, tmp_path):
    """A DNA→RNA checkpoint 6,623 probes wide, served through its loader
    with USE_PALLAS in one call of the C entry, within tolerance of the plain
    route."""
    params, state = port_weights("dna2rna", seed=5, dim_b=6623)
    cfg = Config().replace(checkpoint_dir=str(tmp_path / "checkpoints"), use_pallas=True)
    checkpoint.save_best("dna2rna", "20260101_000000", params, state, cfg.checkpoint_dir)
    checkpoint.write_run_id("dna2rna", "20260101_000000", str(tmp_path))
    served = loading.load_dna2rna(cfg=cfg, root=str(tmp_path), device=cuda_device)
    plain = loading.load_dna2rna(cfg=cfg.replace(use_pallas=False), root=str(tmp_path),
                                 device=cuda_device)
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(70, 6623)).astype(np.float32)
    site = rng.integers(0, N_SITES, size=(70,))
    before = fv.FusedDNA2RNA.launches
    recon, mu, logvar = served(dna=x, site=site)
    assert fv.FusedDNA2RNA.launches == before + 1
    assert recon.shape == (70, DIM_A) and np.isfinite(recon).all()
    _, pmu, plv = plain(dna=x, site=site)
    np.testing.assert_allclose(mu, pmu, **CHAIN)
    np.testing.assert_allclose(logvar, plv, **CHAIN)
    fused = fv.FusedDNA2RNA(params, state, cuda_device)
    xt, st = torch.as_tensor(x).to(cuda_device), torch.as_tensor(site).to(cuda_device)
    got = fused(xt, st, use_noise=False)
    want = fv.dna2rna_fused_reference(fused.folded, xt, st)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **CHAIN)


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_the_batches_of_a_bucket_share_one_plan_on_the_card(model_type, cuda_device):
    """Batches of 129, 200 and 256 rows run on the 256-row bucket's plan,
    each launching the clusters its own rows need, within tolerance of the
    plain version."""
    port_cls, din = FAMILIES[model_type][0], FAMILIES[model_type][3]
    fused = port_cls(*port_weights(model_type, seed=6), cuda_device)
    for n in (129, 200, 256):
        x, site, eps = inputs(din, n, cuda_device, seed=n)
        got = fused(x, site, eps=eps)
        want = port_cls._reference(fused.folded, x, site, fv.NOISE_EPS, eps, 0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **CHAIN)
    assert list(fused._calls) == [256]


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
    cfg = Config().replace(checkpoint_dir=str(tmp_path / "checkpoints"), use_pallas=True)
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


def loss_inputs(dev, batch, width, offsets=(0, 0), seed=0):
    """Loss inputs with logits and target starting ``offsets`` floats past a
    16-byte boundary (contiguous views ``buf[off:]`` of fresh buffers)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = batch * width
    logits = (torch.randn(n + 4, generator=g, device=dev) * 3)[offsets[0]:offsets[0] + n]
    t = torch.rand(n + 4, generator=g, device=dev)[offsets[1]:offsets[1] + n]
    for x, off in zip((logits, t), offsets):
        assert x.data_ptr() % 16 == 4 * off
    mu = torch.randn((batch, 7), generator=g, device=dev)
    lv = torch.randn((batch, 7), generator=g, device=dev) * 0.5
    return logits.view(batch, width), t.view(batch, width), mu, lv


# (batch, width, offsets of logits and target from a 16-byte boundary)
LOSS_CASES = [
    pytest.param(3, 53, (0, 0), id="3"),
    pytest.param(205, 53, (0, 0), id="205"),
    pytest.param(7, 53, (1, 1), id="7x53-misaligned"),  # n = 371: a head of 3, a tail of 2
    pytest.param(7, 53, (1, 0), id="7x53-offsets-differ"),  # the scalar route
    # n = 6,700,201 > one pass of the persistent grid (SMs x blocks x 256 threads x 4 float4s)
    pytest.param(67, 100_003, (3, 3), id="67x100003-misaligned"),
]


@pytest.mark.parametrize("batch, width, offsets", LOSS_CASES)
def test_loss_kernels_match_plain_versions(batch, width, offsets, cuda_device):
    logits, t, mu, lv = loss_inputs(cuda_device, batch, width, offsets, seed=batch)
    for x in (logits, mu, lv):
        x.requires_grad_(True)
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


def test_loss_pair_takes_an_empty_batch(cuda_device):
    """A data-parallel rank's share of a batch smaller than the rank count
    has no rows: the loss is 0 and its gradients empty, with no launch."""
    logits = torch.zeros(0, 53, device=cuda_device, requires_grad=True)
    mu = torch.zeros(0, LATENT, device=cuda_device, requires_grad=True)
    lv = torch.zeros(0, LATENT, device=cuda_device, requires_grad=True)
    before = dict(fl.launches)
    val = fl.rna2dna_loss_fused(logits, torch.zeros(0, 53, device=cuda_device), mu, lv,
                                torch.tensor(2e-3, device=cuda_device))
    grads = torch.autograd.grad(val, (logits, mu, lv))
    assert float(val) == 0.0 and [g.shape for g in grads] == [(0, 53), (0, LATENT), (0, LATENT)]
    assert fl.launches == before


def test_loss_forward_gives_the_same_bits_every_call(cuda_device):
    logits, t, mu, lv = loss_inputs(cuda_device, 67, 100_003, (1, 1), seed=4)
    beta = torch.tensor(2e-3, device=cuda_device)
    want, want_kld = fl.loss_forward_reference(logits, t, mu, lv, beta)
    calls = [torch.stack(fl._forward(logits, t, mu, lv, beta)) for _ in range(3)]
    for got in calls:
        assert torch.equal(got, calls[0])
    torch.testing.assert_close(calls[0][0], want, rtol=1e-5, atol=0)
    torch.testing.assert_close(calls[0][1], want_kld, rtol=1e-5, atol=0)


def test_loss_forward_on_two_streams(cuda_device):
    """Each stream has its own workspace and ticket; calls alternate
    between two streams, each finishing before the next starts."""
    logits, t, mu, lv = loss_inputs(cuda_device, 41, 2_441, (2, 2), seed=5)
    beta = torch.tensor(2e-3, device=cuda_device)
    want, want_kld = fl.loss_forward_reference(logits, t, mu, lv, beta)
    streams = [torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device)]
    for s in streams * 2:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(s):
            loss, kld = fl._forward(logits, t, mu, lv, beta)
        s.synchronize()
        torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
        torch.testing.assert_close(kld, want_kld, rtol=1e-5, atol=0)
    for s in streams:
        assert (cuda_device.index, s.cuda_stream) in fl._workspaces


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


def test_plain_fit_launches_the_loss_pair_every_step(cuda_device, monkeypatch):
    """The plain path: the forward and the backward once a training step, the
    forward once more for each epoch's validation loss; every call's result
    held against the plain version on its own inputs. 15 x 53 and 41 x 53 are
    no multiples of 4 (tails of 3 and 1)."""
    calls = {"forward": [], "backward": []}
    for name in calls:
        kernel = getattr(fl, "_" + name)

        def spy(*args, kernel=kernel, name=name):
            out = kernel(*args)
            calls[name].append((args, out))
            return out

        monkeypatch.setattr(fl, "_" + name, spy)
    d = TRAIN_DIMS
    cfg = Config(input_dim_a=d["din"], input_dim_b=d["dout"], latent_dim=d["latent"],
                 embed_dim=d["embed"], batch_size=15)
    rng = np.random.default_rng(1)
    data = (rng.normal(size=(137, d["din"])).astype(np.float32),
            rng.uniform(size=(137, d["dout"])).astype(np.float32),
            rng.integers(0, d["sites"], size=137))
    before = dict(fl.launches)
    res = engine.fit("rna2dna", cfg, tuple(a[:96] for a in data), tuple(a[96:] for a in data), 0,
                     d["sites"], num_epochs=2, device=cuda_device)
    steps = 96 // 15
    assert res.epochs_ran == 2 and np.isfinite(res.val_losses).all()
    assert fl.launches["rna2dna_loss_forward"] - before["rna2dna_loss_forward"] == 2 * (steps + 1)
    assert fl.launches["rna2dna_loss_backward"] - before["rna2dna_loss_backward"] == 2 * steps
    assert [a[0].shape[0] for a, _ in calls["forward"]] == ([15] * steps + [41]) * 2
    with torch.no_grad():
        for args, (loss, kld) in calls["forward"]:
            want, want_kld = fl.loss_forward_reference(*args)
            torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
            torch.testing.assert_close(kld, want_kld, rtol=1e-5, atol=1e-7)
        for args, got in calls["backward"]:
            for a, b in zip(got, fl.loss_backward_reference(*args)):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# ---- DNA→RNA: the input is DNA (TRAIN_DIMS["din"] wide), the target RNA ----
GRAD_D2R = dict(atol=1e-3, rtol=1e-4)


def d2r_case(dev, batch, n_batches=1, seed=0):
    """Port-initialised DNA2RNAVAE (params, state) at small odd widths (the
    encoder's 512 and 256 are fixed) and rows: x the DNA input, t the RNA
    target, with injected noise."""
    from vae_los_angeles_torch.models.directional_vae import dna2rna_vae_init

    d = TRAIN_DIMS
    params, state = dna2rna_vae_init(torch.Generator().manual_seed(seed), d["dout"], d["din"],
                                     d["sites"], d["latent"], d["embed"], dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    n = batch * n_batches
    rows = dict(x=torch.rand((n, d["din"]), generator=g, device=dev),
                t=torch.randn((n, d["dout"]), generator=g, device=dev),
                site=torch.randint(0, d["sites"], (n,), generator=g, device=dev),
                eps=torch.randn((n, d["latent"]), generator=g, device=dev),
                drop1=(torch.rand((n, 512), generator=g, device=dev) < 0.9).float(),
                drop2=(torch.rand((n, 256), generator=g, device=dev) < 0.9).float())
    return params, state, rows


# B = 2 is degenerate here: with two rows both BatchNorms' backward is zero in
# theory, so every gradient before the second BN is fp32 noise
@pytest.mark.parametrize("batch", [7, 32, 45])
def test_d2r_train_step_kernel_matches_plain_version(batch, cuda_device):
    params, state, r = d2r_case(cuda_device, batch)
    before = ft.launches["dna2rna_train_step"]
    loss, grads, bn = ft.dna2rna_fused_train_step(
        params, state, r["t"], r["x"], r["site"], TRAIN_DIMS["sites"], beta=1e-3, eps=r["eps"],
        drop_mask1=r["drop1"], drop_mask2=r["drop2"])
    assert ft.launches["dna2rna_train_step"] == before + 1
    flat = ft.flatten_params(params, ft.PARAM_ORDER_D2R)
    want = ft.dna2rna_train_step_reference(flat, ft.bn_d2r(state), r["x"], r["t"], r["site"],
                                           r["eps"], r["drop1"], r["drop2"], 1e-3)
    torch.testing.assert_close(loss, want[0], rtol=1e-5, atol=0)
    got = ft.flatten_params(grads, ft.PARAM_ORDER_D2R)
    for name, _ in ft.PARAM_ORDER_D2R:
        torch.testing.assert_close(got[name], want[1][name], **GRAD_D2R, msg=name)
    for a, b in zip(ft.bn_d2r(bn), want[2]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_philox_noise_of_the_d2r_train_kernel(cuda_device):
    eps, keep1, keep2 = ft.philox_noise_d2r(7, 3, 1024, 512, 256, 20, cuda_device)
    for keep in (keep1, keep2):
        assert abs(keep.mean().item() - 0.9) < 0.005
    assert not torch.equal(keep1[:, :256], keep2)  # a stream for each dropout layer
    assert abs(eps.mean().item()) < 0.03 and abs(eps.var().item() - 1) < 0.03
    again = ft.philox_noise_d2r(7, 3, 1024, 512, 256, 20, cuda_device)
    other = ft.philox_noise_d2r(8, 3, 1024, 512, 256, 20, cuda_device)
    assert all(torch.equal(a, b) for a, b in zip((eps, keep1, keep2), again))
    assert not any(torch.equal(a, b) for a, b in zip((eps, keep1, keep2), other))
    # the Philox step equals the injected step given the draws it makes
    params, state, r = d2r_case(cuda_device, 16, seed=2)
    args = (params, state, r["t"], r["x"], r["site"], TRAIN_DIMS["sites"])
    a = ft.dna2rna_fused_train_step(*args, seed=5, step=1)
    eps, keep1, keep2 = ft.philox_noise_d2r(5, 1, 16, 512, 256, TRAIN_DIMS["latent"],
                                            cuda_device)
    b = ft.dna2rna_fused_train_step(*args, eps=eps, drop_mask1=keep1, drop_mask2=keep2)
    assert torch.equal(a[0], b[0])


def test_d2r_epoch_kernel_matches_plain_version(cuda_device):
    n_batches, batch, lr = 6, 16, 5e-4
    params, state, r = d2r_case(cuda_device, batch, n_batches, seed=3)
    order = ft.PARAM_ORDER_D2R
    zeros = {k: torch.zeros_like(v) for k, v in ft.flatten_params(params, order).items()}
    zt = ft.unflatten(zeros, order)
    before = fe.launches["dna2rna_train_epoch"]
    got = fe.dna2rna_fused_epoch(params, zt, zt, state, r["x"], r["t"], r["site"],
                                 TRAIN_DIMS["sites"], lr=lr, step0=2, n_batches=n_batches,
                                 eps_ep=r["eps"], drop1_ep=r["drop1"], drop2_ep=r["drop2"])
    assert fe.launches["dna2rna_train_epoch"] == before + 1
    want = fe.dna2rna_epoch_reference(ft.flatten_params(params, order), zeros, zeros,
                                      ft.bn_d2r(state), r["x"], r["t"], r["site"], r["eps"],
                                      r["drop1"], r["drop2"], seed=0, beta=1e-3, lr=lr,
                                      weight_decay=1e-5, step0=2, n_batches=n_batches)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    loose = 2 * lr * n_batches
    for tree, ref in ((got[1], want[1]), (got[2], want[2])):
        flat = ft.flatten_params(tree, order)
        for name, _ in order:
            atol = loose if name in ("b1", "b2") else 5e-5
            torch.testing.assert_close(flat[name], ref[name], atol=atol, rtol=0, msg=name)
    for i, (a, b) in enumerate(zip(ft.bn_d2r(got[4]), want[4])):
        torch.testing.assert_close(a, b, atol=loose if i % 2 == 0 else 2e-4, rtol=0)


@pytest.mark.parametrize("path", ["plain", "fused_step", "fused_epoch"])
def test_d2r_fit_paths_launch_their_kernels(path, cuda_device):
    d = TRAIN_DIMS
    cfg = Config(input_dim_a=d["dout"], input_dim_b=d["din"], latent_dim=d["latent"],
                 embed_dim=d["embed"], batch_size=16)
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(96, d["dout"])).astype(np.float32),
            rng.uniform(size=(96, d["din"])).astype(np.float32),
            rng.integers(0, d["sites"], size=96))
    val = tuple(a[:40] for a in data)
    counts = (ft.launches, fe.launches, fl.launches)
    before = [dict(c) for c in counts]
    res = engine.fit("dna2rna", cfg, data, val, 0, d["sites"], num_epochs=2, device=cuda_device,
                     **({} if path == "plain" else {path: True}))
    delta = {k: c[k] - b[k] for c, b in zip(counts, before) for k in c}
    assert res.epochs_ran == 2 and np.isfinite(res.val_losses).all()
    assert delta["dna2rna_train_epoch"] == (2 if path == "fused_epoch" else 0)
    assert delta["dna2rna_train_step"] == (12 if path == "fused_step" else 0)
    assert not any(v for k, v in delta.items() if k.startswith("rna2dna"))


# ---- MultiModalVAE: a the RNA rows (TRAIN_DIMS["din"] wide), b the DNA rows ----
MM_ZERO_GRAD = ("a_b1", "b_b1", "b_b2")  # the encoder fc biases feeding train-mode BatchNorm


def mm_case(dev, batch, n_batches=1, seed=0):
    """Port-initialised MultiModalVAE (params, state) at small odd widths (the
    hidden widths are fixed), rows with injected noise, and class weights."""
    from vae_los_angeles_torch.models.vae import multimodal_vae_init

    d = TRAIN_DIMS
    params, state = multimodal_vae_init(torch.Generator().manual_seed(seed), d["din"], d["dout"],
                                        d["sites"], d["latent"], d["embed"], dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    n = batch * n_batches
    rows = dict(a=torch.randn((n, d["din"]), generator=g, device=dev),
                b=torch.rand((n, d["dout"]), generator=g, device=dev),
                site=torch.randint(0, d["sites"], (n,), generator=g, device=dev),
                eps=torch.randn((n, d["latent"]), generator=g, device=dev),
                drop_a=(torch.rand((n, 128), generator=g, device=dev) < 0.9).float(),
                drop_b1=(torch.rand((n, 512), generator=g, device=dev) < 0.9).float(),
                drop_b2=(torch.rand((n, 256), generator=g, device=dev) < 0.9).float())
    cw = torch.rand(d["sites"], generator=g, device=dev) * 1.5 + 0.5
    return params, state, rows, cw


MM_NOISE = ("eps", "drop_a", "drop_b1", "drop_b2")


@pytest.mark.parametrize("batch", [7, 32])
def test_mm_train_step_kernel_matches_plain_version(batch, cuda_device):
    params, state, r, cw = mm_case(cuda_device, batch)
    before = ft.launches["multimodal_train_step"]
    loss, grads, bn = ft.multimodal_fused_train_step(
        params, state, r["a"], r["b"], r["site"], TRAIN_DIMS["sites"], beta=1e-3, gamma=1.7,
        class_weights=cw, **{k: r[k] for k in MM_NOISE})
    assert ft.launches["multimodal_train_step"] == before + 1
    flat = ft.flatten_params(params, ft.PARAM_ORDER_MM)
    want = ft.multimodal_train_step_reference(flat, ft.bn_mm(state), r["a"], r["b"], r["site"],
                                              cw, *(r[k] for k in MM_NOISE), 1e-3, 1.7)
    torch.testing.assert_close(loss, want[0], rtol=1e-5, atol=0)
    got = ft.flatten_params(grads, ft.PARAM_ORDER_MM)
    for name, _ in ft.PARAM_ORDER_MM:
        atol = 2e-3 if name in MM_ZERO_GRAD else 1e-3
        torch.testing.assert_close(got[name], want[1][name], atol=atol, rtol=1e-4, msg=name)
    for a, b in zip(ft.bn_mm(bn), want[2]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_philox_noise_of_the_mm_train_kernel(cuda_device):
    eps, keep_a, keep_b1, keep_b2 = ft.philox_noise_mm(7, 3, 1024, 128, 512, 256, 20,
                                                       cuda_device)
    for keep in (keep_a, keep_b1, keep_b2):
        assert abs(keep.mean().item() - 0.9) < 0.005
    # a stream for each dropout layer
    assert not torch.equal(keep_a, keep_b1[:, :128]) and not torch.equal(keep_b1[:, :256], keep_b2)
    assert not torch.equal(keep_a, keep_b2[:, :128])
    assert abs(eps.mean().item()) < 0.03 and abs(eps.var().item() - 1) < 0.03
    again = ft.philox_noise_mm(7, 3, 1024, 128, 512, 256, 20, cuda_device)
    other = ft.philox_noise_mm(8, 3, 1024, 128, 512, 256, 20, cuda_device)
    assert all(torch.equal(a, b) for a, b in zip((eps, keep_a, keep_b1, keep_b2), again))
    assert not any(torch.equal(a, b) for a, b in zip((eps, keep_a, keep_b1, keep_b2), other))
    # the Philox step equals the injected step given the draws it makes
    params, state, r, cw = mm_case(cuda_device, 16, seed=2)
    args = (params, state, r["a"], r["b"], r["site"], TRAIN_DIMS["sites"])
    a = ft.multimodal_fused_train_step(*args, seed=5, step=1, class_weights=cw)
    noise = ft.philox_noise_mm(5, 1, 16, 128, 512, 256, TRAIN_DIMS["latent"], cuda_device)
    b = ft.multimodal_fused_train_step(*args, class_weights=cw, **dict(zip(MM_NOISE, noise)))
    assert torch.equal(a[0], b[0])


def test_mm_epoch_kernel_matches_plain_version(cuda_device):
    n_batches, batch, lr = 4, 16, 5e-4
    params, state, r, cw = mm_case(cuda_device, batch, n_batches, seed=3)
    order = ft.PARAM_ORDER_MM
    zeros = {k: torch.zeros_like(v) for k, v in ft.flatten_params(params, order).items()}
    zt = ft.unflatten(zeros, order)
    noise = {f"{k.replace('drop_', 'drop')}_ep": r[k] for k in MM_NOISE}
    before = fe.launches["multimodal_train_epoch"]
    got = fe.multimodal_fused_epoch(params, zt, zt, state, r["a"], r["b"], r["site"],
                                    TRAIN_DIMS["sites"], gamma=1.7, class_weights=cw, lr=lr,
                                    step0=2, n_batches=n_batches, **noise)
    assert fe.launches["multimodal_train_epoch"] == before + 1
    want = fe.multimodal_epoch_reference(ft.flatten_params(params, order), zeros, zeros,
                                         ft.bn_mm(state), r["a"], r["b"], r["site"], cw,
                                         tuple(r[k] for k in MM_NOISE), seed=0, beta=1e-3,
                                         gamma=1.7, lr=lr, weight_decay=1e-5, step0=2,
                                         n_batches=n_batches)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    loose = 2 * lr * n_batches
    for tree, ref in ((got[1], want[1]), (got[2], want[2])):
        flat = ft.flatten_params(tree, order)
        for name, _ in order:
            atol = loose if name in MM_ZERO_GRAD else 5e-5
            torch.testing.assert_close(flat[name], ref[name], atol=atol, rtol=0, msg=name)
    for i, (a, b) in enumerate(zip(ft.bn_mm(got[4]), want[4])):
        torch.testing.assert_close(a, b, atol=loose if i % 2 == 0 else 2e-4, rtol=0)


def check_mm_epoch(got, want, lr, n_batches):
    """An epoch's losses (rtol 1e-5), params (atol 5e-5), m (5e-5 of each
    tensor's largest |m|, or 1) and BN stats (var 2e-4) against another's;
    the fc biases feeding BN and the BN means at 2·lr per step."""
    order, loose = ft.PARAM_ORDER_MM, 2 * lr * n_batches
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    for i, tree in ((1, "params"), (2, "m")):
        flat = ft.flatten_params(got[i], order)
        for name, _ in order:
            ref = want[i][name]
            scale = max(ref.abs().max().item(), 1.0) if tree == "m" else 1.0
            atol = loose if name in MM_ZERO_GRAD else 5e-5 * scale
            torch.testing.assert_close(flat[name], ref, atol=atol, rtol=0, msg=f"{tree} {name}")
    for i, (a, b) in enumerate(zip(ft.bn_mm(got[4]), want[4])):
        torch.testing.assert_close(a, b, atol=loose if i % 2 == 0 else 2e-4, rtol=0)


def test_mm_epoch_graph_replays_new_scalars_rows_and_seeds(cuda_device):
    """Two epochs through one cached graph, each with another β, γ, lr,
    step0 and rows, both held against the plain version; then Philox noise,
    a new key that captures the graph anew, for two seeds through one graph,
    each epoch equal to the injected epoch given the draws the kernel
    makes."""
    n_batches, batch, sites = 2, 16, TRAIN_DIMS["sites"]
    params, state, r, cw = mm_case(cuda_device, batch, n_batches, seed=3)
    order = ft.PARAM_ORDER_MM
    flat = ft.flatten_params(params, order)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    m0 = {k: torch.randn(t.shape, generator=g, device=cuda_device) * 1e-3 for k, t in flat.items()}
    v0 = {k: torch.rand(t.shape, generator=g, device=cuda_device) * 1e-6 for k, t in flat.items()}
    start = (params, ft.unflatten(m0, order), ft.unflatten(v0, order), state)
    cur, graph = start, None
    for beta, gamma, lr, step0, perm_seed in ((1e-3, 1.7, 5e-4, 7, 0), (4e-4, 0.6, 2e-4, 31, 1)):
        perm = torch.randperm(batch * n_batches, generator=torch.Generator().manual_seed(perm_seed))
        rows = {k: t[perm.to(cuda_device)] for k, t in r.items()}
        noise = {f"{k.replace('drop_', 'drop')}_ep": rows[k] for k in MM_NOISE}
        got = fe.multimodal_fused_epoch(*cur, rows["a"], rows["b"], rows["site"], sites,
                                        beta=beta, gamma=gamma, class_weights=cw, lr=lr,
                                        step0=step0, n_batches=n_batches, **noise)
        graph = graph or fe.graphs["multimodal"][1]
        assert fe.graphs["multimodal"][1] is graph
        assert graph.launches_per_step <= 26
        want = fe.multimodal_epoch_reference(
            *(ft.flatten_params(t, order) for t in cur[:3]), ft.bn_mm(cur[3]), rows["a"],
            rows["b"], rows["site"], cw, tuple(rows[k] for k in MM_NOISE), seed=0, beta=beta,
            gamma=gamma, lr=lr, weight_decay=1e-5, step0=step0, n_batches=n_batches)
        check_mm_epoch(got, want, lr, n_batches)
        cur = got[1:]
    rows = (r["a"], r["b"], r["site"], sites)
    philox = [fe.multimodal_fused_epoch(*start, *rows, seed=s, class_weights=cw, step0=3,
                                        n_batches=n_batches) for s in (11, 12)]
    assert fe.graphs["multimodal"][1] is not graph
    for s, got in zip((11, 12), philox):
        draws = [ft.philox_noise_mm(s, i, batch, 128, 512, 256, TRAIN_DIMS["latent"],
                                    cuda_device) for i in range(n_batches)]
        noise = {name: torch.cat([d[j] for d in draws])
                 for j, name in enumerate(("eps_ep", "dropa_ep", "dropb1_ep", "dropb2_ep"))}
        inj = fe.multimodal_fused_epoch(*start, *rows, class_weights=cw, step0=3,
                                        n_batches=n_batches, **noise)
        assert torch.equal(got[0], inj[0])
        for a, b in zip(ft.flatten_params(got[1], order).values(),
                        ft.flatten_params(inj[1], order).values()):
            assert torch.equal(a, b)
    assert not torch.equal(philox[0][0], philox[1][0])


@pytest.mark.parametrize("path", ["plain", "fused_step", "fused_epoch"])
def test_mm_fit_paths_launch_their_kernels(path, cuda_device):
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
    res = engine.fit("multimodal", cfg, data, val, 0, d["sites"], num_epochs=2,
                     device=cuda_device, class_weights=np.linspace(0.5, 2.0, d["sites"]),
                     **({} if path == "plain" else {path: True}))
    delta = {k: c[k] - b[k] for c, b in zip(counts, before) for k in c}
    assert res.epochs_ran == 2 and np.isfinite(res.val_losses).all()
    assert delta["multimodal_train_epoch"] == (2 if path == "fused_epoch" else 0)
    assert delta["multimodal_train_step"] == (12 if path == "fused_step" else 0)
    assert not any(v for k, v in delta.items() if not k.startswith("multimodal"))


# ---- the directional epochs as captured graphs (B2, B5), one cached a task ----
def train_case_at(dev, batch, n_batches, seed, dna):
    """`train_case` with the DNA output ``dna`` wide."""
    from vae_los_angeles_torch.models.directional_vae import rna2dna_vae_init

    d = TRAIN_DIMS
    params, state = rna2dna_vae_init(torch.Generator().manual_seed(seed), d["din"], dna,
                                     d["sites"], d["latent"], d["embed"], dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    n = batch * n_batches
    rows = dict(x=torch.randn((n, d["din"]), generator=g, device=dev),
                t=torch.rand((n, dna), generator=g, device=dev),
                site=torch.randint(0, d["sites"], (n,), generator=g, device=dev),
                eps=torch.randn((n, d["latent"]), generator=g, device=dev),
                drop=(torch.rand((n, 128), generator=g, device=dev) < 0.9).float())
    return params, state, rows


def d2r_case_at(dev, batch, n_batches, seed, dna):
    """`d2r_case` with the DNA input ``dna`` wide."""
    from vae_los_angeles_torch.models.directional_vae import dna2rna_vae_init

    d = TRAIN_DIMS
    params, state = dna2rna_vae_init(torch.Generator().manual_seed(seed), d["dout"], dna,
                                     d["sites"], d["latent"], d["embed"], dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    n = batch * n_batches
    rows = dict(x=torch.rand((n, dna), generator=g, device=dev),
                t=torch.randn((n, d["dout"]), generator=g, device=dev),
                site=torch.randint(0, d["sites"], (n,), generator=g, device=dev),
                eps=torch.randn((n, d["latent"]), generator=g, device=dev),
                drop1=(torch.rand((n, 512), generator=g, device=dev) < 0.9).float(),
                drop2=(torch.rand((n, 256), generator=g, device=dev) < 0.9).float())
    return params, state, rows


# task: (case at a DNA width, wrapper, plain version, order, its BN state as a tuple,
#        the injected noise's names, the fc biases whose gradient is fp32 noise, params/m atol)
DIRECTIONAL = {
    "rna2dna": (train_case_at, fe.rna2dna_fused_epoch, fe.rna2dna_epoch_reference,
                ft.PARAM_ORDER, lambda s: tuple(s["encoder_rna"]["bn"][k] for k in ("mean", "var")),
                ("eps", "drop"), ("b1",), 2e-5),
    "dna2rna": (d2r_case_at, fe.dna2rna_fused_epoch, fe.dna2rna_epoch_reference,
                ft.PARAM_ORDER_D2R, ft.bn_d2r, ("eps", "drop1", "drop2"), ("b1", "b2"), 5e-5),
}


def directional_epoch(task, cur, rows, **kw):
    """One epoch of ``task`` through its wrapper from ``cur`` = (params, m,
    v, state) trees, with the rows' injected noise unless ``seed`` is given."""
    _, wrapper, _, _, _, noise, _, _ = DIRECTIONAL[task]
    inj = {} if "seed" in kw else {f"{k}_ep": rows[k] for k in noise}
    return wrapper(*cur, rows["x"], rows["t"], rows["site"], TRAIN_DIMS["sites"], **inj, **kw)


def check_directional_epoch(task, got, cur, rows, *, beta, lr, step0, n_batches):
    """``got`` against the plain version from ``cur`` on the same rows and
    injected noise: losses rtol 1e-5, params and m at the task's atol (the fc
    biases feeding train-mode BN at 2·lr per step), BN var atol 2e-4, BN
    means at 2·lr per step."""
    _, _, reference, order, bn_of, noise, loose_names, atol = DIRECTIONAL[task]
    flat = [ft.flatten_params(t, order) for t in cur[:3]]
    bn = bn_of(cur[3])
    want = reference(*flat, *(bn if task == "rna2dna" else (bn,)), rows["x"], rows["t"],
                     rows["site"], *(rows[k] for k in noise), seed=0, beta=beta, lr=lr,
                     weight_decay=1e-5, step0=step0, n_batches=n_batches)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    loose = 2 * lr * n_batches
    for tree, ref in ((got[1], want[1]), (got[2], want[2])):
        flat_got = ft.flatten_params(tree, order)
        for name, _ in order:
            torch.testing.assert_close(flat_got[name], ref[name], rtol=0,
                                       atol=loose if name in loose_names else atol,
                                       msg=lambda m, name=name: f"{name}: {m}")
    want_bn = want[4:] if task == "rna2dna" else want[4]
    for i, (a, b) in enumerate(zip(bn_of(got[4]), want_bn)):
        torch.testing.assert_close(a, b, atol=loose if i % 2 == 0 else 2e-4, rtol=0)


def nonzero_moments(dev, flat, order, seed):
    """m and v trees away from zero: from zero moments Adam's first step is
    ±lr, and a gradient within rounding of 0 can take either sign in two fp32
    implementations."""
    g = torch.Generator(device=dev).manual_seed(seed)
    m0 = {k: torch.randn(t.shape, generator=g, device=dev) * 1e-3 for k, t in flat.items()}
    v0 = {k: torch.rand(t.shape, generator=g, device=dev) * 1e-6 for k, t in flat.items()}
    return ft.unflatten(m0, order), ft.unflatten(v0, order)


@pytest.mark.parametrize("task", sorted(DIRECTIONAL))
def test_directional_epoch_graph_replays_new_scalars_rows_and_seeds(task, cuda_device):
    """Two epochs through one cached graph, each with another β, lr, weight
    decay, step0 and rows, both held against the plain version; then Philox
    noise, a new key that captures the graph anew, for two seeds through one
    graph, each epoch equal to the injected epoch given the draws the kernel
    makes."""
    n_batches, batch = 2, 16
    case, _, _, order, _, noise, _, _ = DIRECTIONAL[task]
    params, state, r = case(cuda_device, batch, n_batches, 3, TRAIN_DIMS["dout"])
    start = (params, *nonzero_moments(cuda_device, ft.flatten_params(params, order), order, 6),
             state)
    cur, graph = start, None
    for beta, lr, step0, perm_seed in ((1e-3, 5e-4, 7, 0), (4e-4, 2e-4, 31, 1)):
        perm = torch.randperm(batch * n_batches, generator=torch.Generator().manual_seed(perm_seed))
        rows = {k: t[perm.to(cuda_device)] for k, t in r.items()}
        before = fe.launches[f"{task}_train_epoch"]
        got = directional_epoch(task, cur, rows, beta=beta, lr=lr, step0=step0,
                                n_batches=n_batches)
        assert fe.launches[f"{task}_train_epoch"] == before + 1
        graph = graph or fe.graphs[task][1]
        assert fe.graphs[task][1] is graph
        assert graph.launches_per_step <= 18
        check_directional_epoch(task, got, cur, rows, beta=beta, lr=lr, step0=step0,
                                n_batches=n_batches)
        cur = got[1:]
    philox = [directional_epoch(task, start, r, seed=s, step0=3, n_batches=n_batches)
              for s in (11, 12)]
    assert fe.graphs[task][1] is not graph
    for s, got in zip((11, 12), philox):
        if task == "rna2dna":
            draws = [ft.philox_noise(s, i, batch, 128, TRAIN_DIMS["latent"], cuda_device)
                     for i in range(n_batches)]
        else:
            draws = [ft.philox_noise_d2r(s, i, batch, 512, 256, TRAIN_DIMS["latent"],
                                         cuda_device) for i in range(n_batches)]
        rows = dict(r, **{name: torch.cat([d[j] for d in draws]) for j, name in enumerate(noise)})
        inj = directional_epoch(task, start, rows, step0=3, n_batches=n_batches)
        assert torch.equal(got[0], inj[0])
        for a, b in zip(ft.flatten_params(got[1], order).values(),
                        ft.flatten_params(inj[1], order).values()):
            assert torch.equal(a, b)
    assert not torch.equal(philox[0][0], philox[1][0])


@pytest.mark.parametrize("task", sorted(DIRECTIONAL))
def test_directional_epoch_graph_at_a_dna_width_of_several_tiles(task, cuda_device):
    """The graph at a DNA width of 4,099 (129 column tiles, the last one
    ragged), 4 steps of 16 from non-zero moments, against the plain
    version."""
    n_batches, batch, lr = 4, 16, 5e-4
    case, _, _, order, _, _, _, _ = DIRECTIONAL[task]
    params, state, rows = case(cuda_device, batch, n_batches, 5, 4099)
    start = (params, *nonzero_moments(cuda_device, ft.flatten_params(params, order), order, 8),
             state)
    got = directional_epoch(task, start, rows, lr=lr, step0=2, n_batches=n_batches)
    check_directional_epoch(task, got, start, rows, beta=1e-3, lr=lr, step0=2,
                            n_batches=n_batches)


def test_an_epoch_graph_the_library_refuses_raises(cuda_device):
    """A capture that fails raises with the CUDA error, and nothing is
    cached or falls back: here the library refuses an epoch of no steps."""
    params, _, _ = train_case(cuda_device, 16)
    dims_t = ft.dims_of(ft.flatten_params(params))
    with pytest.raises(RuntimeError, match="rna2dna_epoch_graph_create failed.*CUDA error"):
        fe.epoch_graph("rna2dna", ("refused",), lambda: fe._EpochGraph(
            ft.library(), "rna2dna", cuda_device, dims_t, 16, 0, True, False))
    assert "rna2dna" not in fe.graphs


def test_epoch_graphs_of_the_three_tasks_alternate_without_capture(cuda_device):
    """Epochs of RNA→DNA, DNA→RNA and the tri-modal model, one after another
    twice: each task's second epoch runs through the graph its first one
    captured."""
    n_batches, batch, sites = 2, 16, TRAIN_DIMS["sites"]
    r2d = train_case(cuda_device, batch, n_batches, seed=7)
    d2r = d2r_case(cuda_device, batch, n_batches, seed=8)
    mm = mm_case(cuda_device, batch, n_batches, seed=9)

    def zeros(params, order):
        return ft.unflatten({k: torch.zeros_like(v)
                             for k, v in ft.flatten_params(params, order).items()}, order)

    runs = {
        "rna2dna": lambda: fe.rna2dna_fused_epoch(
            r2d[0], zeros(r2d[0], ft.PARAM_ORDER), zeros(r2d[0], ft.PARAM_ORDER), r2d[1],
            r2d[2]["x"], r2d[2]["t"], r2d[2]["site"], sites, seed=1, n_batches=n_batches),
        "dna2rna": lambda: fe.dna2rna_fused_epoch(
            d2r[0], zeros(d2r[0], ft.PARAM_ORDER_D2R), zeros(d2r[0], ft.PARAM_ORDER_D2R), d2r[1],
            d2r[2]["x"], d2r[2]["t"], d2r[2]["site"], sites, seed=1, n_batches=n_batches),
        "multimodal": lambda: fe.multimodal_fused_epoch(
            mm[0], zeros(mm[0], ft.PARAM_ORDER_MM), zeros(mm[0], ft.PARAM_ORDER_MM), mm[1],
            mm[2]["a"], mm[2]["b"], mm[2]["site"], sites, seed=1, class_weights=mm[3],
            n_batches=n_batches),
    }
    first, losses = {}, {}
    for task, run in runs.items():
        losses[task] = run()[0]
        first[task] = fe.graphs[task][1]
    for task, run in runs.items():
        again = run()[0]
        assert all(fe.graphs[t][1] is first[t] for t in runs)
        assert torch.equal(again, losses[task])  # the same epoch from the same inputs


# ---- the wide head (B8): odd widths, a ragged last column tile, two row tiles ----
WIDE_NAMES = ("w", "b", "m_w", "v_w", "m_b", "v_b", "step", "dh", "loss")


def wide_inputs(dev, n, d_in, big, seed=0):
    """Inputs drawn as the JAX test's ``_inputs``: non-zero moments, so no
    gradient within rounding of 0 decides the sign of an Adam step."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((n, d_in), generator=g, device=dev),
            torch.rand((n, big), generator=g, device=dev),
            torch.randn((d_in, big), generator=g, device=dev) * 0.05,
            torch.randn((big,), generator=g, device=dev) * 0.05,
            torch.randn((d_in, big), generator=g, device=dev) * 0.01,
            torch.rand((d_in, big), generator=g, device=dev) * 1e-4,
            torch.randn((big,), generator=g, device=dev) * 0.01,
            torch.rand((big,), generator=g, device=dev) * 1e-4)


def check_wide(got, want, lr):
    for name, a, e in zip(WIDE_NAMES, got, want):
        err = float((a.double() - e.double()).abs().max())
        if name in ("w", "b"):
            assert err <= 0.02 * lr, (name, err)
        elif name == "step":
            assert int(a) == int(e), name
        elif name == "loss":
            assert err <= 1e-5 * abs(float(e)), (name, err)
        else:
            assert err <= 2e-5 * float(e.abs().max()), (name, err)


# one sweep up to 32 rows: B = 1; B = 32 at d_in 512 with 4 column tiles for
# 132 persistent blocks; 141 tiles, the last one ragged; then three launches
# from 33 rows on
@pytest.mark.parametrize("n,d_in,big", [(7, 40, 301), (70, 72, 1000), (130, 16, 257),
                                        (1, 36, 100), (32, 512, 100), (32, 40, 4501),
                                        (33, 40, 301), (256, 24, 257)])
def test_wide_kernel_matches_plain_version_over_three_steps(n, d_in, big, cuda_device):
    h, t, *state = wide_inputs(cuda_device, n, d_in, big)
    state = tuple(state) + (torch.zeros((), dtype=torch.int32, device=cuda_device),)
    sk = sr = state
    before = fw.launches["fused_wide_output_step"]
    for _ in range(3):
        got = fw.fused_wide_output_step(h, t, *sk, 1e-3, 1e-2)
        want = fw.fused_wide_output_step_reference(h, t, *sr, 1e-3, 1e-2)
        torch.cuda.synchronize()
        check_wide(got, want, 1e-3)
        sk, sr = got[:7], want[:7]
    assert fw.launches["fused_wide_output_step"] - before == 3
    assert got[0].shape == (d_in, big) and got[7].shape == (n, d_in)


def test_run_training_takes_the_wide_head_from_the_threshold_on(cuda_device, monkeypatch,
                                                                 tmp_path, capsys):
    """With USE_PALLAS and fp32 AdamW the CLI trains rna2dna data at least
    WIDE_HEAD_MIN_DIM_B probes wide (lowered to 301 here) through the wide
    head each step, and says so; narrower data through the epoch kernel."""
    from vae_los_angeles_torch.training.cli import run_training

    monkeypatch.setattr(engine, "WIDE_HEAD_MIN_DIM_B", 301)
    rng = np.random.default_rng(2)
    for width, path, heads, epochs in ((301, "wide head kernel", 6, 0),
                                       (300, "epoch kernel", 0, 1)):
        cfg = Config(input_dim_a=DIM_A, input_dim_b=width, latent_dim=LATENT,
                     embed_dim=EMBED, batch_size=16, use_pallas=True,
                     checkpoint_dir=str(tmp_path / "checkpoints"),
                     plots_dir=str(tmp_path / "plots"))
        data = (rng.normal(size=(120, DIM_A)).astype(np.float32),
                rng.uniform(size=(120, width)).astype(np.float32),
                rng.integers(0, N_SITES, size=120))
        before = (fw.launches["fused_wide_output_step"], fe.launches["rna2dna_train_epoch"])
        run_training("rna2dna", "rna2dna", cfg=cfg, argv=["--epochs", "1"], data=data,
                     n_sites=N_SITES, device=cuda_device, root=str(tmp_path))
        assert f"path: {path}" in capsys.readouterr().out
        assert fw.launches["fused_wide_output_step"] - before[0] == heads
        assert fe.launches["rna2dna_train_epoch"] - before[1] == epochs


def test_wide_kernel_refuses_more_rows_than_it_takes(cuda_device):
    h, t, *state = wide_inputs(cuda_device, 900, 8, 64)
    with pytest.raises(ValueError, match="at most"):
        fw.fused_wide_output_step(h, t, *state, 0, 1e-3, 0.0)


def test_fit_through_the_wide_head_launches_it_each_step(cuda_device, monkeypatch):
    """The epoch kernel's request at a width that takes the wide head (the
    threshold lowered to 301 probes) launches it each step, and no epoch
    kernel."""
    cfg = Config(input_dim_a=DIM_A, input_dim_b=301, latent_dim=LATENT, embed_dim=EMBED,
                 batch_size=16)
    rng = np.random.default_rng(1)
    data = (rng.normal(size=(96, DIM_A)).astype(np.float32),
            rng.uniform(size=(96, 301)).astype(np.float32), rng.integers(0, N_SITES, size=96))
    val = tuple(a[:40] for a in data)
    monkeypatch.setattr(engine, "WIDE_HEAD_MIN_DIM_B", 301)
    before = fw.launches["fused_wide_output_step"]
    epochs_before = fe.launches["rna2dna_train_epoch"]
    head = engine.fit("rna2dna", cfg, data, val, 0, N_SITES, num_epochs=2, device=cuda_device,
                      fused_epoch=True)
    assert fw.launches["fused_wide_output_step"] - before == 12
    assert fe.launches["rna2dna_train_epoch"] == epochs_before
    plain = engine.fit("rna2dna", cfg, data, val, 0, N_SITES, num_epochs=2, device=cuda_device)
    assert np.isfinite(head.train_losses).all() and head.train_losses[1] < head.train_losses[0]
    np.testing.assert_allclose(head.train_losses, plain.train_losses, rtol=1e-4)


# ---- the step graphs (B1, B4, B6): one captured graph a call, one cached a task ----
def bn_r2d(state):
    """(rm, rv) of an RNA2DNAVAE's BatchNorm state tree."""
    return state["encoder_rna"]["bn"]["mean"], state["encoder_rna"]["bn"]["var"]


def r2d_reference(flat, bn, r, noise, beta, gamma, cw):
    loss, grads, rm, rv = ft.rna2dna_train_step_reference(flat, *bn, r["x"], r["t"], r["site"],
                                                          *noise, beta)
    return loss, grads, (rm, rv)


STEP_GRAPH = {
    # task: (case, wrapper's row arguments, plain version, order, BN state as a tuple,
    #        the injected noise's names and keywords, per-gradient tolerance)
    "rna2dna": (train_case, lambda r: (r["x"], r["t"]), r2d_reference, ft.PARAM_ORDER, bn_r2d,
                ("eps", "drop"), ("eps", "drop_mask"), lambda name: GRAD),
    "dna2rna": (d2r_case, lambda r: (r["t"], r["x"]),
                lambda flat, bn, r, noise, beta, gamma, cw: ft.dna2rna_train_step_reference(
                    flat, bn, r["x"], r["t"], r["site"], *noise, beta),
                ft.PARAM_ORDER_D2R, ft.bn_d2r, ("eps", "drop1", "drop2"),
                ("eps", "drop_mask1", "drop_mask2"), lambda name: GRAD_D2R),
    "multimodal": (lambda dev, batch, n_batches=1, seed=0: mm_case(dev, batch, n_batches, seed)[:3],
                   lambda r: (r["a"], r["b"]),
                   lambda flat, bn, r, noise, beta, gamma, cw: ft.multimodal_train_step_reference(
                       flat, bn, r["a"], r["b"], r["site"], cw, *noise, beta, gamma),
                   ft.PARAM_ORDER_MM, ft.bn_mm, MM_NOISE, MM_NOISE,
                   lambda name: dict(atol=2e-3 if name in MM_ZERO_GRAD else 1e-3, rtol=1e-4)),
}


def graph_step(task, params, state, r, cw=None, noise=True, gamma=1.7, **kw):
    """One call of ``task``'s step wrapper with the rows' injected noise (or
    Philox noise with ``noise=False``); ``cw`` and ``gamma`` for the
    tri-modal model only."""
    _, rows_of, _, _, _, names, keys, _ = STEP_GRAPH[task]
    fn = getattr(ft, f"{task}_fused_train_step")
    if task == "multimodal":
        kw.update(class_weights=cw, gamma=gamma)
    if noise:
        kw.update({k: r[n] for k, n in zip(keys, names)})
    return fn(params, state, *rows_of(r), r["site"], TRAIN_DIMS["sites"], **kw)


def step_values(task, out):
    """(loss, the gradients in order, the BN statistics) of a wrapper's result."""
    order, bn_of = STEP_GRAPH[task][3], STEP_GRAPH[task][4]
    return [out[0], *ft.flatten_params(out[1], order).values(), *bn_of(out[2])]


def check_step(task, got, params, state, r, cw, beta, gamma):
    """A step graph's result against the plain version on the same inputs."""
    _, _, plain, order, bn_of, names, _, tol = STEP_GRAPH[task]
    want = plain(ft.flatten_params(params, order), bn_of(state), r,
                 tuple(r[n] for n in names), beta, gamma, cw)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    flat = ft.flatten_params(got[1], order)
    for name, _ in order:
        torch.testing.assert_close(flat[name], want[1][name], **tol(name), msg=name)
    for a, b in zip(bn_of(got[2]), want[2]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def perturbed(params, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tree_map(lambda t: t + 0.05 * torch.randn(t.shape, generator=g, device=dev), params)


@pytest.mark.parametrize("task", sorted(STEP_GRAPH))
def test_step_graph_replays_new_rows_weights_seeds_steps_and_scalars(task, cuda_device):
    """Four calls through one cached graph, each with other rows, weights,
    seed, step, β and γ, each held against a fresh plain version; the graph
    holds one launch of the args node and the step's phases."""
    case = STEP_GRAPH[task][0]
    _, _, _, cw = mm_case(cuda_device, 16, seed=40)
    graph = None
    for k in range(4):
        params, state, r = case(cuda_device, 16, seed=20 + k)
        if k:
            params = perturbed(params, k, cuda_device)
        beta, gamma = 1e-3 * (k + 1), 1.7 / (k + 1)
        before = ft.launches[f"{task}_train_step"]
        got = graph_step(task, params, state, r, cw, gamma=gamma, seed=2**40 + k, step=3 * k,
                         beta=beta)
        assert ft.launches[f"{task}_train_step"] == before + 1
        check_step(task, got, params, state, r, cw, beta, gamma)
        g = ft.step_graphs[task][1]
        assert graph is None or g is graph  # no capture after the first call
        graph = g
    assert graph.nodes == {"rna2dna": 18, "dna2rna": 18, "multimodal": 22}[task]


@pytest.mark.parametrize("task", sorted(STEP_GRAPH))
def test_step_graph_results_never_alias_its_buffers(task, cuda_device):
    """The gradients, statistics and loss of call k are unchanged by call
    k + 1 and lie outside the graph's buffers."""
    case = STEP_GRAPH[task][0]
    _, _, _, cw = mm_case(cuda_device, 16, seed=41)
    params, state, r = case(cuda_device, 16, seed=30)
    first = graph_step(task, params, state, r, cw)
    kept = [t.clone() for t in step_values(task, first)]
    params2, state2, r2 = case(cuda_device, 16, seed=31)
    second = graph_step(task, params2, state2, r2, cw)
    g = ft.step_graphs[task][1]
    lo, hi = g.out.data_ptr(), g.out.data_ptr() + 4 * g.out.numel()
    for a, b, c in zip(step_values(task, first), kept, step_values(task, second)):
        assert torch.equal(a, b)
        assert not lo <= a.data_ptr() < hi
    assert not torch.equal(kept[1], step_values(task, second)[1])


@pytest.mark.parametrize("batch", [32, 7])
@pytest.mark.parametrize("noise", ["injected", "philox"])
def test_rna2dna_step_graph_matches_plain_version(batch, noise, cuda_device):
    """B1 through its graph against `rna2dna_train_step_reference`, with the
    rows' injected noise or Philox noise (the plain version given the noise
    kernel's draws); one graph launch a call."""
    params, state, r = train_case(cuda_device, batch, seed=90 + batch)
    kw = dict(seed=2**40 + batch, step=5, beta=2e-3)
    if noise == "philox":
        r = dict(r, **dict(zip(("eps", "drop"), ft.philox_noise(
            kw["seed"], kw["step"], batch, 128, TRAIN_DIMS["latent"], cuda_device))))
    before = ft.launches["rna2dna_train_step"]
    got = graph_step("rna2dna", params, state, r, noise=noise == "injected", **kw)
    assert ft.launches["rna2dna_train_step"] == before + 1
    check_step("rna2dna", got, params, state, r, None, kw["beta"], 0.0)
    assert ft.step_graphs["rna2dna"][0][3:5] == (batch, noise == "injected")


def test_rna2dna_step_graphs_of_two_shapes_have_two_keys(cuda_device):
    """A call at another batch captures a graph of its own key (the task's
    old one freed), and both shapes match the plain version."""
    keys, graphs = [], []
    for batch in (32, 7):
        params, state, r = train_case(cuda_device, batch, seed=95)
        got = graph_step("rna2dna", params, state, r, beta=1e-3)
        check_step("rna2dna", got, params, state, r, None, 1e-3, 0.0)
        key, g = ft.step_graphs["rna2dna"]
        keys.append(key)
        graphs.append(g)
    assert keys[0] != keys[1] and keys[0][3] == 32 and keys[1][3] == 7
    assert graphs[0] is not graphs[1] and graphs[1].nodes == 18


def test_step_graphs_of_the_two_tasks_alternate_without_capture(cuda_device):
    """The RNA→DNA, DNA→RNA and tri-modal steps, one after another three
    times: each task's later calls run through the graph its first call
    captured and give its bits."""
    cases = {task: STEP_GRAPH[task][0](cuda_device, 16, seed=50) for task in STEP_GRAPH}
    _, _, _, cw = mm_case(cuda_device, 16, seed=51)
    first, values = {}, {}
    for _ in range(3):
        for task, (params, state, r) in cases.items():
            out = step_values(task, graph_step(task, params, state, r, cw, noise=False, seed=9,
                                               step=4))
            if task not in first:
                first[task], values[task] = ft.step_graphs[task][1], out
            assert ft.step_graphs[task][1] is first[task]
            assert all(torch.equal(a, b) for a, b in zip(out, values[task]))


@pytest.mark.parametrize("task", sorted(STEP_GRAPH))
def test_step_graph_philox_draws_equal_the_noise_kernels(task, cuda_device):
    """Through one Philox graph at several steps and a seed past 32 bits,
    each call equals the injected call given the draws of the noise kernels
    (``philox_noise_*``, the parent's bits), bit for bit."""
    params, state, r = STEP_GRAPH[task][0](cuda_device, 16, seed=60)
    _, _, _, cw = mm_case(cuda_device, 16, seed=61)
    d, names = TRAIN_DIMS, STEP_GRAPH[task][5]
    for seed, step in ((2**40 + 7, 0), (2**40 + 7, 5), (3, 2**31 - 1)):
        got = step_values(task, graph_step(task, params, state, r, cw, noise=False, seed=seed,
                                           step=step))
        if task == "rna2dna":
            draws = ft.philox_noise(seed, step, 16, 128, d["latent"], cuda_device)
        elif task == "dna2rna":
            draws = ft.philox_noise_d2r(seed, step, 16, 512, 256, d["latent"], cuda_device)
        else:
            draws = ft.philox_noise_mm(seed, step, 16, 128, 512, 256, d["latent"], cuda_device)
        want = step_values(task, graph_step(task, params, state, dict(r, **dict(zip(names, draws))),
                                            cw))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (seed, step)


def plain_launches(monkeypatch, pdl):
    """Graphs captured from here on launch their phases programmatically
    (``pdl``) or as plain stream launches (the private ``pdl`` of
    `ft._StepGraph` and `fe._EpochGraph`, whichever a wrapper would choose),
    in caches of their own."""
    for mod, cls, cache in ((ft, "_StepGraph", "step_graphs"), (fe, "_EpochGraph", "graphs")):
        monkeypatch.setattr(mod, cache, {})
        monkeypatch.setattr(mod, cls, functools.partial(GRAPH_CLASSES[cls], pdl=pdl))


GRAPH_CLASSES = {"_StepGraph": ft._StepGraph, "_EpochGraph": fe._EpochGraph}


@pytest.mark.parametrize("task", sorted(STEP_GRAPH))
def test_step_graph_launch_modes_give_the_same_bits(task, cuda_device, monkeypatch):
    """A step graph whose phases launch programmatically, fetching weight
    tiles before they wait (what the wrapper captures), gives the bits of
    the same graph launched as plain stream launches (the host loop's
    order)."""
    params, state, r = STEP_GRAPH[task][0](cuda_device, 32, seed=70)
    _, _, _, cw = mm_case(cuda_device, 32, seed=71)
    got = {}
    for pdl in (True, False):
        plain_launches(monkeypatch, pdl)
        got[pdl] = step_values(task, graph_step(task, params, state, r, cw, noise=False, seed=3,
                                                step=2))
        assert ft.step_graphs[task][1].nodes > 1
    assert all(torch.equal(a, b) for a, b in zip(got[True], got[False]))


@pytest.mark.parametrize("task", ["rna2dna", "dna2rna", "multimodal"])
def test_epoch_graph_launch_modes_give_the_same_bits(task, cuda_device, monkeypatch):
    """An epoch graph whose phases launch programmatically (the tri-modal
    wrapper's) gives the bits of the same epoch as plain stream launches
    (the directional wrappers') for each task."""
    n_batches, batch, sites = 3, 16, TRAIN_DIMS["sites"]
    if task == "rna2dna":
        params, state, r = train_case(cuda_device, batch, n_batches, seed=80)
        order, rows, fn, kw = ft.PARAM_ORDER, (r["x"], r["t"]), fe.rna2dna_fused_epoch, {}
    elif task == "dna2rna":
        params, state, r = d2r_case(cuda_device, batch, n_batches, seed=81)
        order, rows, fn, kw = ft.PARAM_ORDER_D2R, (r["x"], r["t"]), fe.dna2rna_fused_epoch, {}
    else:
        params, state, r, cw = mm_case(cuda_device, batch, n_batches, seed=82)
        order, rows, fn = ft.PARAM_ORDER_MM, (r["a"], r["b"]), fe.multimodal_fused_epoch
        kw = dict(class_weights=cw, gamma=1.7)
    m, v = nonzero_moments(cuda_device, ft.flatten_params(params, order), order, 83)
    got = {}
    for pdl in (True, False):
        plain_launches(monkeypatch, pdl)
        out = fn(params, m, v, state, *rows, r["site"], sites, seed=4, step0=3,
                 n_batches=n_batches, **kw)
        assert task in fe.graphs
        got[pdl] = [out[0]] + [t for tree in out[1:4]
                               for t in ft.flatten_params(tree, order).values()]
    assert all(torch.equal(a, b) for a, b in zip(got[True], got[False]))
