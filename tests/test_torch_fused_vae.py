"""The port's fused eval forwards (``ops/kernels/fused_vae.py``).

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX package's Pallas kernels (interpret mode, as the JAX tests
run them) and against the unfused models. The kernel itself is held against
its plain version only on a card (``tests/test_torch_kernels_cuda.py``;
``chip_smoke.py`` runs the same comparison at the full width).

Tolerances: atol = rtol = 1e-5 for one layer, 1e-4 through the chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch import device as port_device
from vae_los_angeles_torch.models import DNA2RNAVAE, RNA2DNAVAE
from vae_los_angeles_torch.ops import nn as port_nn
from vae_los_angeles_torch.ops.kernels import fused_vae as fv
from vae_los_angeles_torch.utils.weights import state_dict_from_jax
from vae_los_angeles_tpu.models import directional_vae as jdv
from vae_los_angeles_tpu.ops.pallas import fused_vae as jfv

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT = 40, 56, 5, 8
LAYER = dict(atol=1e-5, rtol=1e-5)
CHAIN = dict(atol=1e-4, rtol=1e-4)
FAMILIES = {
    "rna2dna": (jdv.rna2dna_vae_init, jdv.rna2dna_vae_apply, jfv.FusedRNA2DNA,
                fv.FusedRNA2DNA, RNA2DNAVAE, "rna", DIM_A),
    "dna2rna": (jdv.dna2rna_vae_init, jdv.dna2rna_vae_apply, jfv.FusedDNA2RNA,
                fv.FusedDNA2RNA, DNA2RNAVAE, "dna", DIM_B),
}


def jax_model(model_type, seed=0):
    init = FAMILIES[model_type][0]
    params, state = init(jax.random.PRNGKey(seed), DIM_A, DIM_B, N_SITES, LATENT)
    state = jax.tree.map(
        lambda x: x + 0.3 * jax.random.uniform(jax.random.PRNGKey(seed + 1), x.shape), state
    )
    return jax.tree.map(np.asarray, (params, state))


def pallas_forward(fused, x, site):
    """The Pallas kernel in interpret mode, waited for: it calls back into
    Python while it runs, and JAX work dispatched before it ends can
    deadlock the CPU client."""
    return jax.block_until_ready(fused(x, site, use_noise=False))


def inputs(din, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, din)).astype(np.float32) * 2,
            rng.integers(0, N_SITES, size=(n,)),
            rng.normal(size=(n, LATENT)).astype(np.float32))


def test_fold_bn_eval_matches_jax():
    params, state = jax_model("rna2dna")
    t = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}  # noqa: E731
    args = (params["encoder_rna"]["fc"], params["encoder_rna"]["bn"], state["encoder_rna"]["bn"])
    w, b = port_nn.fold_bn_eval(*(t(a) for a in args))
    jw, jb = jfv.fold_bn_eval(*args)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **LAYER)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), **LAYER)
    assert port_nn.BN_EPS == 1e-5


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
@pytest.mark.parametrize("with_site", [True, False])
def test_plain_version_matches_pallas_kernel_and_unfused_apply(model_type, with_site):
    _, apply, jax_cls, port_cls, _, kw, din = FAMILIES[model_type]
    params, state = jax_model(model_type)
    x, site, _ = inputs(din)
    s = site if with_site else None
    want = pallas_forward(jax_cls(params, state), jnp.asarray(x),
                          None if s is None else jnp.asarray(s))
    unfused = apply(params, state, None, site=None if s is None else jnp.asarray(s),
                    train=False, noise_scale=0.0, **{kw: jnp.asarray(x)})
    got = port_cls(params, state)(torch.from_numpy(x),
                                  None if s is None else torch.from_numpy(s), use_noise=False)
    for g, w, u in zip(got, want, (unfused.recon, unfused.mu, unfused.logvar)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CHAIN)
        np.testing.assert_allclose(g.numpy(), np.asarray(u), **CHAIN)


@pytest.mark.parametrize("model_type,dim_b", [("dna2rna", 7001), ("rna2dna", 8191)])
def test_plain_version_matches_pallas_kernel_at_a_wide_dna_width(model_type, dim_b):
    """The wide regime's widths (a DNA input past what one tile of the first
    kernel design staged, a wide DecoderB output): the plain version the
    card's kernels are held against equals the Pallas kernel there too."""
    init, apply, jax_cls, port_cls, _, kw, _ = FAMILIES[model_type]
    params, state = init(jax.random.PRNGKey(3), DIM_A, dim_b, N_SITES, LATENT)
    state = jax.tree.map(
        lambda x: x + 0.3 * jax.random.uniform(jax.random.PRNGKey(4), x.shape), state)
    params, state = jax.tree.map(np.asarray, (params, state))
    din = dim_b if model_type == "dna2rna" else DIM_A
    x, site, _ = inputs(din, n=8, seed=5)
    want = pallas_forward(jax_cls(params, state), jnp.asarray(x), jnp.asarray(site))
    got = port_cls(params, state)(torch.from_numpy(x), torch.from_numpy(site), use_noise=False)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CHAIN)


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_injected_eps_equals_unfused_module(model_type):
    _, apply, _, port_cls, model_cls, kw, din = FAMILIES[model_type]
    params, state = jax_model(model_type)
    x, site, eps = inputs(din, seed=2)
    module = model_cls(DIM_A, DIM_B, N_SITES, LATENT).eval()
    module.load_state_dict(state_dict_from_jax(params, state, model_type))
    xt, st, et = torch.from_numpy(x), torch.from_numpy(site), torch.from_numpy(eps)
    recon, mu, logvar = port_cls(params, state)(xt, st, eps=et)
    with torch.no_grad():
        m_recon, _, m_mu, m_lv = module(**{kw: xt}, site=st, eps=et)
    torch.testing.assert_close(recon, m_recon, **CHAIN)
    torch.testing.assert_close(mu, m_mu, **CHAIN)
    torch.testing.assert_close(logvar, m_lv, **CHAIN)
    # and the JAX apply, given the eps its own key split draws
    key = jax.random.PRNGKey(5)
    out = apply(params, state, key, site=jnp.asarray(site), train=False, **{kw: jnp.asarray(x)})
    eps_j = np.array(jax.random.normal(jax.random.split(key)[1], (len(x), LATENT), jnp.float32))
    recon_j, _, _ = port_cls(params, state)(xt, st, eps=torch.from_numpy(eps_j))
    np.testing.assert_allclose(recon_j.numpy(), np.asarray(out.recon), **CHAIN)


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(model_type):
    port_cls = FAMILIES[model_type][3]
    params, state = jax_model(model_type)
    fused = port_cls(params, state)
    x, site, _ = inputs(FAMILIES[model_type][6])
    before = port_cls.launches
    got = fused(torch.from_numpy(x), torch.from_numpy(site), seed=3)
    want = port_cls._reference(fused.folded, torch.from_numpy(x), torch.from_numpy(site),
                               fv.NOISE_PHILOX, None, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert port_cls.launches == before


def test_philox_mode_of_the_plain_version():
    params, state = jax_model("rna2dna")
    fused = fv.FusedRNA2DNA(params, state)
    x, site, _ = inputs(DIM_A, n=64)
    x, site = torch.from_numpy(x), torch.from_numpy(site)
    det = fused(x, site, use_noise=False)[0]
    draws = torch.stack([fused(x, site, seed=s)[0] for s in range(6)])
    assert torch.equal(draws[0], fused(x, site, seed=0)[0])
    assert not torch.equal(draws[0], draws[1])
    assert ((draws >= 0) & (draws <= 1)).all()
    assert (draws.mean(0) - det).abs().mean() < (draws[0] - det).abs().mean()


def test_out_of_range_site_gives_a_zero_embedding_row():
    """The Pallas kernel's one-hot of an out-of-range label is a zero row;
    the plain version (and the CUDA kernel) gather the same."""
    params, state = jax_model("dna2rna")
    x, site, _ = inputs(DIM_B, n=4)
    site[1] = N_SITES + 2
    want = pallas_forward(jfv.FusedDNA2RNA(params, state), jnp.asarray(x), jnp.asarray(site))
    got = fv.FusedDNA2RNA(params, state)(torch.from_numpy(x), torch.from_numpy(site),
                                         use_noise=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CHAIN)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    params, state = jax_model("rna2dna")
    fused = fv.FusedRNA2DNA(params, state)
    x = torch.zeros(4, DIM_A)
    with pytest.raises(TypeError):
        fused(x.double())
    with pytest.raises(ValueError):
        fused(torch.zeros(4, DIM_A + 1))
    with pytest.raises(ValueError):
        fused(torch.zeros(DIM_A, 4).t())  # not contiguous
    with pytest.raises(TypeError):
        fused(x, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        fused(x, eps=torch.zeros(4, LATENT), use_noise=False)
    with pytest.raises(ValueError):
        fused(x, eps=torch.zeros(3, LATENT))
    with pytest.raises(ValueError):
        fused(x, seed=-1)
    with pytest.raises(ValueError):
        fused(np.zeros((4, DIM_A), np.float32))
    with pytest.raises(ValueError):
        fused(x.to("meta"))


def test_require_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.require_cuda()
    # the default device is the card: without one it raises, never the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device()
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
