"""Port modules against the JAX package's apply functions on the same
weights, moved across by ``utils.weights``: the eval-mode modules, and the
functional train-mode forwards (``*_vae_apply``, ``encoder_b_apply``,
``decoder_a_apply``) with the dropout masks and eps that the JAX apply draws
from its key.

Tolerances: atol = rtol = 1e-5 for one layer, 1e-4 through the whole chain
(fp32 on the CPU on both sides, summed in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_los_angeles_torch.models import DNA2RNAVAE, RNA2DNAVAE
from vae_los_angeles_torch.models import decoders as pdec
from vae_los_angeles_torch.models import directional_vae as pdv
from vae_los_angeles_torch.models import encoders as penc
from vae_los_angeles_torch.models.vae import fuse_posteriors, reparameterize
from vae_los_angeles_torch.ops.nn import reset_parameters
from vae_los_angeles_torch.utils.weights import state_dict_from_jax, tree_from_numpy
from vae_los_angeles_tpu.models import decoders as jdec
from vae_los_angeles_tpu.models import directional_vae as jdv
from vae_los_angeles_tpu.models import encoders as jenc

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, EMBED = 40, 56, 5, 8, 6
LAYER = dict(atol=1e-5, rtol=1e-5)
CHAIN = dict(atol=1e-4, rtol=1e-4)
FAMILIES = {
    "rna2dna": (jdv.rna2dna_vae_init, jdv.rna2dna_vae_apply, RNA2DNAVAE, "rna", DIM_A),
    "dna2rna": (jdv.dna2rna_vae_init, jdv.dna2rna_vae_apply, DNA2RNAVAE, "dna", DIM_B),
}


def make_pair(model_type, seed=0):
    """JAX (params, state) with randomized BN stats, and the port module
    holding the same weights."""
    init, _, model_cls, _, _ = FAMILIES[model_type]
    params, state = init(jax.random.PRNGKey(seed), DIM_A, DIM_B, N_SITES, LATENT, EMBED)
    state = jax.tree.map(
        lambda x: x + 0.3 * jax.random.uniform(jax.random.PRNGKey(seed + 1), x.shape), state
    )
    params, state = jax.tree.map(np.asarray, (params, state))
    model = model_cls(DIM_A, DIM_B, N_SITES, LATENT, EMBED).eval()
    model.load_state_dict(state_dict_from_jax(params, state, model_type))
    return params, state, model


def inputs(din, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, din)).astype(np.float32),
            rng.integers(0, N_SITES, size=(n,)))


def test_encoders_match_layer_by_layer():
    params, state, model = make_pair("rna2dna")
    x, site = inputs(DIM_A)
    mu, lv, _ = jenc.encoder_a_apply(params["encoder_rna"], state["encoder_rna"],
                                     jnp.asarray(x), train=False)
    with torch.no_grad():
        pmu, plv = model.encoder_rna(torch.from_numpy(x))
        smu, slv = model.encoder_site(torch.from_numpy(site))
    np.testing.assert_allclose(pmu.numpy(), np.asarray(mu), **LAYER)
    np.testing.assert_allclose(plv.numpy(), np.asarray(lv), **LAYER)
    jmu, jlv, _ = jenc.encoder_c_apply(params["encoder_site"], {}, jnp.asarray(site))
    np.testing.assert_allclose(smu.numpy(), np.asarray(jmu), **LAYER)
    np.testing.assert_allclose(slv.numpy(), np.asarray(jlv), **LAYER)

    params, state, model = make_pair("dna2rna")
    x, _ = inputs(DIM_B)
    mu, lv, _ = jenc.encoder_b_apply(params["encoder_dna"], state["encoder_dna"],
                                     jnp.asarray(x), train=False)
    with torch.no_grad():
        pmu, plv = model.encoder_dna(torch.from_numpy(x))
    np.testing.assert_allclose(pmu.numpy(), np.asarray(mu), **LAYER)
    np.testing.assert_allclose(plv.numpy(), np.asarray(lv), **LAYER)


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
@pytest.mark.parametrize("with_site", [True, False])
def test_eval_forward_at_z_equal_mu(model_type, with_site):
    _, apply, _, kw, din = FAMILIES[model_type]
    params, state, model = make_pair(model_type)
    x, site = inputs(din)
    s = site if with_site else None
    out = apply(params, state, jax.random.PRNGKey(3), train=False, noise_scale=0.0,
                site=None if s is None else jnp.asarray(s), **{kw: jnp.asarray(x)})
    with torch.no_grad():
        recon, logits, mu, lv = model(
            **{kw: torch.from_numpy(x)}, site=None if s is None else torch.from_numpy(s),
            eps=torch.zeros(len(x), LATENT),
        )
    for got, want in ((recon, out.recon), (logits, out.recon_logits),
                      (mu, out.mu), (lv, out.logvar)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN)


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_eval_forward_with_the_jax_noise(model_type):
    """eps drawn from the JAX key split the apply itself uses
    (``k_drop, k_z = split(key)``), handed to the port."""
    _, apply, _, kw, din = FAMILIES[model_type]
    params, state, model = make_pair(model_type)
    x, site = inputs(din, seed=1)
    key = jax.random.PRNGKey(11)
    out = apply(params, state, key, site=jnp.asarray(site), train=False,
                **{kw: jnp.asarray(x)})
    _, k_z = jax.random.split(key)
    eps = np.array(jax.random.normal(k_z, (len(x), LATENT), jnp.float32))
    with torch.no_grad():
        recon, _, mu, _ = model(**{kw: torch.from_numpy(x)}, site=torch.from_numpy(site),
                                eps=torch.from_numpy(eps))
    np.testing.assert_allclose(mu.numpy(), np.asarray(out.mu), **CHAIN)
    np.testing.assert_allclose(recon.numpy(), np.asarray(out.recon), **CHAIN)


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_site_only_forward(model_type):
    _, apply, _, kw, _ = FAMILIES[model_type]
    params, state, model = make_pair(model_type)
    _, site = inputs(4)
    out = apply(params, state, None, site=jnp.asarray(site), train=False, noise_scale=0.0)
    with torch.no_grad():
        recon, _, mu, lv = model(site=torch.from_numpy(site), eps=torch.zeros(len(site), LATENT))
    np.testing.assert_allclose(mu.numpy(), np.asarray(out.mu), **LAYER)
    np.testing.assert_allclose(recon.numpy(), np.asarray(out.recon), **CHAIN)
    with pytest.raises(ValueError):
        model()


def test_posterior_helpers():
    g = torch.Generator().manual_seed(0)
    mu, lv = torch.randn(5, 3, generator=g), torch.randn(5, 3, generator=g)
    assert torch.equal(reparameterize(mu, lv, eps=torch.zeros(5, 3)), mu)
    a = reparameterize(mu, lv, generator=torch.Generator().manual_seed(1))
    b = reparameterize(mu, lv, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, mu)
    fm, fl = fuse_posteriors([mu, 2 * mu], [lv, 3 * lv])
    torch.testing.assert_close(fm, 1.5 * mu)
    torch.testing.assert_close(fl, 2 * lv)
    assert fuse_posteriors([mu], [lv])[0] is mu


def test_reset_parameters_is_seeded_and_torch_default_shaped():
    a = reset_parameters(RNA2DNAVAE(DIM_A, DIM_B, N_SITES, LATENT, EMBED), torch.Generator().manual_seed(4))
    b = reset_parameters(RNA2DNAVAE(DIM_A, DIM_B, N_SITES, LATENT, EMBED), torch.Generator().manual_seed(4))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.encoder_rna.fc[0].weight
    bound = 1 / np.sqrt(DIM_A)
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert a.encoder_rna.fc[1].running_var.eq(1).all()


def jax_train_noise(model_type, key, n):
    """The dropout masks and eps that the JAX apply draws from ``key``
    (``k_drop, k_z = split(key)``; EncoderB splits k_drop once more)."""
    k_drop, k_z = jax.random.split(key)
    if model_type == "rna2dna":
        masks = {"drop_mask": jax.random.bernoulli(k_drop, 0.9, (n, 128))}
    else:
        k1, k2 = jax.random.split(k_drop)
        masks = {"drop_mask1": jax.random.bernoulli(k1, 0.9, (n, 512)),
                 "drop_mask2": jax.random.bernoulli(k2, 0.9, (n, 256))}
    eps = jax.random.normal(k_z, (n, LATENT), jnp.float32)
    return ({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in masks.items()},
            torch.from_numpy(np.array(eps)))


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_train_forward_with_the_jax_noise(model_type):
    """The train-mode ``*_vae_apply`` of both packages: recon, posterior and
    every BatchNorm's new running statistics."""
    _, j_apply, _, kw, din = FAMILIES[model_type]
    params, state, _ = make_pair(model_type, seed=2)
    x, site = inputs(din, seed=3)
    key = jax.random.PRNGKey(5)
    out = j_apply(params, state, key, site=jnp.asarray(site), train=True,
                  **{kw: jnp.asarray(x)})
    masks, eps = jax_train_noise(model_type, key, len(x))
    got = getattr(pdv, f"{model_type}_vae_apply")(
        tree_from_numpy(params), tree_from_numpy(state), site=torch.from_numpy(site),
        train=True, eps=eps, **masks, **{kw: torch.from_numpy(x)})
    for a, b in ((got.recon, out.recon), (got.recon_logits, out.recon_logits),
                 (got.mu, out.mu), (got.logvar, out.logvar)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **CHAIN)
    want_state = jax.tree.map(np.asarray, out.state)
    for enc, bns in want_state.items():
        for bn, stats in bns.items():
            for k, w in stats.items():
                np.testing.assert_allclose(got.state[enc][bn][k].numpy(), w, **LAYER)


def test_encoder_b_and_decoder_a_layers_in_train_mode():
    params, state, _ = make_pair("dna2rna", seed=4)
    x, _ = inputs(DIM_B, seed=4)
    enc_p, enc_s = tree_from_numpy(params["encoder_dna"]), tree_from_numpy(state["encoder_dna"])
    k1, k2 = jax.random.split(jax.random.PRNGKey(8))
    mu, lv, new = jenc.encoder_b_apply(params["encoder_dna"], state["encoder_dna"],
                                       jnp.asarray(x), train=True, key=jax.random.PRNGKey(8))
    m1 = torch.from_numpy(np.asarray(jax.random.bernoulli(k1, 0.9, (len(x), 512)), np.float32))
    m2 = torch.from_numpy(np.asarray(jax.random.bernoulli(k2, 0.9, (len(x), 256)), np.float32))
    pmu, plv, pnew = penc.encoder_b_apply(enc_p, enc_s, torch.from_numpy(x), train=True,
                                          drop_mask1=m1, drop_mask2=m2)
    np.testing.assert_allclose(pmu.numpy(), np.asarray(mu), **CHAIN)
    np.testing.assert_allclose(plv.numpy(), np.asarray(lv), **CHAIN)
    assert set(pnew) == {"bn1", "bn2"}
    for bn in ("bn1", "bn2"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(pnew[bn][k].numpy(), np.asarray(new[bn][k]), **LAYER)
    # eval mode keeps the state; a generator draws both masks, reproducibly
    _, _, same = penc.encoder_b_apply(enc_p, enc_s, torch.from_numpy(x), train=False)
    assert same["bn1"] is enc_s["bn1"] and same["bn2"] is enc_s["bn2"]
    a = penc.encoder_b_apply(enc_p, enc_s, torch.from_numpy(x), train=True,
                             generator=torch.Generator().manual_seed(1))
    b = penc.encoder_b_apply(enc_p, enc_s, torch.from_numpy(x), train=True,
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], pmu)
    z = np.random.default_rng(0).normal(size=(9, LATENT)).astype(np.float32)
    np.testing.assert_allclose(
        pdec.decoder_a_apply(tree_from_numpy(params["decoder_rna"]), torch.from_numpy(z)).numpy(),
        np.asarray(jdec.decoder_a_apply(params["decoder_rna"], jnp.asarray(z))), **LAYER)
