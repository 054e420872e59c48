"""One fused train step: forward and hand-derived backward (counterpart of
``vae_los_angeles_tpu/ops/pallas/fused_train.py``, both directional VAEs,
and of ``ops/pallas/fused_train_multimodal.py``, the tri-modal VAE).

``loss, grads, new_state = rna2dna_fused_train_step(params, state, rna, dna,
site, n_sites, seed=..., step=..., beta=..., eps=..., drop_mask=...)`` takes
the JAX package's ``(params, state)`` trees (tensors in its layout) and
returns the sum loss BCE + beta * KLD, the gradients of all 19 tensors of
`PARAM_ORDER` as a tree, and the new BatchNorm running statistics.
``dna2rna_fused_train_step(params, state, rna, dna, site, n_sites, seed=...,
step=..., beta=..., eps=..., drop_mask1=..., drop_mask2=...)`` does the same
for a DNA2RNAVAE (DNA in, RNA the target): MSE sum + beta * KLD, the 21
tensors of `PARAM_ORDER_D2R`, both BatchNorms' running statistics.
``multimodal_fused_train_step(params, state, a, b, site, n_sites, seed=...,
step=..., beta=..., gamma=..., class_weights=..., eps=..., drop_a=...,
drop_b1=..., drop_b2=...)`` does it for a MultiModalVAE (RNA ``a`` and DNA
``b``, each an input and a target): MSE sum + BCE sum + gamma * class-weighted
CE sum + beta * KLD, the 39 tensors of `PARAM_ORDER_MM`, the three
BatchNorms' running statistics; a site label outside [0, n_sites) raises.

  * CUDA tensors: each step is one launch of a CUDA graph of
    ``csrc/fused_train.cu`` (built at first use), captured once for a key
    (`step_graph_key`: the task, widths, batch, noise mode, class weights or
    not, device) with the buffers its phases address and cached, one graph a
    task (`step_graphs`); see "The step graphs" below. A tensor the kernels
    do not take raises; nothing falls back;
  * CPU tensors: `rna2dna_train_step_reference`,
    `dna2rna_train_step_reference` or `multimodal_train_step_reference`, the
    plain PyTorch version of the same hand-derived arithmetic.

Noise: ``eps`` (B, latent) and the dropout masks (``drop_mask`` (B, 128);
``drop_mask1`` (B, 512) and ``drop_mask2`` (B, 256); ``drop_a`` (B, 128),
``drop_b1`` (B, 512) and ``drop_b2`` (B, 256)) are injected together or not
at all (`check_noise_args`). Without them the kernel draws them from
Philox4x32-10 keyed by ``seed`` with counter (row, column, ``step``,
stream), a stream for each dropout layer and one for eps; the plain version
draws from a ``torch.Generator`` seeded from (seed, step), so the two agree
only in distribution there.

The step graphs: a call copies its inputs (the flat parameters, the
BatchNorm statistics, the rows, the injected noise, the class weights) into
the graph's buffers with one ``torch._foreach_copy_`` and the site labels
with one copy, launches the graph on the current stream with the values that
change between calls (`step_args`: the seed, β, γ and the Philox step index,
set as the arguments of the graph's first node, so no host buffer waits on
the card), and returns the loss, the gradients and the new statistics as
views of one clone of the graph's output buffer, which the next call
overwrites. Inside the graph the phases launch programmatically (PDL): each
one is scheduled while the previous one drains and fetches its first weight
tile before it waits. A capture or launch that fails raises with the CUDA
error.

``launches`` counts the kernels' launches (a step graph's launch is one).
"""

from __future__ import annotations

import ctypes
import functools
import struct
import time

import torch

from vae_los_angeles_torch.ops.kernels._build import build
from vae_los_angeles_torch.ops.nn import BN_EPS, BN_MOMENTUM

DROPOUT_RATE = 0.1
KEEP = 1.0 - DROPOUT_RATE
NOISE_INJECTED, NOISE_PHILOX = 0, 1

# Parameter layout (flat name → tree path), the order of the kernel's flat
# parameter buffer.
PARAM_ORDER = [
    ("w1", ("encoder_rna", "fc", "w")),
    ("b1", ("encoder_rna", "fc", "b")),
    ("gamma", ("encoder_rna", "bn", "gamma")),
    ("bnbeta", ("encoder_rna", "bn", "beta")),
    ("wmu", ("encoder_rna", "mu", "w")),
    ("bmu", ("encoder_rna", "mu", "b")),
    ("wlv", ("encoder_rna", "logvar", "w")),
    ("blv", ("encoder_rna", "logvar", "b")),
    ("emb", ("encoder_site", "embedding", "table")),
    ("smu_w", ("encoder_site", "mu", "w")),
    ("smu_b", ("encoder_site", "mu", "b")),
    ("slv_w", ("encoder_site", "logvar", "w")),
    ("slv_b", ("encoder_site", "logvar", "b")),
    ("d1w", ("decoder_dna", "fc1", "w")),
    ("d1b", ("decoder_dna", "fc1", "b")),
    ("d2w", ("decoder_dna", "fc2", "w")),
    ("d2b", ("decoder_dna", "fc2", "b")),
    ("d3w", ("decoder_dna", "fc3", "w")),
    ("d3b", ("decoder_dna", "fc3", "b")),
]

# DNA2RNAVAE: EncoderB's two blocks, the site posterior, DecoderA.
PARAM_ORDER_D2R = [
    ("w1", ("encoder_dna", "fc1", "w")),
    ("b1", ("encoder_dna", "fc1", "b")),
    ("gamma1", ("encoder_dna", "bn1", "gamma")),
    ("beta1", ("encoder_dna", "bn1", "beta")),
    ("w2", ("encoder_dna", "fc2", "w")),
    ("b2", ("encoder_dna", "fc2", "b")),
    ("gamma2", ("encoder_dna", "bn2", "gamma")),
    ("beta2", ("encoder_dna", "bn2", "beta")),
    ("wmu", ("encoder_dna", "mu", "w")),
    ("bmu", ("encoder_dna", "mu", "b")),
    ("wlv", ("encoder_dna", "logvar", "w")),
    ("blv", ("encoder_dna", "logvar", "b")),
    ("emb", ("encoder_site", "embedding", "table")),
    ("smu_w", ("encoder_site", "mu", "w")),
    ("smu_b", ("encoder_site", "mu", "b")),
    ("slv_w", ("encoder_site", "logvar", "w")),
    ("slv_b", ("encoder_site", "logvar", "b")),
    ("d1w", ("decoder_rna", "fc1", "w")),
    ("d1b", ("decoder_rna", "fc1", "b")),
    ("d2w", ("decoder_rna", "fc2", "w")),
    ("d2b", ("decoder_rna", "fc2", "b")),
]
BN_D2R = ("bn1", "bn2")  # EncoderB's BatchNorms, in the kernel's order

# MultiModalVAE: the 39 tensors of the JAX package's PARAM_ORDER_MM, in its
# order (EncoderA, EncoderB, EncoderC, DecoderA, DecoderB, DecoderC).
PARAM_ORDER_MM = [
    ("a_w1", ("encoder_a", "fc", "w")),
    ("a_b1", ("encoder_a", "fc", "b")),
    ("a_gamma", ("encoder_a", "bn", "gamma")),
    ("a_beta", ("encoder_a", "bn", "beta")),
    ("a_wmu", ("encoder_a", "mu", "w")),
    ("a_bmu", ("encoder_a", "mu", "b")),
    ("a_wlv", ("encoder_a", "logvar", "w")),
    ("a_blv", ("encoder_a", "logvar", "b")),
    ("b_w1", ("encoder_b", "fc1", "w")),
    ("b_b1", ("encoder_b", "fc1", "b")),
    ("b_gamma1", ("encoder_b", "bn1", "gamma")),
    ("b_beta1", ("encoder_b", "bn1", "beta")),
    ("b_w2", ("encoder_b", "fc2", "w")),
    ("b_b2", ("encoder_b", "fc2", "b")),
    ("b_gamma2", ("encoder_b", "bn2", "gamma")),
    ("b_beta2", ("encoder_b", "bn2", "beta")),
    ("b_wmu", ("encoder_b", "mu", "w")),
    ("b_bmu", ("encoder_b", "mu", "b")),
    ("b_wlv", ("encoder_b", "logvar", "w")),
    ("b_blv", ("encoder_b", "logvar", "b")),
    ("emb", ("encoder_c", "embedding", "table")),
    ("c_wmu", ("encoder_c", "mu", "w")),
    ("c_bmu", ("encoder_c", "mu", "b")),
    ("c_wlv", ("encoder_c", "logvar", "w")),
    ("c_blv", ("encoder_c", "logvar", "b")),
    ("da_w1", ("decoder_a", "fc1", "w")),
    ("da_b1", ("decoder_a", "fc1", "b")),
    ("da_w2", ("decoder_a", "fc2", "w")),
    ("da_b2", ("decoder_a", "fc2", "b")),
    ("db_w1", ("decoder_b", "fc1", "w")),
    ("db_b1", ("decoder_b", "fc1", "b")),
    ("db_w2", ("decoder_b", "fc2", "w")),
    ("db_b2", ("decoder_b", "fc2", "b")),
    ("db_w3", ("decoder_b", "fc3", "w")),
    ("db_b3", ("decoder_b", "fc3", "b")),
    ("dc_w1", ("decoder_c", "fc1", "w")),
    ("dc_b1", ("decoder_c", "fc1", "b")),
    ("dc_w2", ("decoder_c", "fc2", "w")),
    ("dc_b2", ("decoder_c", "fc2", "b")),
]
BN_MM = (("encoder_a", "bn"), ("encoder_b", "bn1"), ("encoder_b", "bn2"))  # kernel's order

launches = {"rna2dna_train_step": 0, "dna2rna_train_step": 0, "multimodal_train_step": 0}

ORDERS = {"rna2dna": PARAM_ORDER, "dna2rna": PARAM_ORDER_D2R, "multimodal": PARAM_ORDER_MM}


def check_noise_args(**named):
    """Injected noise is all-or-nothing: a partial set raises. Returns
    True when none is given (the kernel draws its own)."""
    missing = [k for k, v in named.items() if v is None]
    if missing and len(missing) != len(named):
        given = sorted(set(named) - set(missing))
        raise ValueError(
            "fused kernels take injected noise all-or-nothing: got "
            f"{given} but not {sorted(missing)} — supply every noise input "
            "(deterministic mode) or none (in-kernel Philox)"
        )
    return len(missing) == len(named)


def flatten_params(params, order=PARAM_ORDER):
    """{name: tensor} in ``order`` from a params tree."""
    flat = {}
    for name, path in order:
        node = params
        for p in path:
            node = node[p]
        flat[name] = node
    return flat


def unflatten(flat, order=PARAM_ORDER):
    """Params-shaped tree from {name: tensor}."""
    tree = {}
    for name, path in order:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = flat[name]
    return tree


def dims_of(flat):
    """(in, hidden, latent, sites, embed, d1, d2, out) of a flat tree."""
    return (flat["w1"].shape[0], flat["w1"].shape[1], flat["wmu"].shape[1],
            flat["emb"].shape[0], flat["emb"].shape[1], flat["d1w"].shape[1],
            flat["d2w"].shape[1], flat["d3w"].shape[1])


def dims_of_d2r(flat):
    """(in, h1, h2, latent, sites, embed, d1, out) of a flat DNA2RNAVAE tree."""
    return (flat["w1"].shape[0], flat["w1"].shape[1], flat["w2"].shape[1],
            flat["wmu"].shape[1], flat["emb"].shape[0], flat["emb"].shape[1],
            flat["d1w"].shape[1], flat["d2w"].shape[1])


def dims_of_mm(flat):
    """(in_a, in_b, ha, hb1, hb2, latent, sites, embed, da, db1, db2, dc) of
    a flat MultiModalVAE tree."""
    return (flat["a_w1"].shape[0], flat["b_w1"].shape[0], flat["a_w1"].shape[1],
            flat["b_w1"].shape[1], flat["b_w2"].shape[1], flat["a_wmu"].shape[1],
            flat["emb"].shape[0], flat["emb"].shape[1], flat["da_w1"].shape[1],
            flat["db_w1"].shape[1], flat["db_w2"].shape[1], flat["dc_w1"].shape[1])


DIMS_OF = {"rna2dna": dims_of, "dna2rna": dims_of_d2r, "multimodal": dims_of_mm}


def pack(flat, order=PARAM_ORDER):
    """One flat float32 buffer holding the tensors of ``order`` in order."""
    return torch.cat([flat[name].reshape(-1) for name, _ in order])


def unpack(buf, like, order=PARAM_ORDER):
    """Views of ``buf`` shaped like the tensors of ``like`` ({name: tensor})."""
    out, o = {}, 0
    for name, _ in order:
        n = like[name].numel()
        out[name] = buf[o:o + n].view(like[name].shape)
        o += n
    return out


def site_rows(table, site):
    """Embedding rows of ``site``; a label outside the table gives a zero
    row, as the TPU kernel's one-hot matmul does."""
    n = table.shape[0]
    valid = (site >= 0) & (site < n)
    return table[site.clamp(0, n - 1)] * valid[:, None].to(table.dtype)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The plain version's noise source for (seed, step)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2**63 - 1))


def draw_noise(batch, latent, hidden, seed, step, device):
    """(eps, dropout mask) from `step_generator`: the plain version's noise."""
    g = step_generator(seed, step, device)
    drop = (torch.rand((batch, hidden), generator=g, device=device) < KEEP).to(torch.float32)
    eps = torch.randn((batch, latent), generator=g, device=device)
    return eps, drop


def draw_noise_d2r(batch, latent, h1, h2, seed, step, device):
    """(eps, dropout mask 1, dropout mask 2) from `step_generator`: the plain
    version's DNA→RNA noise."""
    g = step_generator(seed, step, device)
    drop1 = (torch.rand((batch, h1), generator=g, device=device) < KEEP).to(torch.float32)
    drop2 = (torch.rand((batch, h2), generator=g, device=device) < KEEP).to(torch.float32)
    eps = torch.randn((batch, latent), generator=g, device=device)
    return eps, drop1, drop2


def draw_noise_mm(batch, latent, ha, hb1, hb2, seed, step, device):
    """(eps, drop_a, drop_b1, drop_b2) from `step_generator`: the plain
    version's tri-modal noise."""
    g = step_generator(seed, step, device)
    drops = [(torch.rand((batch, h), generator=g, device=device) < KEEP).to(torch.float32)
             for h in (ha, hb1, hb2)]
    return (torch.randn((batch, latent), generator=g, device=device), *drops)


def _bn_train_forward(a, gamma, beta):
    """Train-mode BatchNorm: (h, xhat, inv_std, batch mean, biased var)."""
    mean = a.mean(0)
    var = torch.square(a - mean).mean(0)
    inv_std = torch.rsqrt(var + BN_EPS)
    xhat = (a - mean) * inv_std
    return xhat * gamma + beta, xhat, inv_std, mean, var


def _bn_train_backward(dh, xhat, inv_std, gamma):
    """(da, dgamma, dbeta) of train-mode BatchNorm, hand-derived."""
    dxhat = dh * gamma
    da = inv_std * (dxhat - dxhat.mean(0) - xhat * (dxhat * xhat).mean(0))
    return da, (dh * xhat).sum(0), dh.sum(0)


def _running(rm, rv, mean, var, batch):
    unbias = batch / max(batch - 1, 1)
    return (1.0 - BN_MOMENTUM) * rm + BN_MOMENTUM * mean, \
        (1.0 - BN_MOMENTUM) * rv + BN_MOMENTUM * var * unbias


def rna2dna_train_step_reference(flat, rm, rv, x, t, site, eps, drop, beta):
    """Plain PyTorch version of the kernel, on {name: tensor} params:
    returns (loss, {name: grad}, new_rm, new_rv). The gradients are the TPU
    kernel's hand-derived ones (``fused_train.py`` ``_train_kernel``)."""
    p = flat
    batch = x.shape[0]
    h, xhat, inv_std, mu_b, var_b = _bn_train_forward(x @ p["w1"] + p["b1"], p["gamma"],
                                                      p["bnbeta"])
    relu_mask = (h > 0).to(h.dtype)
    d = h * relu_mask * drop / KEEP

    e = site_rows(p["emb"], site)
    mu = 0.5 * ((d @ p["wmu"] + p["bmu"]) + (e @ p["smu_w"] + p["smu_b"]))
    lv = 0.5 * ((d @ p["wlv"] + p["blv"]) + (e @ p["slv_w"] + p["slv_b"]))
    sigma = torch.exp(0.5 * lv)
    z = mu + eps * sigma
    u1 = z @ p["d1w"] + p["d1b"]
    r1 = torch.relu(u1)
    u2 = r1 @ p["d2w"] + p["d2b"]
    r2 = torch.relu(u2)
    logits = r2 @ p["d3w"] + p["d3b"]

    bce = torch.sum(torch.clamp(logits, min=0.0) - logits * t
                    + torch.log1p(torch.exp(-torch.abs(logits))))
    kld = -0.5 * torch.sum(1.0 + lv - mu * mu - torch.exp(lv))
    loss = bce + beta * kld
    new_rm, new_rv = _running(rm, rv, mu_b, var_b, batch)

    g = {}
    dlogits = torch.sigmoid(logits) - t
    g["d3w"], g["d3b"] = r2.T @ dlogits, dlogits.sum(0)
    du2 = (dlogits @ p["d3w"].T) * (u2 > 0)
    g["d2w"], g["d2b"] = r1.T @ du2, du2.sum(0)
    du1 = (du2 @ p["d2w"].T) * (u1 > 0)
    g["d1w"], g["d1b"] = z.T @ du1, du1.sum(0)
    dz = du1 @ p["d1w"].T
    dmh = 0.5 * (dz + beta * mu)
    dlh = 0.5 * (dz * eps * 0.5 * sigma + (-0.5 * beta) * (1.0 - torch.exp(lv)))
    g["wmu"], g["bmu"] = d.T @ dmh, dmh.sum(0)
    g["wlv"], g["blv"] = d.T @ dlh, dlh.sum(0)
    g["smu_w"], g["smu_b"] = e.T @ dmh, dmh.sum(0)
    g["slv_w"], g["slv_b"] = e.T @ dlh, dlh.sum(0)
    de = dmh @ p["smu_w"].T + dlh @ p["slv_w"].T
    n_sites = p["emb"].shape[0]
    valid = (site >= 0) & (site < n_sites)
    g["emb"] = torch.zeros_like(p["emb"]).index_add_(
        0, site.clamp(0, n_sites - 1), de * valid[:, None].to(de.dtype))
    dd = dmh @ p["wmu"].T + dlh @ p["wlv"].T
    da1, g["gamma"], g["bnbeta"] = _bn_train_backward(dd * drop / KEEP * relu_mask, xhat,
                                                      inv_std, p["gamma"])
    g["w1"], g["b1"] = x.T @ da1, da1.sum(0)
    return loss, {name: g[name] for name, _ in PARAM_ORDER}, new_rm, new_rv


def dna2rna_train_step_reference(flat, bn, x, t, site, eps, drop1, drop2, beta):
    """Plain PyTorch version of the DNA→RNA kernel, on {name: tensor} params
    and ``bn`` = (rm1, rv1, rm2, rv2): returns (loss, {name: grad}, new bn).
    ``x`` is the DNA input, ``t`` the RNA target. The gradients are the TPU
    kernel's hand-derived ones (``fused_train.py`` ``_d2r_train_kernel``)."""
    p = flat
    batch = x.shape[0]
    h1, xhat1, inv1, mean1, var1 = _bn_train_forward(x @ p["w1"] + p["b1"], p["gamma1"],
                                                     p["beta1"])
    rmask1 = (h1 > 0).to(h1.dtype)
    d1 = h1 * rmask1 * drop1 / KEEP
    h2, xhat2, inv2, mean2, var2 = _bn_train_forward(d1 @ p["w2"] + p["b2"], p["gamma2"],
                                                     p["beta2"])
    rmask2 = (h2 > 0).to(h2.dtype)
    d2 = h2 * rmask2 * drop2 / KEEP

    e = site_rows(p["emb"], site)
    mu = 0.5 * ((d2 @ p["wmu"] + p["bmu"]) + (e @ p["smu_w"] + p["smu_b"]))
    lv = 0.5 * ((d2 @ p["wlv"] + p["blv"]) + (e @ p["slv_w"] + p["slv_b"]))
    sigma = torch.exp(0.5 * lv)
    z = mu + eps * sigma
    u1 = z @ p["d1w"] + p["d1b"]
    rd1 = torch.relu(u1)
    diff = (rd1 @ p["d2w"] + p["d2b"]) - t

    mse = torch.sum(diff * diff)
    kld = -0.5 * torch.sum(1.0 + lv - mu * mu - torch.exp(lv))
    loss = mse + beta * kld
    rm1, rv1, rm2, rv2 = bn
    new_bn = (*_running(rm1, rv1, mean1, var1, batch), *_running(rm2, rv2, mean2, var2, batch))

    g = {}
    drecon = 2.0 * diff
    g["d2w"], g["d2b"] = rd1.T @ drecon, drecon.sum(0)
    du1 = (drecon @ p["d2w"].T) * (u1 > 0)
    g["d1w"], g["d1b"] = z.T @ du1, du1.sum(0)
    dz = du1 @ p["d1w"].T
    dmh = 0.5 * (dz + beta * mu)
    dlh = 0.5 * (dz * eps * 0.5 * sigma + (-0.5 * beta) * (1.0 - torch.exp(lv)))
    g["wmu"], g["bmu"] = d2.T @ dmh, dmh.sum(0)
    g["wlv"], g["blv"] = d2.T @ dlh, dlh.sum(0)
    g["smu_w"], g["smu_b"] = e.T @ dmh, dmh.sum(0)
    g["slv_w"], g["slv_b"] = e.T @ dlh, dlh.sum(0)
    de = dmh @ p["smu_w"].T + dlh @ p["slv_w"].T
    n_sites = p["emb"].shape[0]
    valid = (site >= 0) & (site < n_sites)
    g["emb"] = torch.zeros_like(p["emb"]).index_add_(
        0, site.clamp(0, n_sites - 1), de * valid[:, None].to(de.dtype))
    dd2 = dmh @ p["wmu"].T + dlh @ p["wlv"].T
    da2, g["gamma2"], g["beta2"] = _bn_train_backward(dd2 * drop2 / KEEP * rmask2, xhat2, inv2,
                                                      p["gamma2"])
    g["w2"], g["b2"] = d1.T @ da2, da2.sum(0)
    dd1 = da2 @ p["w2"].T
    da1, g["gamma1"], g["beta1"] = _bn_train_backward(dd1 * drop1 / KEEP * rmask1, xhat1, inv1,
                                                      p["gamma1"])
    g["w1"], g["b1"] = x.T @ da1, da1.sum(0)
    return loss, {name: g[name] for name, _ in PARAM_ORDER_D2R}, new_bn


def multimodal_train_step_reference(flat, bn, a, b, site, cw, eps, drop_a, drop_b1, drop_b2,
                                   beta, gamma):
    """Plain PyTorch version of the tri-modal kernel, on {name: tensor}
    params, ``bn`` = (a_rm, a_rv, b_rm1, b_rv1, b_rm2, b_rv2) and ``cw`` the
    class weights (n_sites,) or None: returns (loss, {name: grad}, new bn).
    The gradients are the TPU kernel's hand-derived ones
    (``fused_train_multimodal.py`` ``_mm_kernel``)."""
    p = flat
    batch = a.shape[0]
    third = 1.0 / 3.0
    ah, axhat, ainv, amean, avar = _bn_train_forward(a @ p["a_w1"] + p["a_b1"], p["a_gamma"],
                                                     p["a_beta"])
    armask = (ah > 0).to(ah.dtype)
    ad = ah * armask * drop_a / KEEP
    bh1, bxhat1, binv1, bmean1, bvar1 = _bn_train_forward(b @ p["b_w1"] + p["b_b1"],
                                                          p["b_gamma1"], p["b_beta1"])
    brmask1 = (bh1 > 0).to(bh1.dtype)
    bd1 = bh1 * brmask1 * drop_b1 / KEEP
    bh2, bxhat2, binv2, bmean2, bvar2 = _bn_train_forward(bd1 @ p["b_w2"] + p["b_b2"],
                                                          p["b_gamma2"], p["b_beta2"])
    brmask2 = (bh2 > 0).to(bh2.dtype)
    bd2 = bh2 * brmask2 * drop_b2 / KEEP
    e = p["emb"][site]
    mu = ((ad @ p["a_wmu"] + p["a_bmu"]) + (bd2 @ p["b_wmu"] + p["b_bmu"])
          + (e @ p["c_wmu"] + p["c_bmu"])) * third
    lv = ((ad @ p["a_wlv"] + p["a_blv"]) + (bd2 @ p["b_wlv"] + p["b_blv"])
          + (e @ p["c_wlv"] + p["c_blv"])) * third
    sigma = torch.exp(0.5 * lv)
    z = mu + eps * sigma

    ua = z @ p["da_w1"] + p["da_b1"]
    ra = torch.relu(ua)
    diff_a = (ra @ p["da_w2"] + p["da_b2"]) - a
    ub1 = z @ p["db_w1"] + p["db_b1"]
    rb1 = torch.relu(ub1)
    ub2 = rb1 @ p["db_w2"] + p["db_b2"]
    rb2 = torch.relu(ub2)
    logits_b = rb2 @ p["db_w3"] + p["db_b3"]
    uc = z @ p["dc_w1"] + p["dc_b1"]
    rc = torch.relu(uc)
    log_probs = torch.log_softmax(rc @ p["dc_w2"] + p["dc_b2"], dim=1)
    onehot = torch.nn.functional.one_hot(site, log_probs.shape[1]).to(log_probs.dtype)
    w_row = torch.ones_like(diff_a[:, :1]) if cw is None else cw[site][:, None]

    mse = torch.sum(diff_a * diff_a)
    bce = torch.sum(torch.clamp(logits_b, min=0.0) - logits_b * b
                    + torch.log1p(torch.exp(-torch.abs(logits_b))))
    ce = torch.sum(w_row * -torch.sum(log_probs * onehot, dim=1, keepdim=True))
    kld = -0.5 * torch.sum(1.0 + lv - mu * mu - torch.exp(lv))
    loss = mse + bce + gamma * ce + beta * kld
    a_rm, a_rv, b_rm1, b_rv1, b_rm2, b_rv2 = bn
    new_bn = (*_running(a_rm, a_rv, amean, avar, batch),
              *_running(b_rm1, b_rv1, bmean1, bvar1, batch),
              *_running(b_rm2, b_rv2, bmean2, bvar2, batch))

    g = {}
    drecon = 2.0 * diff_a
    g["da_w2"], g["da_b2"] = ra.T @ drecon, drecon.sum(0)
    dua = (drecon @ p["da_w2"].T) * (ua > 0)
    g["da_w1"], g["da_b1"] = z.T @ dua, dua.sum(0)
    dlogits_b = torch.sigmoid(logits_b) - b
    g["db_w3"], g["db_b3"] = rb2.T @ dlogits_b, dlogits_b.sum(0)
    dub2 = (dlogits_b @ p["db_w3"].T) * (ub2 > 0)
    g["db_w2"], g["db_b2"] = rb1.T @ dub2, dub2.sum(0)
    dub1 = (dub2 @ p["db_w2"].T) * (ub1 > 0)
    g["db_w1"], g["db_b1"] = z.T @ dub1, dub1.sum(0)
    dlogits_c = gamma * w_row * (torch.exp(log_probs) - onehot)
    g["dc_w2"], g["dc_b2"] = rc.T @ dlogits_c, dlogits_c.sum(0)
    duc = (dlogits_c @ p["dc_w2"].T) * (uc > 0)
    g["dc_w1"], g["dc_b1"] = z.T @ duc, duc.sum(0)
    dz = dua @ p["da_w1"].T + dub1 @ p["db_w1"].T + duc @ p["dc_w1"].T
    dmh = third * (dz + beta * mu)
    dlh = third * (dz * eps * 0.5 * sigma + (-0.5 * beta) * (1.0 - torch.exp(lv)))
    for pre, act in (("a", ad), ("b", bd2), ("c", e)):
        g[f"{pre}_wmu"], g[f"{pre}_bmu"] = act.T @ dmh, dmh.sum(0)
        g[f"{pre}_wlv"], g[f"{pre}_blv"] = act.T @ dlh, dlh.sum(0)
    g["emb"] = onehot.T @ (dmh @ p["c_wmu"].T + dlh @ p["c_wlv"].T)
    dad = dmh @ p["a_wmu"].T + dlh @ p["a_wlv"].T
    da1, g["a_gamma"], g["a_beta"] = _bn_train_backward(dad * drop_a / KEEP * armask, axhat, ainv,
                                                        p["a_gamma"])
    g["a_w1"], g["a_b1"] = a.T @ da1, da1.sum(0)
    dbd2 = dmh @ p["b_wmu"].T + dlh @ p["b_wlv"].T
    dba2, g["b_gamma2"], g["b_beta2"] = _bn_train_backward(dbd2 * drop_b2 / KEEP * brmask2, bxhat2,
                                                           binv2, p["b_gamma2"])
    g["b_w2"], g["b_b2"] = bd1.T @ dba2, dba2.sum(0)
    dba1, g["b_gamma1"], g["b_beta1"] = _bn_train_backward(
        (dba2 @ p["b_w2"].T) * drop_b1 / KEEP * brmask1, bxhat1, binv1, p["b_gamma1"])
    g["b_w1"], g["b_b1"] = b.T @ dba1, dba1.sum(0)
    return loss, {name: g[name] for name, _ in PARAM_ORDER_MM}, new_bn


@functools.lru_cache(maxsize=None)
def library():
    """libfused_train.so, built at first use, with its C signatures declared."""
    lib = build("fused_train").lib
    p, i, f, u64, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint64,
                        ctypes.c_longlong)
    lib.rna2dna_param_count.argtypes = [p]
    lib.rna2dna_param_count.restype = ll
    lib.rna2dna_train_workspace_floats.argtypes = [p, i, i]
    lib.rna2dna_train_workspace_floats.restype = ll
    lib.rna2dna_step_graph_create.argtypes = [p, p, p, p, p, i, p, p, p, p, i, p, p, p, p, i,
                                              ctypes.POINTER(ctypes.c_int)]
    lib.rna2dna_step_graph_create.restype = p
    lib.rna2dna_epoch_graph_create.argtypes = [p, p, p, p, p, p, p, i, i, p, p, p, i, p, p, p, i,
                                               ctypes.POINTER(ctypes.c_int)]
    lib.rna2dna_epoch_graph_create.restype = p
    lib.rna2dna_train_noise.argtypes = [u64, i, i, i, i, p, p, p]
    lib.rna2dna_train_noise.restype = i
    lib.dna2rna_param_count.argtypes = [p]
    lib.dna2rna_param_count.restype = ll
    lib.dna2rna_train_workspace_floats.argtypes = [p, i, i]
    lib.dna2rna_train_workspace_floats.restype = ll
    lib.dna2rna_step_graph_create.argtypes = [p, p, p, p, p, i, p, p, p, p, p, i, p, p, p, p, i,
                                              ctypes.POINTER(ctypes.c_int)]
    lib.dna2rna_step_graph_create.restype = p
    lib.dna2rna_epoch_graph_create.argtypes = [p, p, p, p, p, p, p, i, i, p, p, p, p, i, p, p, p, i,
                                               ctypes.POINTER(ctypes.c_int)]
    lib.dna2rna_epoch_graph_create.restype = p
    lib.dna2rna_train_noise.argtypes = [u64, i, i, i, i, i, p, p, p, p]
    lib.dna2rna_train_noise.restype = i
    lib.multimodal_param_count.argtypes = [p]
    lib.multimodal_param_count.restype = ll
    lib.multimodal_train_workspace_floats.argtypes = [p, i, i]
    lib.multimodal_train_workspace_floats.restype = ll
    lib.multimodal_step_graph_create.argtypes = [p, p, p, p, p, p, i, p, p, p, p, p, p, i, p, p,
                                                 p, p, i, ctypes.POINTER(ctypes.c_int)]
    lib.multimodal_step_graph_create.restype = p
    lib.multimodal_epoch_graph_create.argtypes = [p, p, p, p, p, p, p, p, i, i, p, p, p, p, p, i,
                                                  p, p, p, i, ctypes.POINTER(ctypes.c_int)]
    lib.multimodal_epoch_graph_create.restype = p
    lib.epoch_args_floats.argtypes = [i]
    lib.epoch_args_floats.restype = i
    lib.epoch_graph_launch.argtypes = [p, p]
    lib.epoch_graph_launch.restype = i
    lib.step_graph_launch.argtypes = [p, p, p]
    lib.step_graph_launch.restype = i
    lib.graph_nodes.argtypes = [p]
    lib.graph_nodes.restype = ll
    lib.graph_destroy.argtypes = [p]
    lib.graph_destroy.restype = None
    lib.multimodal_train_noise.argtypes = [u64, i, i, i, i, i, i, p, p, p, p, p]
    lib.multimodal_train_noise.restype = i
    lib.fused_train_error_string.argtypes = [i]
    lib.fused_train_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(lib, err, entry):
    if err != 0:
        msg = lib.fused_train_error_string(err).decode()
        raise RuntimeError(f"{entry} failed to launch: CUDA error {err} ({msg})")


def check_tensor(name, t, device, dtype, shape):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the parameters on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_tensors(items, device):
    """`check_tensor` over (name, tensor, dtype, shape) items in one pass; the
    first failure's own error (a wrapper takes up to 52 tensors a call, and
    the checks are most of its host time)."""
    index = -1 if device.type == "cpu" else device.index
    if not all(isinstance(t, torch.Tensor) and t.dtype is dtype and t.get_device() == index
               and t.shape == shape and t.is_contiguous() for _, t, dtype, shape in items):
        for name, t, dtype, shape in items:
            check_tensor(name, t, device, dtype, shape)


def _check_params(flat, task, n_sites):
    """The parameters' device and dims, after checking that every tensor of
    ``task`` is a float32 tensor, contiguous there, and that the table has
    ``n_sites`` rows."""
    names = [name for name, _ in ORDERS[task]]
    tensors = [flat[name] for name in names]
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        bad = next(n for n, t in zip(names, tensors) if not isinstance(t, torch.Tensor))
        raise TypeError(f"{bad} must be a torch.Tensor, got {type(flat[bad]).__name__}")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    f32 = torch.float32
    check_tensors([(n, t, f32, t.shape) for n, t in zip(names, tensors)], dev)
    if n_sites != flat["emb"].shape[0]:
        raise ValueError(f"n_sites={n_sites} but the embedding table has "
                         f"{flat['emb'].shape[0]} rows")
    return dev, DIMS_OF[task](flat)


def check_step_inputs(flat, rm, rv, rna, dna, site, n_sites, eps, drop, rows):
    """Validate what the kernel takes: every tensor float32 (site int64),
    contiguous, on the parameters' device, at the shapes of `dims_of`."""
    dev, (din, hid, latent, _, _, _, _, dout) = _check_params(flat, "rna2dna", n_sites)
    f32 = torch.float32
    items = [("running mean", rm, f32, (hid,)), ("running var", rv, f32, (hid,)),
             ("rna", rna, f32, (rows, din)), ("dna", dna, f32, (rows, dout)),
             ("site", site, torch.int64, (rows,))]
    if eps is not None:
        items += [("eps", eps, f32, (rows, latent)), ("drop_mask", drop, f32, (rows, hid))]
    check_tensors(items, dev)
    return dev


def check_d2r_inputs(flat, bn, dna, rna, site, n_sites, eps, drop1, drop2, rows):
    """`check_step_inputs` for the DNA→RNA kernel: ``bn`` is (rm1, rv1,
    rm2, rv2), ``dna`` the input, ``rna`` the target."""
    dev, (din, h1, h2, latent, _, _, _, dout) = _check_params(flat, "dna2rna", n_sites)
    f32 = torch.float32
    items = [(name, t, f32, (width,)) for name, t, width in zip(
        ("bn1 mean", "bn1 var", "bn2 mean", "bn2 var"), bn, (h1, h1, h2, h2))]
    items += [("dna", dna, f32, (rows, din)), ("rna", rna, f32, (rows, dout)),
              ("site", site, torch.int64, (rows,))]
    if eps is not None:
        items += [("eps", eps, f32, (rows, latent)), ("drop_mask1", drop1, f32, (rows, h1)),
                  ("drop_mask2", drop2, f32, (rows, h2))]
    check_tensors(items, dev)
    return dev


def bn_d2r(state):
    """(rm1, rv1, rm2, rv2) of a DNA2RNAVAE's BatchNorm state tree."""
    enc = state["encoder_dna"]
    return tuple(enc[k][s] for k in BN_D2R for s in ("mean", "var"))


def bn_d2r_tree(bn):
    """The BatchNorm state tree of (rm1, rv1, rm2, rv2)."""
    rm1, rv1, rm2, rv2 = bn
    return {"encoder_dna": {"bn1": {"mean": rm1, "var": rv1}, "bn2": {"mean": rm2, "var": rv2}}}


def rna2dna_fused_train_step(params, state, rna, dna, site, n_sites, *, seed=0, step=0,
                             beta=1e-3, eps=None, drop_mask=None):
    """One fused train step: returns (loss, grads tree, new_state)."""
    flat = flatten_params(params)
    bn = state["encoder_rna"]["bn"]
    use_prng = check_noise_args(eps=eps, drop_mask=drop_mask)
    batch = rna.shape[0] if isinstance(rna, torch.Tensor) else -1
    if batch < 2:
        raise ValueError(f"train-mode BatchNorm requires batch size > 1, got {batch}")
    dev = check_step_inputs(flat, bn["mean"], bn["var"], rna, dna, site, n_sites, eps,
                            drop_mask, batch)
    seed, step = int(seed), int(step)
    if not 0 <= seed < 2**63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    if dev.type == "cpu":
        if use_prng:
            eps, drop_mask = draw_noise(batch, flat["wmu"].shape[1], flat["w1"].shape[1], seed,
                                        step, dev)
        loss, grads, rm, rv = rna2dna_train_step_reference(flat, bn["mean"], bn["var"], rna, dna,
                                                           site, eps, drop_mask, float(beta))
    else:
        loss, grads, (rm, rv) = _run_step("rna2dna", flat, (bn["mean"], bn["var"]), (rna, dna),
                                          site, () if use_prng else (eps, drop_mask), None,
                                          seed, step, float(beta), 0.0)
    return loss, unflatten(grads), {"encoder_rna": {"bn": {"mean": rm, "var": rv}}}


def dna2rna_fused_train_step(params, state, rna, dna, site, n_sites, *, seed=0, step=0,
                             beta=1e-3, eps=None, drop_mask1=None, drop_mask2=None):
    """One fused DNA→RNA train step (DNA in, RNA the target): returns
    (loss, grads tree, new_state)."""
    flat = flatten_params(params, PARAM_ORDER_D2R)
    bn = bn_d2r(state)
    use_prng = check_noise_args(eps=eps, drop_mask1=drop_mask1, drop_mask2=drop_mask2)
    batch = dna.shape[0] if isinstance(dna, torch.Tensor) else -1
    if batch < 2:
        raise ValueError(f"train-mode BatchNorm requires batch size > 1, got {batch}")
    dev = check_d2r_inputs(flat, bn, dna, rna, site, n_sites, eps, drop_mask1, drop_mask2, batch)
    seed, step = int(seed), int(step)
    if not 0 <= seed < 2**63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    if dev.type == "cpu":
        if use_prng:
            _, h1, h2, latent, *_ = dims_of_d2r(flat)
            eps, drop_mask1, drop_mask2 = draw_noise_d2r(batch, latent, h1, h2, seed, step, dev)
        loss, grads, bn = dna2rna_train_step_reference(flat, bn, dna, rna, site, eps, drop_mask1,
                                                       drop_mask2, float(beta))
    else:
        noise = () if use_prng else (eps, drop_mask1, drop_mask2)
        loss, grads, bn = _run_step("dna2rna", flat, bn, (dna, rna), site, noise, None, seed,
                                    step, float(beta), 0.0)
    return loss, unflatten(grads, PARAM_ORDER_D2R), bn_d2r_tree(bn)


def split_bn(buf, h1, h2):
    """(rm1, rv1, rm2, rv2) views of one (2·h1 + 2·h2,) buffer."""
    return tuple(buf.split((h1, h1, h2, h2)))


def philox_noise(seed, step, batch, hidden, latent, device):
    """(eps (batch, latent), dropout mask (batch, hidden)) that the kernel
    draws at (seed, step) without injected noise: a test of its generator,
    not a path of the trainer (it counts no launch)."""
    lib = library()
    keep = torch.empty((batch, hidden), device=device, dtype=torch.float32)
    eps = torch.empty((batch, latent), device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        err = lib.rna2dna_train_noise(int(seed), int(step), batch, hidden, latent,
                                      keep.data_ptr(), eps.data_ptr(),
                                      torch.cuda.current_stream(device).cuda_stream)
    raise_on(lib, err, "rna2dna_train_noise")
    return eps, keep


def philox_noise_d2r(seed, step, batch, h1, h2, latent, device):
    """(eps (batch, latent), dropout masks (batch, h1) and (batch, h2)) that
    the DNA→RNA kernel draws at (seed, step) without injected noise: a test
    of its generator, not a path of the trainer (it counts no launch)."""
    lib = library()
    keep1 = torch.empty((batch, h1), device=device, dtype=torch.float32)
    keep2 = torch.empty((batch, h2), device=device, dtype=torch.float32)
    eps = torch.empty((batch, latent), device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        err = lib.dna2rna_train_noise(int(seed), int(step), batch, h1, h2, latent,
                                      keep1.data_ptr(), keep2.data_ptr(), eps.data_ptr(),
                                      torch.cuda.current_stream(device).cuda_stream)
    raise_on(lib, err, "dna2rna_train_noise")
    return eps, keep1, keep2


# ---- MultiModalVAE ---------------------------------------------------------

def bn_mm(state):
    """(a_rm, a_rv, b_rm1, b_rv1, b_rm2, b_rv2) of a MultiModalVAE's
    BatchNorm state tree."""
    return tuple(state[enc][bn][s] for enc, bn in BN_MM for s in ("mean", "var"))


def bn_mm_tree(bn):
    """The BatchNorm state tree of (a_rm, a_rv, b_rm1, b_rv1, b_rm2, b_rv2)."""
    a_rm, a_rv, b_rm1, b_rv1, b_rm2, b_rv2 = bn
    return {"encoder_a": {"bn": {"mean": a_rm, "var": a_rv}},
            "encoder_b": {"bn1": {"mean": b_rm1, "var": b_rv1},
                          "bn2": {"mean": b_rm2, "var": b_rv2}}}


def split_bn_mm(buf, ha, hb1, hb2):
    """The six running-statistics views of one (2·ha + 2·hb1 + 2·hb2,) buffer."""
    return tuple(buf.split((ha, ha, hb1, hb1, hb2, hb2)))


def check_sites(site, n_sites):
    """Refuse a site label outside [0, n_sites): the cross-entropy head and
    the class weights index by it. On the card this reads two numbers back."""
    if site.numel():
        lo, hi = torch.stack(torch.aminmax(site)).tolist()
        if lo < 0 or hi >= n_sites:
            raise ValueError(f"site labels must lie in [0, {n_sites}), got [{lo}, {hi}]")


def check_mm_inputs(flat, bn, a, b, site, n_sites, class_weights, noise, rows):
    """Validate what the tri-modal kernel takes: every tensor float32 (site
    int64), contiguous, on the parameters' device, at the shapes of
    `dims_of_mm`; ``noise`` is (eps, drop_a, drop_b1, drop_b2) or Nones."""
    dev, (din_a, din_b, ha, hb1, hb2, latent, *_) = _check_params(flat, "multimodal", n_sites)
    f32 = torch.float32
    items = [(name, t, f32, (width,)) for name, t, width in zip(
        ("a bn mean", "a bn var", "b bn1 mean", "b bn1 var", "b bn2 mean", "b bn2 var"), bn,
        (ha, ha, hb1, hb1, hb2, hb2))]
    items += [("a", a, f32, (rows, din_a)), ("b", b, f32, (rows, din_b)),
              ("site", site, torch.int64, (rows,))]
    if class_weights is not None:
        items.append(("class_weights", class_weights, f32, (n_sites,)))
    if noise[0] is not None:
        items += [(name, t, f32, (rows, width)) for name, t, width in zip(
            ("eps", "drop_a", "drop_b1", "drop_b2"), noise, (latent, ha, hb1, hb2))]
    check_tensors(items, dev)
    check_sites(site, n_sites)
    return dev


def multimodal_fused_train_step(params, state, a, b, site, n_sites, *, seed=0, step=0, beta=1e-3,
                                gamma=1.0, class_weights=None, eps=None, drop_a=None,
                                drop_b1=None, drop_b2=None):
    """One fused tri-modal train step (RNA ``a``, DNA ``b``, both inputs and
    targets): returns (loss, grads tree, new_state). ``class_weights`` is a
    float32 tensor (n_sites,) on the parameters' device, or None for ones."""
    flat = flatten_params(params, PARAM_ORDER_MM)
    bn = bn_mm(state)
    use_prng = check_noise_args(eps=eps, drop_a=drop_a, drop_b1=drop_b1, drop_b2=drop_b2)
    batch = a.shape[0] if isinstance(a, torch.Tensor) else -1
    if batch < 2:
        raise ValueError(f"train-mode BatchNorm requires batch size > 1, got {batch}")
    noise = (eps, drop_a, drop_b1, drop_b2)
    dev = check_mm_inputs(flat, bn, a, b, site, n_sites, class_weights, noise, batch)
    seed, step = int(seed), int(step)
    if not 0 <= seed < 2**63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    if dev.type == "cpu":
        if use_prng:
            _, _, ha, hb1, hb2, latent, *_ = dims_of_mm(flat)
            noise = draw_noise_mm(batch, latent, ha, hb1, hb2, seed, step, dev)
        loss, grads, bn = multimodal_train_step_reference(flat, bn, a, b, site, class_weights,
                                                          *noise, float(beta), float(gamma))
    else:
        loss, grads, bn = _run_step("multimodal", flat, bn, (a, b), site,
                                    () if use_prng else noise, class_weights, seed, step,
                                    float(beta), float(gamma))
    return loss, unflatten(grads, PARAM_ORDER_MM), bn_mm_tree(bn)


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---- the step graphs (RNA→DNA, DNA→RNA, tri-modal) ----------------------------

STEP_GRAPH_TASKS = ("rna2dna", "dna2rna", "multimodal")
STEP_ARGS = struct.Struct("<Q4fi4x")  # struct StepArgs of csrc/fused_train.cu


def step_args(seed, step, beta, gamma=0.0):
    """A step graph's StepArgs as bytes: the seed's 64 bits, β, γ (0 for the
    directional steps, which have none), lr and weight decay (unused, 0) as
    float32, the Philox step index as int32, 4 bytes of padding."""
    return STEP_ARGS.pack(seed, beta, gamma, 0.0, 0.0, step)


def step_graph_key(task, dev, dims_t, batch, injected, with_cw):
    """What a step graph is captured for: a call with another key captures
    anew."""
    return (task, dev, tuple(dims_t), int(batch), bool(injected), bool(with_cw))


def graph_widths(task, dims_t):
    """(BatchNorm statistics' floats, the row blocks' widths, the injected
    noise's widths) of a task's step or epoch, from its dims."""
    if task == "rna2dna":  # in, hidden, latent, sites, embed, d1, d2, out
        return 2 * dims_t[1], (dims_t[0], dims_t[7]), (dims_t[2], dims_t[1])
    if task == "dna2rna":  # in, h1, h2, latent, sites, embed, d1, out
        return 2 * (dims_t[1] + dims_t[2]), (dims_t[0], dims_t[7]), (dims_t[3], *dims_t[1:3])
    a, b, ha, hb1, hb2, latent = dims_t[:6]  # then sites, embed, da, db1, db2, dc
    return 2 * (ha + hb1 + hb2), (a, b), (latent, ha, hb1, hb2)


# task: (the C entry that captures its step, its parameter count, its workspace)
STEP_ENTRIES = {
    "rna2dna": ("rna2dna_step_graph_create", "rna2dna_param_count",
                "rna2dna_train_workspace_floats"),
    "dna2rna": ("dna2rna_step_graph_create", "dna2rna_param_count",
                "dna2rna_train_workspace_floats"),
    "multimodal": ("multimodal_step_graph_create", "multimodal_param_count",
                   "multimodal_train_workspace_floats"),
}


class _StepGraph:
    """A captured train step of one task and the buffers its launches
    address. ``sources`` are a call's inputs in copy order (the parameters,
    the BatchNorm statistics, the rows, the injected noise, the class
    weights): ``targets`` are views of the graph's input buffer shaped like
    them, and ``out_like`` the shapes of its outputs (the gradients, the
    statistics, the loss) in its output buffer. A graph serves one stream at
    a time: its buffers are the same for every launch. ``pdl=False``
    captures the phases as plain stream launches, which give the same bits
    (for tests; the wrappers capture with PDL)."""

    def __init__(self, lib, key, sources, pdl=True):
        task, dev, dims_t, batch, injected, with_cw = key
        f32 = dict(device=dev, dtype=torch.float32)
        create, count, workspace = STEP_ENTRIES[task]
        dims = (ctypes.c_int * len(dims_t))(*dims_t)
        n_params = getattr(lib, count)(dims)
        bn_floats, _, noise_widths = graph_widths(task, dims_t)
        n = len(ORDERS[task])
        n_bn = len(sources) - n - 2 - (len(noise_widths) if injected else 0) - with_cw
        self.lib = lib
        self.inp = torch.empty(sum(t.numel() for t in sources), **f32)
        self.targets = torch._C._nn.unflatten_dense_tensors(self.inp, sources)
        if sum(t.numel() for t in self.targets[:n]) != n_params:
            raise RuntimeError(f"{task}: the parameters hold other than {n_params} floats")
        bn_in, rows = self.targets[n], self.targets[n + n_bn:n + n_bn + 2]
        noise = self.targets[n + n_bn + 2:n + n_bn + 2 + len(noise_widths)] if injected else ()
        self.site = torch.empty(batch, device=dev, dtype=torch.int64)
        self.out = torch.empty(n_params + bn_floats + 1, **f32)
        self.out_like = self.targets[:n + n_bn] + (torch.empty((), **f32),)
        self.work = torch.empty(getattr(lib, workspace)(dims, batch, 0), **f32)
        self.args = torch.empty(STEP_ARGS.size // 4, **f32)
        noise_ptrs = [t.data_ptr() for t in noise] if injected else [None] * len(noise_widths)
        cw = (self.targets[-1].data_ptr() if with_cw else None,) if task == "multimodal" else ()
        err = ctypes.c_int(0)
        t0 = time.perf_counter()
        self.handle = getattr(lib, create)(
            rows[0].data_ptr(), rows[1].data_ptr(), self.site.data_ptr(), *cw,
            self.inp.data_ptr(), dims, batch, bn_in.data_ptr(), self.out[n_params].data_ptr(),
            *noise_ptrs, NOISE_INJECTED if injected else NOISE_PHILOX, self.args.data_ptr(),
            self.out[-1].data_ptr(), self.out.data_ptr(), self.work.data_ptr(), int(pdl),
            ctypes.byref(err))
        self.capture_seconds = time.perf_counter() - t0
        raise_on(lib, err.value, create)
        self.nodes = lib.graph_nodes(self.handle)

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.graph_destroy(self.handle)


def check_shapes(order, sources, targets):
    """Each parameter of a call (``sources``, in ``order``) at the shape of its
    view in the step graph's buffer (``targets``, shaped at capture like the
    first call's, whose sum `_StepGraph` holds to the parameter count):
    ``_foreach_copy_`` would broadcast a smaller tensor into it. The wrappers
    check the other inputs against the dims."""
    bad = [(name, s, t) for (name, _), s, t in zip(order, sources, targets) if s.shape != t.shape]
    if bad:
        name, s, t = bad[0]
        raise ValueError(f"{name} must have shape {tuple(t.shape)}, got {tuple(s.shape)}")


step_graphs = {}  # task: (key, _StepGraph), one cached graph a task


def cached_graph(cache, task, key, build):
    """The graph of ``task`` in ``cache`` for ``key``; when the key changed,
    the task's old graph is freed first (its buffers go with it) and
    ``build()`` captures the new one. The other tasks' graphs stay."""
    if cache.get(task, (None,))[0] != key:
        cache.pop(task, None)  # no reference to it is left here: it is freed now
        cache[task] = (key, build())
    return cache[task][1]


def _run_step(task, flat, bn, rows, site, noise, cw, seed, step, beta, gamma):
    """One step of ``task`` through its cached graph: the inputs copied into
    the graph's buffers (``noise`` empty in Philox mode, ``cw`` the class
    weights or None), one graph launch with `step_args`, and (loss, {name:
    grad}, BatchNorm statistics) as views of one clone of the graph's
    outputs, which the next call overwrites."""
    if not -2**31 <= step < 2**31:
        raise ValueError(f"step must fit in 32 bits, got {step}")
    lib = library()
    dev = site.device
    order = ORDERS[task]
    sources = [flat[name] for name, _ in order] + list(bn) + list(rows) + list(noise)
    if cw is not None:
        sources.append(cw)
    with torch.cuda.device(dev):
        key = step_graph_key(task, dev, DIMS_OF[task](flat), site.shape[0], bool(noise),
                             cw is not None)
        g = cached_graph(step_graphs, task, key, lambda: _StepGraph(lib, key, sources))
        check_shapes(order, sources, g.targets)
        torch._foreach_copy_(g.targets, sources)
        g.site.copy_(site)
        err = lib.step_graph_launch(g.handle, step_args(seed, step, beta, gamma),
                                    torch.cuda.current_stream(dev).cuda_stream)
        raise_on(lib, err, "step_graph_launch")
        launches[f"{task}_train_step"] += 1
        out = torch._C._nn.unflatten_dense_tensors(g.out.clone(), g.out_like)
    n = len(order)
    return out[-1], {name: t for (name, _), t in zip(order, out)}, tuple(out[n:-1])


def philox_noise_mm(seed, step, batch, ha, hb1, hb2, latent, device):
    """(eps (batch, latent), dropout masks (batch, ha), (batch, hb1),
    (batch, hb2)) that the tri-modal kernel draws at (seed, step) without
    injected noise: a test of its generator, not a path of the trainer (it
    counts no launch)."""
    lib = library()
    keeps = [torch.empty((batch, h), device=device, dtype=torch.float32) for h in (ha, hb1, hb2)]
    eps = torch.empty((batch, latent), device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        err = lib.multimodal_train_noise(int(seed), int(step), batch, ha, hb1, hb2, latent,
                                         *(k.data_ptr() for k in keeps), eps.data_ptr(),
                                         torch.cuda.current_stream(device).cuda_stream)
    raise_on(lib, err, "multimodal_train_noise")
    return (eps, *keeps)
