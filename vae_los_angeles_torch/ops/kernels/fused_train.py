"""One fused RNA2DNAVAE train step: forward and hand-derived backward
(counterpart of the rna2dna part of ``vae_los_angeles_tpu/ops/pallas/fused_train.py``).

``loss, grads, new_state = rna2dna_fused_train_step(params, state, rna, dna,
site, n_sites, seed=..., step=..., beta=..., eps=..., drop_mask=...)`` takes
the JAX package's ``(params, state)`` trees (tensors in its layout) and
returns the sum loss BCE + beta * KLD, the gradients of all 19 tensors of
`PARAM_ORDER` as a tree, and the new BatchNorm running statistics:

  * CUDA tensors: one call of ``rna2dna_train_step`` in ``csrc/fused_train.cu``
    (built at first use), which enqueues the step's phases on the current
    stream; a tensor it does not take raises, nothing falls back;
  * CPU tensors: `rna2dna_train_step_reference`, the plain PyTorch version
    of the same hand-derived arithmetic.

Noise: ``eps`` (B, latent) and ``drop_mask`` (B, 128) are injected together
or not at all (`check_noise_args`). Without them the kernel draws both from
Philox4x32-10 keyed by ``seed`` with counter (row, column, ``step``,
stream); the plain version draws from a ``torch.Generator`` seeded from
(seed, step), so the two agree only in distribution there.

``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

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

launches = {"rna2dna_train_step": 0}


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


def flatten_params(params):
    """{name: tensor} in `PARAM_ORDER` from a params tree."""
    flat = {}
    for name, path in PARAM_ORDER:
        node = params
        for p in path:
            node = node[p]
        flat[name] = node
    return flat


def unflatten(flat):
    """Params-shaped tree from {name: tensor}."""
    tree = {}
    for name, path in PARAM_ORDER:
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


def pack(flat):
    """One flat float32 buffer holding the tensors of `PARAM_ORDER` in order."""
    return torch.cat([flat[name].reshape(-1) for name, _ in PARAM_ORDER])


def unpack(buf, like):
    """Views of ``buf`` shaped like the tensors of ``like`` ({name: tensor})."""
    out, o = {}, 0
    for name, _ in PARAM_ORDER:
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


def rna2dna_train_step_reference(flat, rm, rv, x, t, site, eps, drop, beta):
    """Plain PyTorch version of the kernel, on {name: tensor} params:
    returns (loss, {name: grad}, new_rm, new_rv). The gradients are the TPU
    kernel's hand-derived ones (``fused_train.py`` ``_train_kernel``)."""
    p = flat
    batch = x.shape[0]
    a1 = x @ p["w1"] + p["b1"]
    mu_b = a1.mean(0)
    var_b = torch.square(a1 - mu_b).mean(0)
    inv_std = torch.rsqrt(var_b + BN_EPS)
    xhat = (a1 - mu_b) * inv_std
    h = xhat * p["gamma"] + p["bnbeta"]
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
    unbias = batch / max(batch - 1, 1)
    new_rm = (1.0 - BN_MOMENTUM) * rm + BN_MOMENTUM * mu_b
    new_rv = (1.0 - BN_MOMENTUM) * rv + BN_MOMENTUM * var_b * unbias

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
    dh = dd * drop / KEEP * relu_mask
    g["gamma"], g["bnbeta"] = (dh * xhat).sum(0), dh.sum(0)
    dxhat = dh * p["gamma"]
    da1 = inv_std * (dxhat - dxhat.mean(0) - xhat * (dxhat * xhat).mean(0))
    g["w1"], g["b1"] = x.T @ da1, da1.sum(0)
    return loss, {name: g[name] for name, _ in PARAM_ORDER}, new_rm, new_rv


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
    lib.rna2dna_train_step.argtypes = [p, p, p, p, p, i, p, p, p, p, p, p, i, u64, i, f, p, p, p, p]
    lib.rna2dna_train_step.restype = i
    lib.rna2dna_train_epoch.argtypes = [p, p, p, p, p, p, p, i, i, p, p, p, p, i, u64, f, f, f, ll,
                                        p, p, p]
    lib.rna2dna_train_epoch.restype = i
    lib.rna2dna_train_noise.argtypes = [u64, i, i, i, i, p, p, p]
    lib.rna2dna_train_noise.restype = i
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


def check_step_inputs(flat, rm, rv, rna, dna, site, n_sites, eps, drop, rows):
    """Validate what the kernel takes: every tensor float32 (site int64),
    contiguous, on the parameters' device, at the shapes of `dims_of`."""
    dev = flat["w1"].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    for name, _ in PARAM_ORDER:
        check_tensor(name, flat[name], dev, torch.float32, flat[name].shape)
    din, hid, latent, sites, _, _, _, dout = dims_of(flat)
    if n_sites != sites:
        raise ValueError(f"n_sites={n_sites} but the embedding table has {sites} rows")
    check_tensor("running mean", rm, dev, torch.float32, (hid,))
    check_tensor("running var", rv, dev, torch.float32, (hid,))
    check_tensor("rna", rna, dev, torch.float32, (rows, din))
    check_tensor("dna", dna, dev, torch.float32, (rows, dout))
    check_tensor("site", site, dev, torch.int64, (rows,))
    if eps is not None:
        check_tensor("eps", eps, dev, torch.float32, (rows, latent))
        check_tensor("drop_mask", drop, dev, torch.float32, (rows, hid))
    return dev


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
        loss, grads, rm, rv = _launch_step(flat, bn, rna, dna, site, eps, drop_mask, use_prng,
                                           seed, step, float(beta))
    return loss, unflatten(grads), {"encoder_rna": {"bn": {"mean": rm, "var": rv}}}


def _launch_step(flat, bn, rna, dna, site, eps, drop, use_prng, seed, step, beta):
    lib = library()
    dev = rna.device
    batch = rna.shape[0]
    dims = (ctypes.c_int * 8)(*dims_of(flat))
    params = pack(flat)
    grads = torch.empty_like(params)
    loss = torch.empty(1, device=dev, dtype=torch.float32)
    rm, rv = torch.empty_like(bn["mean"]), torch.empty_like(bn["var"])
    work = torch.empty(lib.rna2dna_train_workspace_floats(dims, batch, 0), device=dev,
                       dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.rna2dna_train_step(
            rna.data_ptr(), dna.data_ptr(), site.data_ptr(), params.data_ptr(), dims, batch,
            bn["mean"].data_ptr(), bn["var"].data_ptr(), rm.data_ptr(), rv.data_ptr(),
            None if use_prng else eps.data_ptr(), None if use_prng else drop.data_ptr(),
            NOISE_PHILOX if use_prng else NOISE_INJECTED, seed, step, beta, loss.data_ptr(),
            grads.data_ptr(), work.data_ptr(), stream)
    raise_on(lib, err, "rna2dna_train_step")
    launches["rna2dna_train_step"] += 1
    return loss[0], unpack(grads, flat), rm, rv


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
