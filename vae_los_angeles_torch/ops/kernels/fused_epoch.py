"""Whole RNA2DNAVAE training epoch: every step of the epoch and its AdamW
update in one call (counterpart of the rna2dna part of
``vae_los_angeles_tpu/ops/pallas/fused_epoch.py``).

``losses, new_params, new_m, new_v, new_bn = rna2dna_fused_epoch(params,
opt_m, opt_v, bn_state, x_ep, t_ep, site_ep, n_sites, seed=..., beta=...,
lr=..., weight_decay=..., step0=..., n_batches=..., eps_ep=..., drop_ep=...)``
runs ``n_batches`` steps over the epoch's rows, already shuffled and
concatenated (n_batches * B rows): step i is the train step of
``ops.kernels.fused_train`` on rows [i*B, (i+1)*B), then torch-order AdamW
(decay first, bias correction at the global step ``step0 + i + 1``) and the
BatchNorm running statistics.

  * CUDA tensors: one call of ``rna2dna_train_epoch`` in
    ``csrc/fused_train.cu``, which loops over the steps in C++ and keeps p, m
    and v in three flat buffers (the 19 tensors of ``PARAM_ORDER`` each) for
    the whole epoch. Python crosses into C once an epoch.
  * CPU tensors: `rna2dna_epoch_reference`, a loop of the train step's plain
    version and ``ops.optim.adamw_update``.

Noise: ``eps_ep`` (n·B, latent) and ``drop_ep`` (n·B, 128) are injected
together or not at all; without them step i draws from Philox keyed by
``seed`` with step index i (the kernel), or from the plain version's
generator for (seed, i).

``launches`` counts calls of the epoch entry, one an epoch.
"""

from __future__ import annotations

import ctypes

import torch

from vae_los_angeles_torch.ops import optim
from vae_los_angeles_torch.ops.kernels import fused_train as ft

launches = {"rna2dna_train_epoch": 0}


def rna2dna_epoch_reference(flat_p, flat_m, flat_v, rm, rv, x_ep, t_ep, site_ep, eps_ep,
                            drop_ep, *, seed, beta, lr, weight_decay, step0, n_batches):
    """Plain version: returns (losses, p, m, v, rm, rv) as {name: tensor}."""
    batch = x_ep.shape[0] // n_batches
    latent, hidden = flat_p["wmu"].shape[1], flat_p["w1"].shape[1]
    opt = {"step": torch.tensor(step0, dtype=torch.int32, device=x_ep.device),
           "m": dict(flat_m), "v": dict(flat_v)}
    p, losses = dict(flat_p), []
    for i in range(n_batches):
        rows = slice(i * batch, (i + 1) * batch)
        if eps_ep is None:
            eps, drop = ft.draw_noise(batch, latent, hidden, seed, i, x_ep.device)
        else:
            eps, drop = eps_ep[rows], drop_ep[rows]
        loss, grads, rm, rv = ft.rna2dna_train_step_reference(
            p, rm, rv, x_ep[rows], t_ep[rows], site_ep[rows], eps, drop, beta)
        losses.append(loss)
        p, opt = optim.adamw_update(p, grads, opt, lr, weight_decay)
    return torch.stack(losses), p, opt["m"], opt["v"], rm, rv


def rna2dna_fused_epoch(params, opt_m, opt_v, bn_state, x_ep, t_ep, site_ep, n_sites, *,
                        seed=0, beta=1e-3, lr=5e-4, weight_decay=1e-5, step0=0, n_batches,
                        eps_ep=None, drop_ep=None):
    """One epoch of ``n_batches`` AdamW steps. Returns (per-batch losses,
    new_params, new_m, new_v, new_bn_state)."""
    rows = x_ep.shape[0] if isinstance(x_ep, torch.Tensor) else 0
    n_batches = int(n_batches)
    if n_batches < 1 or rows % n_batches:
        raise ValueError(
            f"epoch row count {rows} not divisible by n_batches={n_batches}: rows would "
            "be silently dropped and every batch boundary shifted relative to the "
            "caller's batching"
        )
    if rows // n_batches < 2:
        raise ValueError(f"train-mode BatchNorm requires batch size > 1, got {rows // n_batches}")
    use_prng = ft.check_noise_args(eps_ep=eps_ep, drop_ep=drop_ep)
    flat_p, flat_m, flat_v = (ft.flatten_params(t) for t in (params, opt_m, opt_v))
    bn = bn_state["encoder_rna"]["bn"]
    dev = ft.check_step_inputs(flat_p, bn["mean"], bn["var"], x_ep, t_ep, site_ep, n_sites,
                               eps_ep, drop_ep, rows)
    for name, _ in ft.PARAM_ORDER:
        for tree, t in (("m", flat_m[name]), ("v", flat_v[name])):
            ft.check_tensor(f"{tree}/{name}", t, dev, torch.float32, flat_p[name].shape)
    seed, step0 = int(seed), int(step0)
    if not 0 <= seed < 2**63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    if dev.type == "cpu":
        losses, p, m, v, rm, rv = rna2dna_epoch_reference(
            flat_p, flat_m, flat_v, bn["mean"], bn["var"], x_ep, t_ep, site_ep, eps_ep, drop_ep,
            seed=seed, beta=float(beta), lr=float(lr), weight_decay=float(weight_decay),
            step0=step0, n_batches=n_batches)
    else:
        losses, p, m, v, rm, rv = _launch_epoch(flat_p, flat_m, flat_v, bn, x_ep, t_ep, site_ep,
                                                eps_ep, drop_ep, use_prng, seed, float(beta),
                                                float(lr), float(weight_decay), step0, n_batches)
    return (losses, ft.unflatten(p), ft.unflatten(m), ft.unflatten(v),
            {"encoder_rna": {"bn": {"mean": rm, "var": rv}}})


def _launch_epoch(flat_p, flat_m, flat_v, bn, x_ep, t_ep, site_ep, eps_ep, drop_ep, use_prng,
                  seed, beta, lr, wd, step0, n_batches):
    lib = ft.library()
    dev = x_ep.device
    batch = x_ep.shape[0] // n_batches
    dims = (ctypes.c_int * 8)(*ft.dims_of(flat_p))
    p, m, v = ft.pack(flat_p), ft.pack(flat_m), ft.pack(flat_v)
    rm, rv = bn["mean"].clone(), bn["var"].clone()
    losses = torch.empty(n_batches, device=dev, dtype=torch.float32)
    work = torch.empty(lib.rna2dna_train_workspace_floats(dims, batch, 1), device=dev,
                       dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.rna2dna_train_epoch(
            x_ep.data_ptr(), t_ep.data_ptr(), site_ep.data_ptr(), p.data_ptr(), m.data_ptr(),
            v.data_ptr(), dims, batch, n_batches, rm.data_ptr(), rv.data_ptr(),
            None if use_prng else eps_ep.data_ptr(), None if use_prng else drop_ep.data_ptr(),
            ft.NOISE_PHILOX if use_prng else ft.NOISE_INJECTED, seed, beta, lr, wd, step0,
            losses.data_ptr(), work.data_ptr(), stream)
    ft.raise_on(lib, err, "rna2dna_train_epoch")
    launches["rna2dna_train_epoch"] += 1
    return (losses, ft.unpack(p, flat_p), ft.unpack(m, flat_p), ft.unpack(v, flat_p), rm, rv)
