"""Whole training epoch: every step of the epoch and its AdamW update in one
call (counterpart of ``vae_los_angeles_tpu/ops/pallas/fused_epoch.py``, both
directional VAEs, and of ``ops/pallas/fused_epoch_multimodal.py``, the
tri-modal VAE).

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

``dna2rna_fused_epoch`` takes the same arguments for a DNA2RNAVAE, with
``x_ep`` the DNA input, ``t_ep`` the RNA target and the two dropout masks
``drop1_ep`` (n·B, 512) and ``drop2_ep`` (n·B, 256): ``dna2rna_train_epoch``
in the same source on CUDA tensors (21 tensors in each of p, m and v, both
BatchNorms' running statistics in one buffer), `dna2rna_epoch_reference`
on CPU tensors.

``multimodal_fused_epoch(params, opt_m, opt_v, bn_state, a_ep, b_ep, site_ep,
n_sites, seed=..., beta=..., gamma=..., class_weights=..., lr=...,
weight_decay=..., step0=..., n_batches=..., eps_ep=..., dropa_ep=...,
dropb1_ep=..., dropb2_ep=...)`` does it for a MultiModalVAE: ``a_ep`` the
epoch's RNA rows and ``b_ep`` its DNA rows (each an input and a target), the
three dropout masks injected as (n·B, 128), (n·B, 512) and (n·B, 256);
`multimodal_epoch_reference` on CPU tensors. On CUDA tensors the epoch is a
CUDA graph (``multimodal_epoch_graph_*`` in the same source): captured once
for a key (device, widths, batch, n_batches, noise mode, class weights or
not) with the buffers its launches address (39 tensors in each of p, m and
v, the three BatchNorms' statistics, the rows, the noise, the class
weights, the losses, the workspace), cached, and replayed with one graph
launch an epoch. Each call copies its inputs into those buffers and its
results out of them, on the card, and the values that change between
epochs (seed, β, γ, lr, weight decay and each step's bias corrections,
`epoch_args`) from pinned memory into a small device buffer the graph
reads. A new key rebuilds the cache; a capture that fails raises, and
nothing falls back.

``launches`` counts calls of the epoch entries (a graph launch for the
tri-modal model), one an epoch.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from vae_los_angeles_torch.ops import optim
from vae_los_angeles_torch.ops.kernels import fused_train as ft

launches = {"rna2dna_train_epoch": 0, "dna2rna_train_epoch": 0, "multimodal_train_epoch": 0}


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


def _check_epoch(x_ep, n_batches):
    """Rows of the epoch, after checking that ``n_batches`` divides them
    into batches of 2 or more."""
    rows = x_ep.shape[0] if isinstance(x_ep, torch.Tensor) else 0
    if n_batches < 1 or rows % n_batches:
        raise ValueError(
            f"epoch row count {rows} not divisible by n_batches={n_batches}: rows would "
            "be silently dropped and every batch boundary shifted relative to the "
            "caller's batching"
        )
    if rows // n_batches < 2:
        raise ValueError(f"train-mode BatchNorm requires batch size > 1, got {rows // n_batches}")
    return rows


def _check_moments(order, flat_p, flat_m, flat_v, dev, seed):
    for name, _ in order:
        for tree, t in (("m", flat_m[name]), ("v", flat_v[name])):
            ft.check_tensor(f"{tree}/{name}", t, dev, torch.float32, flat_p[name].shape)
    if not 0 <= seed < 2**63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")


def rna2dna_fused_epoch(params, opt_m, opt_v, bn_state, x_ep, t_ep, site_ep, n_sites, *,
                        seed=0, beta=1e-3, lr=5e-4, weight_decay=1e-5, step0=0, n_batches,
                        eps_ep=None, drop_ep=None):
    """One epoch of ``n_batches`` AdamW steps. Returns (per-batch losses,
    new_params, new_m, new_v, new_bn_state)."""
    n_batches = int(n_batches)
    rows = _check_epoch(x_ep, n_batches)
    use_prng = ft.check_noise_args(eps_ep=eps_ep, drop_ep=drop_ep)
    flat_p, flat_m, flat_v = (ft.flatten_params(t) for t in (params, opt_m, opt_v))
    bn = bn_state["encoder_rna"]["bn"]
    dev = ft.check_step_inputs(flat_p, bn["mean"], bn["var"], x_ep, t_ep, site_ep, n_sites,
                               eps_ep, drop_ep, rows)
    seed, step0 = int(seed), int(step0)
    _check_moments(ft.PARAM_ORDER, flat_p, flat_m, flat_v, dev, seed)
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


def dna2rna_epoch_reference(flat_p, flat_m, flat_v, bn, x_ep, t_ep, site_ep, eps_ep, drop1_ep,
                            drop2_ep, *, seed, beta, lr, weight_decay, step0, n_batches):
    """Plain version: returns (losses, p, m, v, bn) with {name: tensor}
    trees and ``bn`` = (rm1, rv1, rm2, rv2)."""
    batch = x_ep.shape[0] // n_batches
    _, h1, h2, latent, *_ = ft.dims_of_d2r(flat_p)
    opt = {"step": torch.tensor(step0, dtype=torch.int32, device=x_ep.device),
           "m": dict(flat_m), "v": dict(flat_v)}
    p, losses = dict(flat_p), []
    for i in range(n_batches):
        rows = slice(i * batch, (i + 1) * batch)
        if eps_ep is None:
            eps, drop1, drop2 = ft.draw_noise_d2r(batch, latent, h1, h2, seed, i, x_ep.device)
        else:
            eps, drop1, drop2 = eps_ep[rows], drop1_ep[rows], drop2_ep[rows]
        loss, grads, bn = ft.dna2rna_train_step_reference(
            p, bn, x_ep[rows], t_ep[rows], site_ep[rows], eps, drop1, drop2, beta)
        losses.append(loss)
        p, opt = optim.adamw_update(p, grads, opt, lr, weight_decay)
    return torch.stack(losses), p, opt["m"], opt["v"], bn


def dna2rna_fused_epoch(params, opt_m, opt_v, bn_state, x_ep, t_ep, site_ep, n_sites, *,
                        seed=0, beta=1e-3, lr=5e-4, weight_decay=1e-5, step0=0, n_batches,
                        eps_ep=None, drop1_ep=None, drop2_ep=None):
    """One DNA→RNA epoch of ``n_batches`` AdamW steps; ``x_ep`` is the
    epoch's DNA input, ``t_ep`` the RNA target. Returns (per-batch losses,
    new_params, new_m, new_v, new_bn_state)."""
    n_batches = int(n_batches)
    rows = _check_epoch(x_ep, n_batches)
    use_prng = ft.check_noise_args(eps_ep=eps_ep, drop1_ep=drop1_ep, drop2_ep=drop2_ep)
    order = ft.PARAM_ORDER_D2R
    flat_p, flat_m, flat_v = (ft.flatten_params(t, order) for t in (params, opt_m, opt_v))
    bn = ft.bn_d2r(bn_state)
    dev = ft.check_d2r_inputs(flat_p, bn, x_ep, t_ep, site_ep, n_sites, eps_ep, drop1_ep,
                              drop2_ep, rows)
    seed, step0 = int(seed), int(step0)
    _check_moments(order, flat_p, flat_m, flat_v, dev, seed)
    if dev.type == "cpu":
        losses, p, m, v, bn = dna2rna_epoch_reference(
            flat_p, flat_m, flat_v, bn, x_ep, t_ep, site_ep, eps_ep, drop1_ep, drop2_ep,
            seed=seed, beta=float(beta), lr=float(lr), weight_decay=float(weight_decay),
            step0=step0, n_batches=n_batches)
    else:
        losses, p, m, v, bn = _launch_epoch_d2r(
            flat_p, flat_m, flat_v, bn, x_ep, t_ep, site_ep, (eps_ep, drop1_ep, drop2_ep),
            use_prng, seed, float(beta), float(lr), float(weight_decay), step0, n_batches)
    return (losses, ft.unflatten(p, order), ft.unflatten(m, order), ft.unflatten(v, order),
            ft.bn_d2r_tree(bn))


def _launch_epoch_d2r(flat_p, flat_m, flat_v, bn, x_ep, t_ep, site_ep, noise, use_prng, seed,
                      beta, lr, wd, step0, n_batches):
    lib = ft.library()
    order = ft.PARAM_ORDER_D2R
    dev = x_ep.device
    batch = x_ep.shape[0] // n_batches
    dims_t = ft.dims_of_d2r(flat_p)
    dims = (ctypes.c_int * 8)(*dims_t)
    p, m, v = (ft.pack(t, order) for t in (flat_p, flat_m, flat_v))
    bn_buf = torch.cat(bn)
    losses = torch.empty(n_batches, device=dev, dtype=torch.float32)
    work = torch.empty(lib.dna2rna_train_workspace_floats(dims, batch, 1), device=dev,
                       dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    noise_ptrs = (None, None, None) if use_prng else tuple(t.data_ptr() for t in noise)
    with torch.cuda.device(dev):
        err = lib.dna2rna_train_epoch(
            x_ep.data_ptr(), t_ep.data_ptr(), site_ep.data_ptr(), p.data_ptr(), m.data_ptr(),
            v.data_ptr(), dims, batch, n_batches, bn_buf.data_ptr(), *noise_ptrs,
            ft.NOISE_PHILOX if use_prng else ft.NOISE_INJECTED, seed, beta, lr, wd, step0,
            losses.data_ptr(), work.data_ptr(), stream)
    ft.raise_on(lib, err, "dna2rna_train_epoch")
    launches["dna2rna_train_epoch"] += 1
    return (losses, ft.unpack(p, flat_p, order), ft.unpack(m, flat_p, order),
            ft.unpack(v, flat_p, order), ft.split_bn(bn_buf, dims_t[1], dims_t[2]))


def multimodal_epoch_reference(flat_p, flat_m, flat_v, bn, a_ep, b_ep, site_ep, cw, noise, *,
                               seed, beta, gamma, lr, weight_decay, step0, n_batches):
    """Plain version: returns (losses, p, m, v, bn) with {name: tensor}
    trees and ``bn`` the six running statistics (``ft.bn_mm``); ``noise`` is
    (eps_ep, dropa_ep, dropb1_ep, dropb2_ep) or Nones."""
    batch = a_ep.shape[0] // n_batches
    _, _, ha, hb1, hb2, latent, *_ = ft.dims_of_mm(flat_p)
    opt = {"step": torch.tensor(step0, dtype=torch.int32, device=a_ep.device),
           "m": dict(flat_m), "v": dict(flat_v)}
    p, losses = dict(flat_p), []
    for i in range(n_batches):
        rows = slice(i * batch, (i + 1) * batch)
        if noise[0] is None:
            step_noise = ft.draw_noise_mm(batch, latent, ha, hb1, hb2, seed, i, a_ep.device)
        else:
            step_noise = tuple(t[rows] for t in noise)
        loss, grads, bn = ft.multimodal_train_step_reference(
            p, bn, a_ep[rows], b_ep[rows], site_ep[rows], cw, *step_noise, beta, gamma)
        losses.append(loss)
        p, opt = optim.adamw_update(p, grads, opt, lr, weight_decay)
    return torch.stack(losses), p, opt["m"], opt["v"], bn


def multimodal_fused_epoch(params, opt_m, opt_v, bn_state, a_ep, b_ep, site_ep, n_sites, *,
                           seed=0, beta=1e-3, gamma=1.0, class_weights=None, lr=5e-4,
                           weight_decay=1e-5, step0=0, n_batches, eps_ep=None, dropa_ep=None,
                           dropb1_ep=None, dropb2_ep=None):
    """One tri-modal epoch of ``n_batches`` AdamW steps on the epoch's RNA
    rows ``a_ep`` and DNA rows ``b_ep``. Returns (per-batch losses,
    new_params, new_m, new_v, new_bn_state)."""
    n_batches = int(n_batches)
    rows = _check_epoch(a_ep, n_batches)
    use_prng = ft.check_noise_args(eps_ep=eps_ep, dropa_ep=dropa_ep, dropb1_ep=dropb1_ep,
                                   dropb2_ep=dropb2_ep)
    order = ft.PARAM_ORDER_MM
    flat_p, flat_m, flat_v = (ft.flatten_params(t, order) for t in (params, opt_m, opt_v))
    bn = ft.bn_mm(bn_state)
    noise = (eps_ep, dropa_ep, dropb1_ep, dropb2_ep)
    dev = ft.check_mm_inputs(flat_p, bn, a_ep, b_ep, site_ep, n_sites, class_weights, noise, rows)
    seed, step0 = int(seed), int(step0)
    _check_moments(order, flat_p, flat_m, flat_v, dev, seed)
    if dev.type == "cpu":
        losses, p, m, v, bn = multimodal_epoch_reference(
            flat_p, flat_m, flat_v, bn, a_ep, b_ep, site_ep, class_weights, noise, seed=seed,
            beta=float(beta), gamma=float(gamma), lr=float(lr), weight_decay=float(weight_decay),
            step0=step0, n_batches=n_batches)
    else:
        losses, p, m, v, bn = _launch_epoch_mm(
            flat_p, flat_m, flat_v, bn, a_ep, b_ep, site_ep, class_weights, noise, use_prng, seed,
            float(beta), float(gamma), float(lr), float(weight_decay), step0, n_batches)
    return (losses, ft.unflatten(p, order), ft.unflatten(m, order), ft.unflatten(v, order),
            ft.bn_mm_tree(bn))


ADAM_B1, ADAM_B2 = float(np.float32(optim.ADAM_B1)), float(np.float32(optim.ADAM_B2))


def epoch_args(seed, beta, gamma, lr, weight_decay, step0, n_batches):
    """The tri-modal graph's epoch-args buffer, float32 (struct EpochArgs of
    ``csrc/fused_train.cu``): the seed's 64 bits, β, γ, lr, weight decay,
    then (bc1, bc2) of steps ``step0 + 1 .. step0 + n_batches``, each
    ``(float)(1 - pow((double)β_k, t))`` as the directional epochs compute
    them on the host (Python's float power is the C library's pow)."""
    out = np.empty(6 + 2 * n_batches, np.float32)
    out[:2].view(np.int64)[0] = seed
    out[2:6] = (beta, gamma, lr, weight_decay)
    steps = range(int(step0) + 1, int(step0) + n_batches + 1)
    out[6::2] = [1.0 - ADAM_B1 ** float(t) for t in steps]
    out[7::2] = [1.0 - ADAM_B2 ** float(t) for t in steps]
    return out


class _MMGraph:
    """A captured tri-modal epoch and the buffers its launches address."""

    def __init__(self, lib, dev, dims_t, batch, n_batches, injected, with_cw):
        f32 = dict(device=dev, dtype=torch.float32)
        dims = (ctypes.c_int * 12)(*dims_t)
        a, b, ha, hb1, hb2, latent, sites = dims_t[:7]
        rows = batch * n_batches
        n_params = lib.multimodal_param_count(dims)
        self.lib, self.n_batches = lib, n_batches
        self.p, self.m, self.v = (torch.empty(n_params, **f32) for _ in range(3))
        self.bn = torch.empty(2 * (ha + hb1 + hb2), **f32)
        self.a, self.b = torch.empty((rows, a), **f32), torch.empty((rows, b), **f32)
        self.site = torch.empty(rows, device=dev, dtype=torch.int64)
        self.noise = ([torch.empty((rows, w), **f32) for w in (latent, ha, hb1, hb2)]
                      if injected else None)
        self.cw = torch.empty(sites, **f32) if with_cw else None
        self.losses = torch.empty(n_batches, **f32)
        self.work = torch.empty(lib.multimodal_train_workspace_floats(dims, batch, 1), **f32)
        n_args = lib.multimodal_epoch_args_floats(n_batches)
        self.args = torch.empty(n_args, **f32)
        self.host_args = torch.empty(n_args, dtype=torch.float32, pin_memory=True)
        self.args_copied = torch.cuda.Event()  # the last copy out of host_args
        self.args_copied.record(torch.cuda.current_stream(dev))
        noise = tuple(t.data_ptr() for t in self.noise) if injected else (None,) * 4
        err = ctypes.c_int(0)
        t0 = time.perf_counter()
        self.handle = lib.multimodal_epoch_graph_create(
            self.a.data_ptr(), self.b.data_ptr(), self.site.data_ptr(), ft._ptr(self.cw),
            self.p.data_ptr(), self.m.data_ptr(), self.v.data_ptr(), dims, batch, n_batches,
            self.bn.data_ptr(), *noise, ft.NOISE_INJECTED if injected else ft.NOISE_PHILOX,
            self.args.data_ptr(), self.losses.data_ptr(), self.work.data_ptr(),
            ctypes.byref(err))
        self.capture_seconds = time.perf_counter() - t0
        ft.raise_on(lib, err.value, "multimodal_epoch_graph_create")

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.multimodal_epoch_graph_destroy(self.handle)


_mm_graph = {}  # the one cached graph: {"key": ..., "graph": _MMGraph}


def mm_graph(lib, key, *build_args):
    """The cached graph of ``key``, captured anew when the key changed."""
    if _mm_graph.get("key") != key:
        _mm_graph.clear()  # the old graph first: its buffers go with it
        _mm_graph.update(key=key, graph=_MMGraph(lib, *build_args))
    return _mm_graph["graph"]


def _launch_epoch_mm(flat_p, flat_m, flat_v, bn, a_ep, b_ep, site_ep, cw, noise, use_prng, seed,
                     beta, gamma, lr, wd, step0, n_batches):
    lib = ft.library()
    order = ft.PARAM_ORDER_MM
    dev = a_ep.device
    batch = a_ep.shape[0] // n_batches
    dims_t = ft.dims_of_mm(flat_p)
    with torch.cuda.device(dev):
        key = (dev, dims_t, batch, n_batches, not use_prng, cw is not None)
        g = mm_graph(lib, key, dev, dims_t, batch, n_batches, not use_prng, cw is not None)
        for buf, tree in ((g.p, flat_p), (g.m, flat_m), (g.v, flat_v)):
            torch.cat([tree[name].reshape(-1) for name, _ in order], out=buf)
        torch.cat(bn, out=g.bn)
        g.a.copy_(a_ep)
        g.b.copy_(b_ep)
        g.site.copy_(site_ep)
        if not use_prng:
            for buf, t in zip(g.noise, noise):
                buf.copy_(t)
        if cw is not None:
            g.cw.copy_(cw)
        g.args_copied.synchronize()  # the previous epoch's args have left the pinned buffer
        g.host_args.numpy()[:] = epoch_args(seed, beta, gamma, lr, wd, step0, n_batches)
        stream = torch.cuda.current_stream(dev)
        g.args.copy_(g.host_args, non_blocking=True)
        g.args_copied.record(stream)
        err = lib.multimodal_epoch_graph_launch(g.handle, stream.cuda_stream)
        ft.raise_on(lib, err, "multimodal_epoch_graph_launch")
        launches["multimodal_train_epoch"] += 1
        # the results leave the graph's buffers: the next epoch overwrites them
        p, m, v, bn_out = (t.clone() for t in (g.p, g.m, g.v, g.bn))
        losses = g.losses.clone()
    return (losses, ft.unpack(p, flat_p, order), ft.unpack(m, flat_p, order),
            ft.unpack(v, flat_p, order), ft.split_bn_mm(bn_out, *dims_t[2:5]))
