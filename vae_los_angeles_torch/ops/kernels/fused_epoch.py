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

  * CUDA tensors: one launch of a CUDA graph of ``csrc/fused_train.cu``
    (``rna2dna_epoch_graph_create``) that holds every step's phases and its
    AdamW update over p, m and v in three flat buffers (the 19 tensors of
    ``PARAM_ORDER`` each); see "The graphs" below.
  * CPU tensors: `rna2dna_epoch_reference`, a loop of the train step's plain
    version and ``ops.optim.adamw_update``.

Noise: ``eps_ep`` (n·B, latent) and ``drop_ep`` (n·B, 128) are injected
together or not at all; without them step i draws from Philox keyed by
``seed`` with step index i (the kernel), or from the plain version's
generator for (seed, i).

``dna2rna_fused_epoch`` takes the same arguments for a DNA2RNAVAE, with
``x_ep`` the DNA input, ``t_ep`` the RNA target and the two dropout masks
``drop1_ep`` (n·B, 512) and ``drop2_ep`` (n·B, 256): a graph of
``dna2rna_epoch_graph_create`` on CUDA tensors (21 tensors in each of p, m
and v, both BatchNorms' running statistics in one buffer),
`dna2rna_epoch_reference` on CPU tensors.

``multimodal_fused_epoch(params, opt_m, opt_v, bn_state, a_ep, b_ep, site_ep,
n_sites, seed=..., beta=..., gamma=..., class_weights=..., lr=...,
weight_decay=..., step0=..., n_batches=..., eps_ep=..., dropa_ep=...,
dropb1_ep=..., dropb2_ep=...)`` does it for a MultiModalVAE: ``a_ep`` the
epoch's RNA rows and ``b_ep`` its DNA rows (each an input and a target), the
three dropout masks injected as (n·B, 128), (n·B, 512) and (n·B, 256);
`multimodal_epoch_reference` on CPU tensors, a graph of
``multimodal_epoch_graph_create`` (39 tensors in each of p, m and v, the
three BatchNorms' statistics, the class weights) on CUDA tensors.

The graphs: each task's epoch is captured once for a key (device, widths,
batch, n_batches, noise mode, class weights or not) with the buffers its
launches address (p, m, v, the BatchNorm statistics, the rows, the noise,
the class weights, the losses, the workspace), cached, one graph a task
(`epoch_graph`), and replayed with one graph launch an epoch. Each call
copies its inputs into those buffers and its results out of them, on the
card, and the values that change between epochs (seed, β, γ, lr, weight
decay and each step's bias corrections, `epoch_args`) from pinned memory
into a small device buffer the graph reads. A new key for a task frees that
task's graph and captures anew; the other tasks' graphs stay, so runs that
alternate the tasks capture nothing more. A capture or launch that fails
raises with the CUDA error, and nothing falls back. The tri-modal epoch's
phases launch programmatically (PDL), each scheduled while the previous one
drains; the directional epochs' launch plainly (`_EpochGraph`).

``launches`` counts the epochs' graph launches, one an epoch.
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
    order = ft.PARAM_ORDER
    dims_t = ft.dims_of(flat_p)
    noise = () if use_prng else (eps_ep, drop_ep)
    losses, p, m, v, bn_out = _run_graph(
        "rna2dna", dims_t, (flat_p, flat_m, flat_v), order, (bn["mean"], bn["var"]),
        (x_ep, t_ep), site_ep, noise, None, (seed, beta, 0.0, lr, wd, step0, n_batches))
    rm, rv = bn_out.split(dims_t[1])
    return (losses, ft.unpack(p, flat_p, order), ft.unpack(m, flat_p, order),
            ft.unpack(v, flat_p, order), rm, rv)


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
    order = ft.PARAM_ORDER_D2R
    dims_t = ft.dims_of_d2r(flat_p)
    losses, p, m, v, bn_out = _run_graph(
        "dna2rna", dims_t, (flat_p, flat_m, flat_v), order, bn, (x_ep, t_ep), site_ep,
        () if use_prng else noise, None, (seed, beta, 0.0, lr, wd, step0, n_batches))
    return (losses, ft.unpack(p, flat_p, order), ft.unpack(m, flat_p, order),
            ft.unpack(v, flat_p, order), ft.split_bn(bn_out, dims_t[1], dims_t[2]))


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
    """An epoch graph's epoch-args buffer, float32 (struct EpochArgs of
    ``csrc/fused_train.cu``): the seed's 64 bits, β, γ (0 for the
    directional tasks, which have none), lr, weight decay, then (bc1, bc2)
    of steps ``step0 + 1 .. step0 + n_batches``, each ``(float)(1 -
    pow((double)β_k, t))``, the bits the directional epochs' host loops
    computed (Python's float power is the C library's pow)."""
    out = np.empty(6 + 2 * n_batches, np.float32)
    out[:2].view(np.int64)[0] = seed
    out[2:6] = (beta, gamma, lr, weight_decay)
    steps = range(int(step0) + 1, int(step0) + n_batches + 1)
    out[6::2] = [1.0 - ADAM_B1 ** float(t) for t in steps]
    out[7::2] = [1.0 - ADAM_B2 ** float(t) for t in steps]
    return out


# task: (the C entry that captures its epoch, its parameter count, its workspace)
GRAPH_ENTRIES = {
    "rna2dna": ("rna2dna_epoch_graph_create", "rna2dna_param_count",
                "rna2dna_train_workspace_floats"),
    "dna2rna": ("dna2rna_epoch_graph_create", "dna2rna_param_count",
                "dna2rna_train_workspace_floats"),
    "multimodal": ("multimodal_epoch_graph_create", "multimodal_param_count",
                   "multimodal_train_workspace_floats"),
}


class _EpochGraph:
    """A captured epoch of one task and the buffers its launches address.
    ``pdl``: whether the phases launch programmatically; by default the
    tri-modal epoch's do and the directional epochs' launch plainly (on the
    H100 PDL took the tri-modal epoch 4-6% below plain launches and the
    directional ones 1-3% above; ``python3 chip_probes.py pdl``, PERF.md).
    Both give the same bits."""

    def __init__(self, lib, task, dev, dims_t, batch, n_batches, injected, with_cw, pdl=None):
        if pdl is None:
            pdl = task == "multimodal"
        f32 = dict(device=dev, dtype=torch.float32)
        create, count, workspace = GRAPH_ENTRIES[task]
        dims = (ctypes.c_int * len(dims_t))(*dims_t)
        rows = batch * n_batches
        bn_floats, row_widths, noise_widths = ft.graph_widths(task, dims_t)
        n_params = getattr(lib, count)(dims)
        self.lib, self.n_batches = lib, n_batches
        self.p, self.m, self.v = (torch.empty(n_params, **f32) for _ in range(3))
        self.bn = torch.empty(bn_floats, **f32)
        self.rows = [torch.empty((rows, w), **f32) for w in row_widths]
        self.site = torch.empty(rows, device=dev, dtype=torch.int64)
        self.noise = [torch.empty((rows, w), **f32) for w in noise_widths] if injected else []
        self.cw = torch.empty(dims_t[6], **f32) if with_cw else None
        self.losses = torch.empty(n_batches, **f32)
        self.work = torch.empty(getattr(lib, workspace)(dims, batch, 1), **f32)
        n_args = lib.epoch_args_floats(n_batches)
        self.args = torch.empty(n_args, **f32)
        self.host_args = torch.empty(n_args, dtype=torch.float32, pin_memory=True)
        self.args_copied = torch.cuda.Event()  # the last copy out of host_args
        self.args_copied.record(torch.cuda.current_stream(dev))
        noise = ([t.data_ptr() for t in self.noise] if injected
                 else [None] * len(noise_widths))
        cw = (ft._ptr(self.cw),) if task == "multimodal" else ()
        err = ctypes.c_int(0)
        t0 = time.perf_counter()
        self.handle = getattr(lib, create)(
            *(t.data_ptr() for t in self.rows), self.site.data_ptr(), *cw, self.p.data_ptr(),
            self.m.data_ptr(), self.v.data_ptr(), dims, batch, n_batches, self.bn.data_ptr(),
            *noise, ft.NOISE_INJECTED if injected else ft.NOISE_PHILOX, self.args.data_ptr(),
            self.losses.data_ptr(), self.work.data_ptr(), int(pdl), ctypes.byref(err))
        self.capture_seconds = time.perf_counter() - t0
        ft.raise_on(lib, err.value, create)
        self.launches_per_step = lib.graph_nodes(self.handle) / n_batches

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.graph_destroy(self.handle)


graphs = {}  # task: (key, _EpochGraph), one cached graph a task


def epoch_graph(task, key, build):
    """The cached graph of ``task`` for ``key`` (`ft.cached_graph`)."""
    return ft.cached_graph(graphs, task, key, build)


def _run_graph(task, dims_t, trees, order, bn, rows, site, noise, cw, args):
    """One epoch of ``task`` through its cached graph: the inputs copied into
    the graph's buffers (``noise`` empty in Philox mode, ``cw`` the class
    weights or None), one graph launch with the epoch args ``args`` (seed, β,
    γ, lr, weight decay, step0, n_batches), and the results (losses, p, m, v,
    bn) cloned out of the buffers, which the next epoch overwrites."""
    lib = ft.library()
    dev = rows[0].device
    n_batches = args[-1]
    batch = rows[0].shape[0] // n_batches
    with torch.cuda.device(dev):
        key = (dev, dims_t, batch, n_batches, bool(noise), cw is not None)
        g = epoch_graph(task, key, lambda: _EpochGraph(lib, task, *key))
        for buf, tree in zip((g.p, g.m, g.v), trees):
            torch.cat([tree[name].reshape(-1) for name, _ in order], out=buf)
        torch.cat(bn, out=g.bn)
        for buf, t in zip(g.rows + g.noise, rows + tuple(noise)):
            buf.copy_(t)
        g.site.copy_(site)
        if cw is not None:
            g.cw.copy_(cw)
        g.args_copied.synchronize()  # the previous epoch's args have left the pinned buffer
        g.host_args.numpy()[:] = epoch_args(*args)
        stream = torch.cuda.current_stream(dev)
        g.args.copy_(g.host_args, non_blocking=True)
        g.args_copied.record(stream)
        err = lib.epoch_graph_launch(g.handle, stream.cuda_stream)
        ft.raise_on(lib, err, "epoch_graph_launch")
        launches[f"{task}_train_epoch"] += 1
        return tuple(t.clone() for t in (g.losses, g.p, g.m, g.v, g.bn))


def _launch_epoch_mm(flat_p, flat_m, flat_v, bn, a_ep, b_ep, site_ep, cw, noise, use_prng, seed,
                     beta, gamma, lr, wd, step0, n_batches):
    order = ft.PARAM_ORDER_MM
    dims_t = ft.dims_of_mm(flat_p)
    losses, p, m, v, bn_out = _run_graph(
        "multimodal", dims_t, (flat_p, flat_m, flat_v), order, bn, (a_ep, b_ep), site_ep,
        () if use_prng else noise, cw, (seed, beta, gamma, lr, wd, step0, n_batches))
    return (losses, ft.unpack(p, flat_p, order), ft.unpack(m, flat_p, order),
            ft.unpack(v, flat_p, order), ft.split_bn_mm(bn_out, *dims_t[2:5]))
