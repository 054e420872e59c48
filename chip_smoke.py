"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. require a CUDA device, check that TF32 is off, print the card's name
     and power limit;
  2. build every hand-written kernel (``vae_los_angeles_torch/csrc``, one
     nvcc per source, all started together) from this checkout, printing the
     build time and ptxas's registers and spills;
  3. hold each kernel against its plain PyTorch version on the card at the
     full model width (RNA 1177, DNA 1211, latent 20, 24 sites, embedding 32):
       * the serving forwards at B in {1, 37, 205, 4096}, with and without a
         site, z = mu and injected eps, atol = rtol = 1e-4, then their Philox
         mode statistically;
       * the train step at B in {32, 7, 256} with injected noise: loss rtol
         1e-5, the 19 gradients atol 5e-4 + rtol 1e-4, BN stats atol 1e-5;
       * the epoch over 25 steps of 32 rows with injected noise: per-step
         losses rtol 1e-5, params and AdamW m atol 2e-5, BN var atol 2e-4;
         the encoder fc bias and the BN running mean at 2·lr per step
         (0.025): their true gradient through train-mode BatchNorm is zero,
         so each implementation's fp32 cancellation noise becomes Adam steps
         of up to lr in its own direction (the JAX test allows 5e-3 at 20
         steps of small, centred inputs; at the full width it does not hold);
       * the step's and the epoch's inputs are drawn (seed after seed) so
         that no ReLU pre-activation lies near its kink
         (`relu_margins`, float64, relative to the layer's
         largest): 5e-6 for the BN'd encoder units, 5e-7 for the decoder's,
         about 3x the fp32 differences measured there. Nearer, two fp32
         implementations can take different sides and their gradients differ
         by a whole term (seen at B = 32: one flipped unit moved d2w by 0.17);
       * the loss pair at B in {32, 205}: value rtol 1e-5, gradients
         rtol 1e-5 + atol 1e-7;
       * the training kernels' Philox noise: the same seed gives the same
         draws, another seed others, the dropout keep rate is 0.9 ± 0.005
         over 2.6e5 draws, eps has mean 0 ± 0.01 and variance 1 ± 0.02, and
         a Philox step equals the injected step given its own draws;
  4. train end to end: ``run_training`` (rna2dna, USE_PALLAS, the card) on
     the 1024-sample synthetic cohort, 3 epochs of 25 steps, the epoch
     kernel once an epoch; then one epoch each of ``engine.fit``'s
     train-step path and plain path (the loss kernels' backward);
  5. serve: ``compare_directional_imputation.main`` on the same cohort's
     validation split, with the RNA2DNAVAE trained in phase 4 and a seeded
     DNA2RNAVAE, the served posterior held against the unfused modules;
  6. time with CUDA events, alternating plain, kernel, kernel, plain: the
     serving call at B = 205, the train step at B = 32, one 200-step epoch
     on the 8000-sample cohort, the loss pair, and ``torch.optim.AdamW``
     (fused) over the same 19 tensors as the yardstick of the epoch's AdamW;
     one profiled epoch (``torch.profiler``): device time by kernel, the
     device's busy and idle shares; and ``engine.fit``'s epoch time and
     samples/s through the epoch kernel at the 1024- and 8000-sample
     cohorts, validation included.

Each path (serve, train, train-step, train-plain) is driven with every
launch count set to 0 just before it and read just after. The line before
the last is the kernels' JSON record (times beside bounds computed from
this run's shapes), the last line ``{"ok": true, "device": {...}}``. Work
files go to a temporary directory.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vae_los_angeles_torch import device as device_policy
from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.splits import train_val_indices
from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
from vae_los_angeles_torch.evaluation import compare_directional_imputation
from vae_los_angeles_torch.evaluation.loading import load_dna2rna, load_rna2dna
from vae_los_angeles_torch.models import DNA2RNAVAE, RNA2DNAVAE
from vae_los_angeles_torch.models.directional_vae import rna2dna_vae_init
from vae_los_angeles_torch.ops.kernels import _build
from vae_los_angeles_torch.ops.kernels import fused_epoch as fe
from vae_los_angeles_torch.ops.kernels import fused_loss as fl
from vae_los_angeles_torch.ops.kernels import fused_train as ft
from vae_los_angeles_torch.ops.kernels import fused_vae as fv
from vae_los_angeles_torch.ops import optim
from vae_los_angeles_torch.ops.nn import reset_parameters
from vae_los_angeles_torch.training import checkpoint, engine
from vae_los_angeles_torch.training.cli import run_training
from vae_los_angeles_torch.utils.weights import jax_from_state_dict, state_dict_from_jax

CFG = Config()  # the live widths: RNA 1177, DNA 1211, latent 20, site embedding 32
N_SITES = 24
TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 on both sides, different summation order
GRAD = dict(atol=5e-4, rtol=1e-4)
BATCHES = (1, 37, 205, 4096)
STEP_BATCHES = (32, 7, 256)
LOSS_BATCHES = (32, 205)
EPOCH_STEPS = 25
LR, WD, BETA = 5e-4, 1e-5, 1e-3
PEAK_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SOURCES = ("fused_vae", "fused_train", "fused_loss")
KERNELS = {
    # name: (wrapper, model, checkpoint name, input width, TPU kernel it replaces)
    "rna2dna_fused_forward": (
        fv.FusedRNA2DNA, RNA2DNAVAE, "rna2dna", CFG.input_dim_a,
        "vae_los_angeles_tpu/ops/pallas/fused_vae.py:156",
    ),
    "dna2rna_fused_forward": (
        fv.FusedDNA2RNA, DNA2RNAVAE, "dna2rna", CFG.input_dim_b,
        "vae_los_angeles_tpu/ops/pallas/fused_vae.py:231",
    ),
}
TRAIN_KERNELS = {
    # name: (source, TPU kernel it replaces, launch counter)
    "rna2dna_train_step": ("vae_los_angeles_torch/csrc/fused_train.cu",
                           "vae_los_angeles_tpu/ops/pallas/fused_train.py:233", ft.launches),
    "rna2dna_train_epoch": ("vae_los_angeles_torch/csrc/fused_train.cu",
                            "vae_los_angeles_tpu/ops/pallas/fused_epoch.py:278", fe.launches),
    "rna2dna_loss_forward": ("vae_los_angeles_torch/csrc/fused_loss.cu",
                             "vae_los_angeles_tpu/ops/pallas/fused_loss.py:77", fl.launches),
    "rna2dna_loss_backward": ("vae_los_angeles_torch/csrc/fused_loss.cu",
                              "vae_los_angeles_tpu/ops/pallas/fused_loss.py:95", fl.launches),
}


def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def zero_counts():
    for cls, *_ in KERNELS.values():
        cls.launches = 0
    for counter in (ft.launches, fe.launches, fl.launches):
        for k in counter:
            counter[k] = 0


def read_counts():
    out = {name: spec[0].launches for name, spec in KERNELS.items()}
    out.update({name: spec[2][name] for name, spec in TRAIN_KERNELS.items()})
    return out


def port_model(model_cls, seed, perturb_bn):
    """A seeded port-initialised model (CPU, eval); ``perturb_bn`` moves the
    BN running stats off their defaults so the folding is exercised."""
    g = torch.Generator().manual_seed(seed)
    model = reset_parameters(
        model_cls(CFG.input_dim_a, CFG.input_dim_b, N_SITES, CFG.latent_dim, CFG.embed_dim), g
    ).eval()
    if perturb_bn:
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm1d):
                    m.running_mean.uniform_(-0.5, 0.5, generator=g)
                    m.running_var.uniform_(0.5, 1.5, generator=g)
                    m.weight.uniform_(0.5, 1.5, generator=g)
                    m.bias.uniform_(-0.2, 0.2, generator=g)
    return model


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a call's work, from its
# shapes (fp32 FMA = 2 operations, every other elementwise operation 1; each
# input read once, each output written once)

def serving_work(name, batch):
    l, e, s = CFG.latent_dim, CFG.embed_dim, N_SITES
    if name == "rna2dna_fused_forward":
        din, dout = CFG.input_dim_a, CFG.input_dim_b
        macs = din * 128 + 2 * 128 * l + 2 * e * l + l * 256 + 256 * 512 + 512 * dout
    else:
        din, dout = CFG.input_dim_b, CFG.input_dim_a
        macs = din * 512 + 512 * 256 + 2 * 256 * l + 2 * e * l + l * 128 + 128 * dout
    weights = macs + s * e  # every weight read once, biases are rounding
    return 2 * macs * batch, 4 * (weights + batch * (din + dout + 2 * l + 1))


def step_macs():
    """Multiply-adds of the forward products of one RNA2DNAVAE row."""
    l, e = CFG.latent_dim, CFG.embed_dim
    first = CFG.input_dim_a * 128
    return first, first + 2 * 128 * l + 2 * e * l + l * 256 + 256 * 512 + 512 * CFG.input_dim_b


def n_params():
    return sum(v.numel() for v in ft.flatten_params(
        rna2dna_vae_init(torch.Generator().manual_seed(0), CFG.input_dim_a, CFG.input_dim_b,
                         N_SITES, CFG.latent_dim, CFG.embed_dim, "meta")[0]).values())


def step_work(batch):
    first, macs = step_macs()
    # forward, dW of every layer, dX of every layer but the first
    flops = 2 * batch * (macs + macs + (macs - first))
    flops += 30 * batch * (128 + CFG.input_dim_b + 2 * CFG.latent_dim)  # BN, loss, masks
    p = n_params()
    rows = batch * (CFG.input_dim_a + CFG.input_dim_b + 1 + CFG.latent_dim + 128)
    return flops, 4 * (2 * p + rows + 4 * 128 + 1)  # params in, grads out, rows, BN, loss


def epoch_work(n_steps, batch):
    flops, _ = step_work(batch)
    p = n_params()
    rows = n_steps * batch * (CFG.input_dim_a + CFG.input_dim_b + 1)
    return n_steps * (flops + 14 * p), 4 * (6 * p + rows + 4 * 128 + n_steps)


def loss_work(batch, backward):
    n, nl = batch * CFG.input_dim_b, batch * CFG.latent_dim
    if backward:
        return 5 * n + 6 * nl, 4 * (3 * n + 4 * nl + 2)
    return 6 * n + 6 * nl, 4 * (2 * n + 2 * nl + 3)


def bound(work):
    flops, nbytes = work
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 3: compare

def compare_serving(dev):
    """Serving kernels vs plain versions; returns {name: max_abs_err}."""
    errs = {}
    for k, (name, (cls, model_cls, ckpt, din, _)) in enumerate(KERNELS.items()):
        params, state = jax_from_state_dict(port_model(model_cls, 100 + k, True).state_dict(), ckpt)
        fused = cls(params, state, dev)
        g = torch.Generator(device=dev).manual_seed(200 + k)
        worst = 0.0
        for batch in BATCHES:
            x = torch.rand((batch, din), generator=g, device=dev) * 4.0
            site = torch.randint(0, N_SITES, (batch,), generator=g, device=dev)
            eps = torch.randn((batch, CFG.latent_dim), generator=g, device=dev)
            for s in (None, site):
                for noise, e in ((fv.NOISE_NONE, None), (fv.NOISE_EPS, eps)):
                    got = fused(x, s, use_noise=e is not None, eps=e)
                    want = cls._reference(fused.folded, x, s, noise, e, 0)
                    torch.cuda.synchronize()
                    for out_name, a, b in zip(("recon", "mu", "logvar"), got, want):
                        if a.shape != b.shape or not torch.isfinite(a).all():
                            raise AssertionError(f"{name} B={batch}: bad {out_name}")
                        err = (a - b).abs().max().item()
                        worst = max(worst, err)
                        if not torch.allclose(a, b, **TOL):
                            raise AssertionError(
                                f"{name} B={batch} site={s is not None} noise={noise}: "
                                f"{out_name} differs from the plain version by {err:.3g}"
                            )
        # Philox: reproducible per seed, distinct across seeds, centred on z = mu
        x = torch.rand((256, din), generator=g, device=dev) * 4.0
        site = torch.randint(0, N_SITES, (256,), generator=g, device=dev)
        det = fused(x, site, use_noise=False)[0]
        draws = torch.stack([fused(x, site, seed=s)[0] for s in range(8)])
        again = fused(x, site, seed=0)[0]
        torch.cuda.synchronize()
        if not torch.equal(draws[0], again):
            raise AssertionError(f"{name}: the same seed gave different outputs")
        if torch.equal(draws[0], draws[1]):
            raise AssertionError(f"{name}: different seeds gave the same output")
        err_mean = (draws.mean(0) - det).abs().mean().item()
        err_one = (draws[0] - det).abs().mean().item()
        if not err_mean < err_one:
            raise AssertionError(f"{name}: mean over seeds is not nearer z = mu ({err_mean} >= {err_one})")
        if cls is fv.FusedRNA2DNA and not bool(((draws >= 0) & (draws <= 1)).all()):
            raise AssertionError(f"{name}: recon outside [0, 1]")
        errs[name] = worst
        say(f"[compare] {name}: max |kernel - plain| = {worst:.3e} over B={BATCHES}, "
            f"site on/off, noise none/eps (atol=rtol=1e-4); Philox: reproducible, "
            f"seed-dependent, mean-over-8-seeds error {err_mean:.4f} < one draw {err_one:.4f}")
    return errs


def check_close(what, got, want, atol, rtol):
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or not torch.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"{what}: differs from the plain version by {err:.3g} "
                             f"(atol {atol}, rtol {rtol})")
    return err


def train_params(dev, seed):
    return rna2dna_vae_init(torch.Generator().manual_seed(seed), CFG.input_dim_a,
                            CFG.input_dim_b, N_SITES, CFG.latent_dim, CFG.embed_dim, dev)


def train_rows(dev, n, seed):
    """Rows shaped like the cohort: log-expression in, β-values out."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return dict(
        x=torch.log1p(torch.rand((n, CFG.input_dim_a), generator=g, device=dev) * 50.0),
        t=torch.rand((n, CFG.input_dim_b), generator=g, device=dev) * 0.98 + 0.01,
        site=torch.randint(0, N_SITES, (n,), generator=g, device=dev),
        eps=torch.randn((n, CFG.latent_dim), generator=g, device=dev),
        drop=(torch.rand((n, 128), generator=g, device=dev) < 0.9).float(),
    )


def relu_margins(flat, x, site, eps, drop):
    """Smallest |pre-activation| of each of the forward's three ReLUs
    (encoder BN output, decoder layers 1 and 2), relative to that layer's
    largest, computed in float64 from {name: tensor} params.

    Where one is tiny, two fp32 implementations of the step can land on
    different sides of the kink, and their gradients then differ by a whole
    term, not by rounding. A comparison of the kernel with its plain version
    draws its inputs away from that."""
    p = {k: v.double() for k, v in flat.items()}
    a1 = x.double() @ p["w1"] + p["b1"]
    h = (a1 - a1.mean(0)) * torch.rsqrt(torch.square(a1 - a1.mean(0)).mean(0) + 1e-5)
    h = h * p["gamma"] + p["bnbeta"]
    d = torch.relu(h) * drop.double() / ft.KEEP
    e = ft.site_rows(p["emb"], site)
    mu = 0.5 * ((d @ p["wmu"] + p["bmu"]) + (e @ p["smu_w"] + p["smu_b"]))
    lv = 0.5 * ((d @ p["wlv"] + p["blv"]) + (e @ p["slv_w"] + p["slv_b"]))
    u1 = (mu + eps.double() * torch.exp(0.5 * lv)) @ p["d1w"] + p["d1b"]
    u2 = torch.relu(u1) @ p["d2w"] + p["d2b"]
    return tuple((u.abs().min() / u.abs().max()).item() for u in (h, u1, u2))


MARGINS = (5e-6, 5e-7, 5e-7)  # encoder BN/ReLU, decoder layer 1, decoder layer 2


def away_from_kinks(dev, n, seed, margins_of):
    """Rows (``train_rows``) from the first seed at or after ``seed`` whose
    ReLU margins (``margins_of(rows)``) all reach MARGINS; (rows, seed)."""
    for s in range(seed, seed + 400):
        r = train_rows(dev, n, s)
        if all(m >= t for m, t in zip(margins_of(r), MARGINS)):
            return r, s
    raise AssertionError(f"no rows with ReLU margins of {MARGINS} in 400 seeds from {seed}")


def compare_train_step(dev):
    params, state = train_params(dev, 1)
    flat, bn = ft.flatten_params(params), state["encoder_rna"]["bn"]
    worst = 0.0
    for batch in STEP_BATCHES:
        r, seed = away_from_kinks(dev, batch, 1000 * batch, lambda r: relu_margins(
            flat, r["x"], r["site"], r["eps"], r["drop"]))
        loss, grads, new = ft.rna2dna_fused_train_step(
            params, state, r["x"], r["t"], r["site"], N_SITES, beta=BETA, eps=r["eps"],
            drop_mask=r["drop"])
        want = ft.rna2dna_train_step_reference(flat, bn["mean"], bn["var"], r["x"], r["t"],
                                               r["site"], r["eps"], r["drop"], BETA)
        torch.cuda.synchronize()
        check_close(f"train step B={batch} loss", loss, want[0], 0.0, 1e-5)
        got = ft.flatten_params(grads)
        for name, _ in ft.PARAM_ORDER:
            worst = max(worst, check_close(f"train step B={batch} grad {name}", got[name],
                                           want[1][name], **GRAD))
        for k, w in (("mean", want[2]), ("var", want[3])):
            worst = max(worst, check_close(f"train step B={batch} BN {k}",
                                           new["encoder_rna"]["bn"][k], w, 1e-5, 0.0))
        say(f"[compare] rna2dna_train_step B={batch}: rows of seed {seed}")
    say(f"[compare] rna2dna_train_step: max |kernel - plain| = {worst:.3e} over B={STEP_BATCHES} "
        "(loss rtol 1e-5, grads atol 5e-4 + rtol 1e-4, BN atol 1e-5)")
    return worst


def compare_epoch(dev):
    params, state = train_params(dev, 2)
    flat, bn = ft.flatten_params(params), state["encoder_rna"]["bn"]
    g = torch.Generator(device=dev).manual_seed(5)
    m0 = {k: torch.randn(v.shape, generator=g, device=dev) * 1e-3 for k, v in flat.items()}
    v0 = {k: torch.rand(v.shape, generator=g, device=dev) * 1e-6 for k, v in flat.items()}

    def epoch_margins(r):
        """The smallest ReLU margins over the epoch's steps, along the plain
        version's own trajectory."""
        p, opt, rm, rv = dict(flat), {"step": torch.tensor(7, device=dev), "m": m0, "v": v0}, \
            bn["mean"], bn["var"]
        worst = (1.0, 1.0, 1.0)
        for i in range(EPOCH_STEPS):
            rows = slice(32 * i, 32 * (i + 1))
            step = relu_margins(p, r["x"][rows], r["site"][rows], r["eps"][rows],
                                   r["drop"][rows])
            worst = tuple(map(min, worst, step))
            if any(m < t for m, t in zip(worst, MARGINS)):
                return worst
            _, grads, rm, rv = ft.rna2dna_train_step_reference(
                p, rm, rv, r["x"][rows], r["t"][rows], r["site"][rows], r["eps"][rows],
                r["drop"][rows], BETA)
            p, opt = optim.adamw_update(p, grads, opt, LR, WD)
        return worst

    r, seed = away_from_kinks(dev, EPOCH_STEPS * 32, 6000, epoch_margins)
    say(f"[compare] rna2dna_train_epoch: rows of seed {seed}")
    got = fe.rna2dna_fused_epoch(params, ft.unflatten(m0), ft.unflatten(v0), state, r["x"], r["t"],
                                 r["site"], N_SITES, beta=BETA, lr=LR, weight_decay=WD, step0=7,
                                 n_batches=EPOCH_STEPS, eps_ep=r["eps"], drop_ep=r["drop"])
    want = fe.rna2dna_epoch_reference(flat, m0, v0, bn["mean"], bn["var"], r["x"], r["t"],
                                      r["site"], r["eps"], r["drop"], seed=0, beta=BETA, lr=LR,
                                      weight_decay=WD, step0=7, n_batches=EPOCH_STEPS)
    torch.cuda.synchronize()
    loose = 2 * LR * EPOCH_STEPS
    check_close("epoch losses", got[0], want[0], 0.0, 1e-5)
    worst, worst_loose = 0.0, 0.0
    for i, tree in ((1, "params"), (2, "m")):
        flat_got = ft.flatten_params(got[i])
        for name, _ in ft.PARAM_ORDER:
            err = check_close(f"epoch {tree} {name}", flat_got[name], want[i][name],
                              loose if name == "b1" else 2e-5, 0.0)
            if name == "b1":
                worst_loose = max(worst_loose, err)
            else:
                worst = max(worst, err)
    new_bn = got[4]["encoder_rna"]["bn"]
    worst_loose = max(worst_loose, check_close("epoch BN mean", new_bn["mean"], want[4], loose, 0))
    worst = max(worst, check_close("epoch BN var", new_bn["var"], want[5], 2e-4, 0.0))
    say(f"[compare] rna2dna_train_epoch: {EPOCH_STEPS} steps; max |kernel - plain| = {worst:.3e} "
        f"over params, m and BN var (atol 2e-5/2e-4), {worst_loose:.3e} over the fc bias and BN "
        f"mean (atol {loose}); losses rtol 1e-5")
    return max(worst, worst_loose)


def compare_loss(dev):
    worst = {"rna2dna_loss_forward": 0.0, "rna2dna_loss_backward": 0.0}
    for batch in LOSS_BATCHES:
        g = torch.Generator(device=dev).manual_seed(batch)
        logits = (torch.randn((batch, CFG.input_dim_b), generator=g, device=dev) * 3)
        t = torch.rand((batch, CFG.input_dim_b), generator=g, device=dev)
        mu = torch.randn((batch, CFG.latent_dim), generator=g, device=dev)
        lv = torch.randn((batch, CFG.latent_dim), generator=g, device=dev) * 0.5
        leaves = [a.clone().requires_grad_(True) for a in (logits, mu, lv)]
        beta = torch.tensor(2e-3, device=dev, requires_grad=True)
        val = fl.rna2dna_loss_fused(leaves[0], t, leaves[1], leaves[2], beta)
        grads = torch.autograd.grad(val * 1.3, (*leaves, beta))
        ref, kld = fl.loss_forward_reference(logits, t, mu, lv, beta.detach())
        g13 = torch.tensor(1.3, device=dev)
        ref_grads = (*fl.loss_backward_reference(logits, t, mu, lv, beta.detach(), g13),
                     kld * g13)
        torch.cuda.synchronize()
        worst["rna2dna_loss_forward"] = max(worst["rna2dna_loss_forward"], check_close(
            f"loss B={batch}", val, ref, 0.0, 1e-5))
        for i, (a, b) in enumerate(zip(grads, ref_grads)):
            worst["rna2dna_loss_backward"] = max(worst["rna2dna_loss_backward"], check_close(
                f"loss B={batch} grad {i}", a, b, 1e-7, 1e-5))
    say(f"[compare] loss pair: max |kernel - plain| = {worst['rna2dna_loss_forward']:.3e} "
        f"(forward), {worst['rna2dna_loss_backward']:.3e} (backward) over B={LOSS_BATCHES}")
    return worst


def check_philox(dev):
    eps, keep = ft.philox_noise(7, 3, 2048, 128, CFG.latent_dim, dev)
    again, _ = ft.philox_noise(7, 3, 2048, 128, CFG.latent_dim, dev)
    other, other_keep = ft.philox_noise(8, 3, 2048, 128, CFG.latent_dim, dev)
    rate, mean, var = keep.mean().item(), eps.mean().item(), eps.var().item()
    if not torch.equal(eps, again):
        raise AssertionError("train Philox: the same seed gave different draws")
    if torch.equal(eps, other) or torch.equal(keep, other_keep):
        raise AssertionError("train Philox: different seeds gave the same draws")
    if abs(rate - 0.9) > 0.005 or abs(mean) > 0.01 or abs(var - 1.0) > 0.02:
        raise AssertionError(f"train Philox: keep rate {rate}, eps mean {mean}, var {var}")
    params, state = train_params(dev, 3)
    r = train_rows(dev, 32, 9)
    args = (params, state, r["x"], r["t"], r["site"], N_SITES)
    a = ft.rna2dna_fused_train_step(*args, seed=5, step=4)  # same kernel both ways: exact
    e, k = ft.philox_noise(5, 4, 32, 128, CFG.latent_dim, dev)
    b = ft.rna2dna_fused_train_step(*args, eps=e, drop_mask=k)
    torch.cuda.synchronize()
    if not torch.equal(a[0], b[0]):
        raise AssertionError("train Philox: the Philox step differs from the injected step")
    say(f"[compare] train Philox: keep rate {rate:.5f} over {keep.numel()} draws, eps mean "
        f"{mean:.5f} var {var:.5f} over {eps.numel()}; reproducible, seed-dependent, and the "
        "Philox step equals the injected step given its draws")


# ---------------------------------------------------------------------------
# phases 4-5: train, then serve

def phase_train(dev, workdir, tpm, beta, site):
    """run_training through the epoch kernel, then the train-step and plain
    paths of engine.fit; returns the launch counts of each path."""
    cfg = CFG.replace(checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      plots_dir=os.path.join(workdir, "plots"), use_pallas=True)
    zero_counts()
    result, run_id, wall = run_training(cfg=cfg, argv=["--epochs", "3", "--seed", "0"],
                                        data=(tpm, beta, site), n_sites=N_SITES, device=dev,
                                        root=workdir)
    counts = {"train": read_counts()}
    if counts["train"]["rna2dna_train_epoch"] != result.epochs_ran or result.epochs_ran != 3:
        raise AssertionError(f"epoch kernel launched {counts['train']['rna2dna_train_epoch']} "
                             f"times in {result.epochs_ran} epochs")
    losses = result.train_losses[: result.epochs_ran]
    if not (np.isfinite(losses).all() and np.isfinite(result.val_losses[:3]).all()):
        raise AssertionError(f"non-finite losses {losses} {result.val_losses}")
    if not losses[2] < losses[0]:
        raise AssertionError(f"epoch 3's train loss {losses[2]} is not below epoch 1's {losses[0]}")
    for path in (os.path.join(cfg.checkpoint_dir, f"best_rna2dna_{run_id}.npz"),
                 os.path.join(cfg.checkpoint_dir, f"resume_rna2dna_{run_id}.npz"),
                 os.path.join(workdir, "latest_rna2dna_run_id.txt"),
                 os.path.join(cfg.plots_dir, f"metrics_rna2dna_{run_id}.jsonl")):
        if not os.path.exists(path):
            raise AssertionError(f"run_training did not write {path}")
    n_train = len(train_val_indices(len(tpm), cfg.train_test_split, cfg.random_seed)[0])
    say(f"[train] run_training: 3 epochs of {n_train // cfg.batch_size} steps in {wall:.3f} s "
        f"({engine.samples_trained(n_train, cfg.batch_size, 3) / wall:,.0f} samples/s, first "
        f"epoch included); train loss {losses.tolist()}, val loss "
        f"{result.val_losses[:3].tolist()}; artifacts written; launches {counts['train']}")

    tr, va = train_val_indices(len(tpm), cfg.train_test_split, cfg.random_seed)
    arrays = lambda idx: (tpm[idx], beta[idx], site[idx])  # noqa: E731
    for path, kw in (("train_step", {"fused_step": True}), ("train_plain", {})):
        zero_counts()
        res = engine.fit("rna2dna", cfg, arrays(tr), arrays(va), 1, N_SITES, num_epochs=1,
                         device=dev, **kw)
        counts[path] = read_counts()
        if not np.isfinite(res.val_losses).all():
            raise AssertionError(f"{path}: non-finite validation loss")
        say(f"[train] engine.fit {path}: 1 epoch, val loss {float(res.val_losses[0]):.2f}; "
            f"launches {counts[path]}")
    return counts, run_id


def phase_serve(dev, workdir, tpm, beta, site, trained_run_id):
    """Serve the validation split with the trained RNA2DNAVAE and a seeded
    DNA2RNAVAE; returns the launch counts of that run."""
    cfg = CFG.replace(checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      plots_dir=os.path.join(workdir, "plots"))
    dna2rna = port_model(DNA2RNAVAE, 1, False)
    params, state = jax_from_state_dict(dna2rna.state_dict(), "dna2rna")
    run_id = "20260101_000000"
    checkpoint.save_best("dna2rna", run_id, params, state, cfg.checkpoint_dir)
    checkpoint.write_run_id("dna2rna", run_id, workdir)
    p, s, _ = checkpoint.load_best("rna2dna", trained_run_id, cfg.checkpoint_dir)
    rna2dna = RNA2DNAVAE(CFG.input_dim_a, CFG.input_dim_b, N_SITES, CFG.latent_dim,
                         CFG.embed_dim).eval()
    rna2dna.load_state_dict(state_dict_from_jax(p, s, "rna2dna"))
    modules = {"rna2dna": rna2dna, "dna2rna": dna2rna}

    zero_counts()
    results = compare_directional_imputation.main(cfg=cfg, data=(tpm, beta, site), root=workdir,
                                                  device=dev)
    launches = read_counts()

    for name in KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"the serving run never launched {name}")
    if results is None or len(results) != 4:
        raise AssertionError(f"expected 4 records, got {results}")
    for rec in results:
        for key in ("MAE", "MSE", "RMSE", "R2", "CosineSimilarity", "PearsonMean", "PearsonStd"):
            if not math.isfinite(rec[key]):
                raise AssertionError(f"non-finite {key} in {rec['Modality']}/{rec['Model']}")
    out_dirs = [d for d in os.listdir(cfg.plots_dir) if d.startswith("directional_comparison_")]
    if not any(os.path.exists(os.path.join(cfg.plots_dir, d, "comparison_results.json"))
               for d in out_dirs):
        raise AssertionError("comparison_results.json was not written")

    # the served posterior against the unfused modules on the same card
    _, va = train_val_indices(len(tpm), cfg.train_test_split, cfg.random_seed)
    s_val = torch.as_tensor(site[va]).to(dev)
    for ckpt, loader, x in (("rna2dna", load_rna2dna, tpm[va]), ("dna2rna", load_dna2rna, beta[va])):
        served = loader(cfg=cfg, root=workdir, device=dev)
        _, mu, logvar = served(**{ckpt[:3]: x}, site=site[va])
        with torch.no_grad():
            ref = modules[ckpt].to(dev)(torch.as_tensor(x).to(dev), s_val,
                                        eps=torch.zeros(len(va), CFG.latent_dim, device=dev))
        for got, want, what in ((mu, ref[2], "mu"), (logvar, ref[3], "logvar")):
            if got.shape != (len(va), CFG.latent_dim):
                raise AssertionError(f"{ckpt}: served {what} has shape {got.shape}")
            err = np.abs(got - want.cpu().numpy()).max()
            if not np.allclose(got, want.cpu().numpy(), **TOL):
                raise AssertionError(f"{ckpt}: served {what} differs from the module by {err:.3g}")
        say(f"[serve] {ckpt}: served mu/logvar match the unfused module on the card")
    for rec in results:
        say("[serve] " + json.dumps(rec | {"_pearson_all": len(rec["_pearson_all"])}))
    trained = next(r for r in results if r["Model"] == "RNA2DNAVAE")
    mean = next(r for r in results if r["Modality"] == "DNA methylation" and r["Model"] != "RNA2DNAVAE")
    say(f"[serve] trained RNA2DNAVAE MSE {trained['MSE']:.5f} vs mean imputation "
        f"{mean['MSE']:.5f}; launches during the serving run: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 6: time

def time_call(fn, reps=30, warmup=5):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def alternate(kernel, plain, reps=30, warmup=5):
    """(kernel ms, plain ms): plain, kernel, kernel, plain, averaged."""
    p1 = time_call(plain, reps, warmup)
    k1 = time_call(kernel, reps, warmup)
    k2 = time_call(kernel, reps, warmup)
    p2 = time_call(plain, reps, warmup)
    return (k1 + k2) / 2, (p1 + p2) / 2


def profile_epoch(fn, what, card):
    """Device time by kernel over one call (torch.profiler), against its
    wall time: the device's busy and idle shares."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            rows.append((us / 1e3, ev.count, ev.key))
    busy_ms = sum(r[0] for r in rows)
    say(f"[profile] {what}: wall {wall_ms:.3f} ms under the profiler, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), idle {100 - 100 * busy_ms / wall_ms:.1f}%; "
        f"{sum(r[1] for r in rows)} kernels; {card}")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        short = key.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1][:48]
        say(f"[profile]   {short:48s} {ms:9.3f} ms  {count:6d} launches  {1e3 * ms / count:8.2f} us each")


def time_fit(dev, card, n_samples, epochs):
    """Wall time of ``engine.fit`` through the epoch kernel (validation and
    the host loop included) on the synthetic cohort of ``n_samples``, after
    a warm-up run; returns (ms per epoch, samples/s)."""
    tpm, beta, site = generate_synthetic_arrays(n_samples=n_samples, seed=2)
    tr, va = train_val_indices(n_samples, CFG.train_test_split, CFG.random_seed)
    arrays = lambda idx: (tpm[idx], beta[idx], site[idx])  # noqa: E731
    run = lambda n: engine.fit("rna2dna", CFG, arrays(tr), arrays(va), 0, N_SITES,  # noqa: E731
                               num_epochs=n, fused_epoch=True, device=dev)
    run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(epochs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / res.epochs_ran
    rate = engine.samples_trained(len(tr), CFG.batch_size, 1) / ms * 1e3
    say(f"[time] engine.fit, epoch kernel, {n_samples}-sample cohort ({len(tr) // CFG.batch_size} "
        f"steps, {len(va)} validation rows): {ms:.3f} ms per epoch over {res.epochs_ran} epochs, "
        f"{rate:,.0f} samples/s; {card}")
    return ms, rate


def phase_timing(dev, card):
    """Returns {name: (ms, plain_ms, library_ms, bound work)}."""
    out = {}
    for k, (name, (cls, model_cls, ckpt, din, _)) in enumerate(KERNELS.items()):
        params, state = jax_from_state_dict(port_model(model_cls, k, False).state_dict(), ckpt)
        fused = cls(params, state, dev)
        g = torch.Generator(device=dev).manual_seed(300 + k)
        x = torch.rand((205, din), generator=g, device=dev)
        site = torch.randint(0, N_SITES, (205,), generator=g, device=dev)
        ms, plain_ms = alternate(lambda: fused(x, site, seed=7),
                                 lambda: cls._reference(fused.folded, x, site, fv.NOISE_PHILOX, None, 7))
        out[name] = (ms, plain_ms, None, serving_work(name, 205))
        say(f"[time] {name} B=205: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {card}")

    params, state = train_params(dev, 4)
    flat, bn = ft.flatten_params(params), state["encoder_rna"]["bn"]
    r = train_rows(dev, 32, 10)
    ms, plain_ms = alternate(
        lambda: ft.rna2dna_fused_train_step(params, state, r["x"], r["t"], r["site"], N_SITES,
                                            seed=1, step=0, beta=BETA),
        lambda: ft.rna2dna_train_step_reference(flat, bn["mean"], bn["var"], r["x"], r["t"],
                                                r["site"], r["eps"], r["drop"], BETA))
    out["rna2dna_train_step"] = (ms, plain_ms, None, step_work(32))
    say(f"[time] rna2dna_train_step B=32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {card}")

    # one epoch of bench.py's cohort: 8000 samples, 6400 train rows, 200 steps
    tpm, beta, site = generate_synthetic_arrays(n_samples=8000, seed=1)
    tr, _ = train_val_indices(8000, CFG.train_test_split, CFG.random_seed)
    n_steps = len(tr) // 32
    rows = tr[: n_steps * 32]
    x = torch.as_tensor(tpm[rows]).to(dev)
    t = torch.as_tensor(beta[rows]).to(dev)
    s = torch.as_tensor(site[rows]).to(dev)
    zeros = {k: torch.zeros_like(v) for k, v in flat.items()}
    zt = ft.unflatten(zeros)
    ms, plain_ms = alternate(
        lambda: fe.rna2dna_fused_epoch(params, zt, zt, state, x, t, s, N_SITES, seed=2,
                                       beta=BETA, lr=LR, weight_decay=WD, n_batches=n_steps),
        lambda: fe.rna2dna_epoch_reference(flat, zeros, zeros, bn["mean"], bn["var"], x, t, s,
                                           None, None, seed=2, beta=BETA, lr=LR, weight_decay=WD,
                                           step0=0, n_batches=n_steps),
        reps=3, warmup=1)
    profile_epoch(lambda: fe.rna2dna_fused_epoch(
        params, zt, zt, state, x, t, s, N_SITES, seed=2, beta=BETA, lr=LR, weight_decay=WD,
        n_batches=n_steps), f"rna2dna_train_epoch ({n_steps} steps)", card)
    leaves = [v.clone() for v in flat.values()]
    for p in leaves:
        p.grad = torch.randn_like(p) * 1e-3
    adamw = torch.optim.AdamW(leaves, lr=LR, weight_decay=WD, fused=True)
    library_ms = time_call(adamw.step)
    out["rna2dna_train_epoch"] = (ms, plain_ms, library_ms, epoch_work(n_steps, 32))
    say(f"[time] rna2dna_train_epoch {n_steps} steps x 32 rows: kernel {ms:.4f} ms "
        f"({len(rows) / ms * 1e3:,.0f} samples/s), plain {plain_ms:.4f} ms; torch.optim.AdamW "
        f"(fused) step over the same 19 tensors {library_ms:.4f} ms (x{n_steps} per epoch); {card}")

    for batch, name, backward in ((205, "rna2dna_loss_forward", False),
                                  (32, "rna2dna_loss_backward", True)):
        g = torch.Generator(device=dev).manual_seed(batch)
        logits = torch.randn((batch, CFG.input_dim_b), generator=g, device=dev)
        tt = torch.rand((batch, CFG.input_dim_b), generator=g, device=dev)
        mu = torch.randn((batch, CFG.latent_dim), generator=g, device=dev)
        lv = torch.randn((batch, CFG.latent_dim), generator=g, device=dev) * 0.5
        b = torch.tensor(BETA, device=dev)
        one = torch.tensor(1.0, device=dev)
        if backward:
            kernel = lambda: fl._backward(logits, tt, mu, lv, b, one)  # noqa: E731
            plain = lambda: fl.loss_backward_reference(logits, tt, mu, lv, b, one)  # noqa: E731
        else:
            kernel = lambda: fl._forward(logits, tt, mu, lv, b)  # noqa: E731
            plain = lambda: fl.loss_forward_reference(logits, tt, mu, lv, b)  # noqa: E731
        ms, plain_ms = alternate(kernel, plain)
        out[name] = (ms, plain_ms, None, loss_work(batch, backward))
        say(f"[time] {name} B={batch}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {card}")
    time_fit(dev, card, 1024, 10)
    time_fit(dev, card, 8000, 3)
    return out


def main():
    t_start = time.perf_counter()
    dev = device_policy.require_cuda()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off (vae_los_angeles_torch.device)")
    card = card_line()
    say(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = _build.build_all(SOURCES)
    say(f"[build] {len(SOURCES)} sources in {time.perf_counter() - t0:.2f} s with nvcc "
        f"{' '.join(_build.NVCC_FLAGS)}")
    for name, b in built.items():
        say(f"[build] {b.path.name}: {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                say(f"[build]   {line.strip()}")

    errs = compare_serving(dev)
    errs["rna2dna_train_step"] = compare_train_step(dev)
    errs["rna2dna_train_epoch"] = compare_epoch(dev)
    errs.update(compare_loss(dev))
    check_philox(dev)

    tpm, beta, site = generate_synthetic_arrays(n_samples=1024, seed=0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        cwd = os.getcwd()
        os.chdir(workdir)  # the run-id protocol writes into the working directory
        try:
            counts, run_id = phase_train(dev, workdir, tpm, beta, site)
            counts["serve"] = phase_serve(dev, workdir, tpm, beta, site, run_id)
        finally:
            os.chdir(cwd)
    timings = phase_timing(dev, card)

    path_of = {"rna2dna_fused_forward": "serve", "dna2rna_fused_forward": "serve",
               "rna2dna_train_epoch": "train", "rna2dna_loss_forward": "train",
               "rna2dna_train_step": "train_step", "rna2dna_loss_backward": "train_plain"}
    sources = {name: "vae_los_angeles_torch/csrc/fused_vae.cu" for name in KERNELS}
    replaces = {name: spec[4] for name, spec in KERNELS.items()}
    for name, (src, rep, _) in TRAIN_KERNELS.items():
        sources[name], replaces[name] = src, rep
    kernels = []
    for name, path in path_of.items():
        launches = counts[path][name]
        if launches < 1:
            raise AssertionError(f"the {path} path never launched {name}")
        ms, plain_ms, library_ms, work = timings[name]
        bound_ms, bound_by = bound(work)
        say(f"[bound] {name}: {ms:.4f} ms against a bound of {bound_ms:.5f} ms "
            f"({bound_by}; {work[0]:.4g} operations, {work[1]:.4g} bytes); {card}")
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
            "launches": launches, "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
