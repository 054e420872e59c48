"""Diagnostic probes of the kernels on one NVIDIA GPU.

    python3 chip_probes.py serving|serving_calls|first|grads|race|chain|widths|directional|
                           epoch64|loss|steps [OLDER_TREE]

``chip_smoke.py`` is the check; these are the measurements that shaped it,
kept so that the numbers quoted from them in ``PERF.md`` and ``ROADMAP.md``
can be made again:

  * ``first``: build the three sources; the train step at B in {32, 7, 256}
    and a 25-step epoch against their plain versions on random (uncentred)
    inputs; the Philox draws' statistics; the step's and the epoch's call
    time;
  * ``grads``: the train step's gradients against a float64 run of the plain
    version, beside the plain fp32 version's own error, on cohort-like and
    on centred inputs;
  * ``race``: the same failing comparison repeated, synchronised or not and
    at other batch sizes: deterministic, and shape- and data-dependent;
  * ``chain``: every intermediate of one step (from the kernel's
    workspace) against float64 recomputed from the kernel's own previous
    stage;
  * ``widths``: ``engine.fit``'s ms an epoch for rna2dna on 512 synthetic
    samples at DecoderB widths from the cohort's (1211) to the whole
    methylome's (450,000), on the plain path and on the kernel path through
    the epoch kernel (its captured graph) and through the wide head kernel,
    each with its peak device memory (the epoch graph's cached copies of p,
    m and v included): where ``engine.WIDE_HEAD_MIN_DIM_B`` lies;
  * ``directional``: the directional epoch and step kernels, ``engine.fit``
    of both directional tasks at 8000 samples and the RNA→DNA epoch-kernel
    path's peak memory at DecoderB 262,144, as one JSON line
    (`probe_directional`, which also times an older tree);
  * ``epoch64``: ``chip_smoke.compare_wide_epochs`` with the plain version
    also in float64, tensor by tensor: how far each fp32 version is from
    float64 at those widths;
  * ``serving``: the serving call's device time (back-to-back calls between
    CUDA events) by width, with the wide layer in the cluster trunk and in
    its sweep: DNA→RNA by DNA input width, RNA→DNA by DecoderB output width,
    each at B = 37, 103 and 205: where ``fused_vae.SWEEP_MIN_IN`` and
    ``SWEEP_MIN_OUT`` lie;
  * ``serving_calls``: the serving call (CUDA events, median of 30) at B in
    {1, 205, 1600, 4096}, its device time by kernel at B = 205 and 1
    (``torch.profiler``), DNA→RNA at a DNA input of 65,536 and RNA→DNA at a
    DecoderB output of 450,000 (B = 103), as one JSON line. It uses only the
    wrappers' call API and what every ``chip_smoke.py`` of the port has, so a
    copy of this file beside an older tree's ``chip_smoke.py`` times that
    tree (a call that raises is recorded as such): run both trees in one
    call, alternating;
  * ``loss [OLDER_TREE]``: the loss pair (B3, ``fused_loss.cu``) at 32 and
    205 x 1211 and 32 and 103 x 450,000, forward and backward, through its C
    entries and its Python wrappers: ms a call back to back and alone (CUDA
    events), device µs and kernels a call, beside the byte bound; with an
    older tree's root (its ``vae_los_angeles_torch/`` unpacked with ``git
    archive`` into a gitignored directory), that tree's library is built
    from its ``fused_loss.cu``, its wrapper module loaded beside this one,
    and both timed in turns with this tree's (older, this, this, older), as
    one JSON line;
  * ``steps [OLDER_TREE]``: the train-step kernels (B6, B4 and B1) at B =
    32, each wrapper call and its C entry alone (a cached step graph's
    launch, or an older tree's host-loop entry): ms back to back, one call at
    a time and host ms, device µs by kernel and launches a call; the 200-step
    epochs (B2, B5, B7); ``engine.fit(fused_step=True)`` at 1024 samples;
    with an older tree's root, that tree's package (its ``fused_train`` and
    ``fused_epoch`` loaded beside this tree's, its library built from its
    ``fused_train.cu``) in turns with this tree's (older, this, this,
    older), every step's and epoch's results compared bit for bit, as one
    JSON line.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from vae_los_angeles_torch.ops.kernels import _build
from vae_los_angeles_torch.ops.kernels import fused_epoch as fe
from vae_los_angeles_torch.ops.kernels import fused_train as ft

N_SITES = 24


def probe_first(dev):
    t0 = time.time()
    built = _build.build_all(["fused_train", "fused_loss", "fused_vae"])
    print("build", time.time() - t0)
    for n, b in built.items():
        print(n, b.seconds)
    din, dout, lat = 1177, 1211, 20
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = {"w1": (din, 128), "b1": (128,), "gamma": (128,), "bnbeta": (128,),
              "wmu": (128, lat), "bmu": (lat,), "wlv": (128, lat), "blv": (lat,),
              "emb": (N_SITES, 32), "smu_w": (32, lat), "smu_b": (lat,), "slv_w": (32, lat),
              "slv_b": (lat,), "d1w": (lat, 256), "d1b": (256,), "d2w": (256, 512),
              "d2b": (512,), "d3w": (512, dout), "d3b": (dout,)}
    flat = {k: (torch.rand(s, generator=g, device=dev) - 0.5)
            * (2 / s[0] ** 0.5 if len(s) == 2 else 0.2) for k, s in shapes.items()}
    flat["gamma"] += 1.0
    rm, rv = torch.zeros(128, device=dev), torch.ones(128, device=dev)
    for batch in (32, 7, 256):
        x = torch.rand(batch, din, generator=g, device=dev) * 3
        t = torch.rand(batch, dout, generator=g, device=dev)
        site = torch.randint(0, N_SITES, (batch,), generator=g, device=dev)
        eps = torch.randn(batch, lat, generator=g, device=dev)
        drop = (torch.rand(batch, 128, generator=g, device=dev) < 0.9).float()
        got = train_step(flat, rm, rv, x, t, site, eps, drop)
        want = ft.rna2dna_train_step_reference(flat, rm, rv, x, t, site, eps, drop, 1e-3)
        torch.cuda.synchronize()
        excess = {k: ((got[1][k] - want[1][k]).abs() - 1e-4 * want[1][k].abs()).max().item()
                  for k in shapes}
        print("B", batch, "loss", got[0].item(), want[0].item(),
              "worst grad excess over rtol", max(excess.items(), key=lambda kv: kv[1]))
    n, batch = 25, 32
    xe = torch.rand(n * batch, din, generator=g, device=dev) * 3
    te = torch.rand(n * batch, dout, generator=g, device=dev)
    se = torch.randint(0, N_SITES, (n * batch,), generator=g, device=dev)
    ee = torch.randn(n * batch, lat, generator=g, device=dev)
    de = (torch.rand(n * batch, 128, generator=g, device=dev) < 0.9).float()
    zeros = {k: torch.zeros_like(v) for k, v in flat.items()}
    got = fe._launch_epoch(flat, zeros, zeros, {"mean": rm, "var": rv}, xe, te, se, ee, de, False,
                           0, 1e-3, 5e-4, 1e-5, 0, n)
    want = fe.rna2dna_epoch_reference(flat, zeros, zeros, rm, rv, xe, te, se, ee, de, seed=0,
                                      beta=1e-3, lr=5e-4, weight_decay=1e-5, step0=0, n_batches=n)
    torch.cuda.synchronize()
    print("epoch loss rel", ((got[0] - want[0]).abs() / want[0].abs()).max().item())
    for i, name in ((1, "p"), (2, "m"), (3, "v")):
        err = {k: (got[i][k] - want[i][k]).abs().max().item() for k in shapes}
        print(name, sorted(err.items(), key=lambda kv: -kv[1])[:3])
    print("rm", (got[4] - want[4]).abs().max().item(), "rv", (got[5] - want[5]).abs().max().item())
    eps, keep = ft.philox_noise(3, 1, 1024, 128, 20, dev)
    print("keep", keep.mean().item(), "eps", eps.mean().item(), eps.var().item())
    x, t, site = xe[:32], te[:32], se[:32]
    print("step ms", time_ms(lambda: train_step(flat, rm, rv, x, t, site)))
    print("plain step ms", time_ms(lambda: ft.rna2dna_train_step_reference(
        flat, rm, rv, x, t, site, ee[:32], de[:32], 1e-3)))
    print("epoch25 ms", time_ms(lambda: fe._launch_epoch(
        flat, zeros, zeros, {"mean": rm, "var": rv}, xe, te, se, None, None, True, 0, 1e-3, 5e-4,
        1e-5, 0, n), 5))


host_ms, time_ms = cs.host_ms, cs.time_loop


def train_step(flat, rm, rv, x, t, site, eps=None, drop=None):
    """(loss, {name: grad}, new state) of one RNA→DNA step through its graph
    (injected noise, or Philox without it)."""
    loss, grads, state = ft.rna2dna_fused_train_step(
        ft.unflatten(flat), {"encoder_rna": {"bn": {"mean": rm, "var": rv}}}, x, t, site,
        N_SITES, beta=1e-3, eps=eps, drop_mask=drop)
    return loss, ft.flatten_params(grads), state


def probe_grads(dev):
    for kind in ("cohort", "normal"):
        params, state = cs.train_params(dev, 1)
        flat, bn = ft.flatten_params(params), state["encoder_rna"]["bn"]
        for batch in (32, 7, 256):
            r = cs.train_rows(dev, batch, batch)
            if kind == "normal":
                r["x"] = torch.randn(r["x"].shape, device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(batch))
            loss, grads, _ = ft.rna2dna_fused_train_step(
                params, state, r["x"], r["t"], r["site"], N_SITES, beta=1e-3, eps=r["eps"],
                drop_mask=r["drop"])
            p32 = ft.rna2dna_train_step_reference(flat, bn["mean"], bn["var"], r["x"], r["t"],
                                                  r["site"], r["eps"], r["drop"], 1e-3)
            d = torch.Tensor.double
            p64 = ft.rna2dna_train_step_reference(
                {k: d(v) for k, v in flat.items()}, d(bn["mean"]), d(bn["var"]), d(r["x"]),
                d(r["t"]), r["site"], d(r["eps"]), d(r["drop"]), 1e-3)
            g = ft.flatten_params(grads)
            print(kind, batch, "loss rel", abs(loss.item() - p64[0].item()) / abs(p64[0].item()),
                  abs(p32[0].item() - p64[0].item()) / abs(p64[0].item()))
            for name, _ in ft.PARAM_ORDER:
                k_err = (g[name].double() - p64[1][name]).abs().max().item()
                p_err = (p32[1][name].double() - p64[1][name]).abs().max().item()
                kp = (g[name] - p32[1][name]).abs().max().item()
                if kp > 1e-5 or name in ("w1", "b1"):
                    print(f"   {name:7s} max|g| {p64[1][name].abs().max().item():.3e} "
                          f"kernel-f64 {k_err:.3e} plain32-f64 {p_err:.3e} kernel-plain {kp:.3e}")


def probe_race(dev):
    def trial(tag, seed, batch, sync=False):
        params, state = cs.train_params(dev, seed)
        flat, bn = ft.flatten_params(params), state["encoder_rna"]["bn"]
        r = cs.train_rows(dev, batch, batch)
        if sync:
            torch.cuda.synchronize()
        _, grads, _ = ft.rna2dna_fused_train_step(params, state, r["x"], r["t"], r["site"],
                                                  N_SITES, beta=1e-3, eps=r["eps"],
                                                  drop_mask=r["drop"])
        if sync:
            torch.cuda.synchronize()
        g = ft.flatten_params(grads)
        ref = ft.rna2dna_train_step_reference(flat, bn["mean"], bn["var"], r["x"], r["t"],
                                              r["site"], r["eps"], r["drop"], 1e-3)
        bad = {n: round((g[n] - ref[1][n]).abs().max().item(), 6) for n, _ in ft.PARAM_ORDER
               if (g[n] - ref[1][n]).abs().max().item() > 1e-3}
        print(tag, seed, batch, "sync" if sync else "nosync", "bad:", bad, flush=True)

    for _ in range(3):
        trial("a", 1, 32)
    trial("b", 1, 32, True)
    trial("c", 2, 32)
    for batch in (7, 64, 33, 31):
        trial("d", 1, batch)


def probe_chain(dev, batch=32):
    params, state = cs.train_params(dev, 1)
    flat, bn = ft.flatten_params(params), state["encoder_rna"]["bn"]
    r = cs.train_rows(dev, batch, batch)
    _, hid, lat, _, emb, d1, d2, out = ft.dims_of(flat)
    train_step(flat, bn["mean"], bn["var"], r["x"], r["t"], r["site"], r["eps"], r["drop"])
    work = ft.step_graphs["rna2dna"][1].work
    work.fill_(float("nan"))  # what the step does not write stays NaN
    _, g, _ = train_step(flat, bn["mean"], bn["var"], r["x"], r["t"], r["site"], r["eps"],
                         r["drop"])
    torch.cuda.synchronize()
    # the workspace plan of csrc/fused_train.cu (each block rounded up to 4 floats)
    sizes = [("xhat", (batch, hid)), ("dcoef", (batch, hid)), ("d", (batch, hid)),
             ("inv_std", (hid,)), ("e", (batch, emb)), ("mu", (batch, lat)),
             ("lv", (batch, lat)), ("epsv", (batch, lat)), ("sigma", (batch, lat)),
             ("z", (batch, lat)), ("r1", (batch, d1)), ("r2", (batch, d2)),
             ("dlogits", (batch, out)), ("du2", (batch, d2)), ("du1", (batch, d1)),
             ("dmh", (batch, lat)), ("dlh", (batch, lat)), ("da1", (batch, hid))]
    w, o = {}, 0
    for name, shape in sizes:
        n = shape[0] * (shape[1] if len(shape) > 1 else 1)
        w[name] = work[o:o + n].view(shape).double()
        o += (n + 3) // 4 * 4
    P = {k: v.double() for k, v in flat.items()}
    G = {k: v.double() for k, v in g.items()}
    x, t = r["x"].double(), r["t"].double()

    def check(name, got, want):
        e, m = (got - want).abs().max().item(), want.abs().max().item()
        print(f"{name:8s} err {e:.3e} max {m:.3e} {'BAD' if e > 1e-4 * max(m, 1) else ''}")

    a1 = x @ P["w1"] + P["b1"]
    mean = a1.mean(0)
    inv = 1 / torch.sqrt(((a1 - mean) ** 2).mean(0) + 1e-5)
    check("inv_std", w["inv_std"], inv)
    check("xhat", w["xhat"], (a1 - mean) * inv)
    h = w["xhat"] * P["gamma"] + P["bnbeta"]
    check("dcoef", w["dcoef"], (h > 0) * r["drop"].double() / 0.9)
    check("d", w["d"], h * (h > 0) * r["drop"].double() / 0.9)
    e = P["emb"][r["site"]]
    check("e", w["e"], e)
    check("mu", w["mu"], 0.5 * (w["d"] @ P["wmu"] + P["bmu"] + e @ P["smu_w"] + P["smu_b"]))
    check("lv", w["lv"], 0.5 * (w["d"] @ P["wlv"] + P["blv"] + e @ P["slv_w"] + P["slv_b"]))
    check("z", w["z"], w["mu"] + w["epsv"] * torch.exp(0.5 * w["lv"]))
    check("r1", w["r1"], torch.relu(w["z"] @ P["d1w"] + P["d1b"]))
    check("r2", w["r2"], torch.relu(w["r1"] @ P["d2w"] + P["d2b"]))
    check("dlogits", w["dlogits"], torch.sigmoid(w["r2"] @ P["d3w"] + P["d3b"]) - t)
    check("du2", w["du2"], (w["dlogits"] @ P["d3w"].T) * (w["r2"] > 0))
    check("du1", w["du1"], (w["du2"] @ P["d2w"].T) * (w["r1"] > 0))
    dz = w["du1"] @ P["d1w"].T
    check("dmh", w["dmh"], 0.5 * (dz + 1e-3 * w["mu"]))
    check("dlh", w["dlh"], 0.5 * (dz * w["epsv"] * 0.5 * w["sigma"]
                                  - 0.5e-3 * (1 - torch.exp(w["lv"]))))
    check("g_d3w", G["d3w"], w["r2"].T @ w["dlogits"])
    check("g_d2w", G["d2w"], w["r1"].T @ w["du2"])
    check("g_d2b", G["d2b"], w["du2"].sum(0))
    check("g_d1w", G["d1w"], w["z"].T @ w["du1"])
    check("g_w1", G["w1"], x.T @ w["da1"])


def probe_widths(dev, widths=(1211, 131072, 262144, 327680, 393216, 450_000), samples=512):
    from vae_los_angeles_torch.data.splits import train_val_indices
    from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
    from vae_los_angeles_torch.models.directional_vae import rna2dna_vae_init
    from vae_los_angeles_torch.training import engine

    _build.build_all(["fused_train", "fused_loss", "fused_wide"])
    print(cs.card_line())
    threshold = engine.WIDE_HEAD_MIN_DIM_B
    tr, va = train_val_indices(samples, cs.CFG.train_test_split, cs.CFG.random_seed)
    for width in widths:
        tpm, beta, site = generate_synthetic_arrays(n_samples=samples, dim_b=width, seed=5)
        rows = [[torch.as_tensor(a[idx]).to(dev) for a in (tpm, beta, site)] for idx in (tr, va)]
        cfg = cs.CFG.replace(input_dim_b=width)
        init = rna2dna_vae_init(torch.Generator().manual_seed(0), cfg.input_dim_a, width,
                                N_SITES, cfg.latent_dim, cfg.embed_dim, dev)
        line = []
        for path, min_width, kw in (("plain", threshold, {}),
                                    ("epoch kernel", width + 1, {"fused_epoch": True}),
                                    ("wide head", width, {"fused_epoch": True})):
            engine.WIDE_HEAD_MIN_DIM_B = min_width
            try:
                def fit(n):
                    return engine.fit("rna2dna", cfg, *rows, 0, N_SITES, num_epochs=n,
                                      device=dev, init_params=init[0], init_state=init[1], **kw)
                torch.cuda.reset_peak_memory_stats()
                fit(1)  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fit(3)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / 3
            finally:
                engine.WIDE_HEAD_MIN_DIM_B = threshold
            peak = torch.cuda.max_memory_allocated() / 2**30
            line.append(f"{path} {ms:.3f} ms, peak {peak:.3f} GiB (train loss "
                        f"{res.train_losses.tolist()})")
            fe.graphs.clear()  # each path's peak without an earlier path's cached graph
            del res
        print(f"[widths] dim_b {width}: " + "; ".join(line), flush=True)
        del rows, init
        torch.cuda.empty_cache()


def probe_directional(dev):
    """The directional epoch kernels (B2, B5) at 200 steps x 32, the step
    kernels (B1, B4) at B = 32, ``engine.fit`` of each directional task at
    8000 samples through its epoch kernel, and the peak device memory of
    RNA→DNA's epoch-kernel path at DecoderB 262,144 (512 samples, 3 epochs,
    rows and weights on the card first), as one JSON line. It uses only what
    ``chip_smoke.py`` has had since the directional epochs were host loops,
    so a copy of this file beside an older tree's ``chip_smoke.py`` times
    that tree: run both trees in one call, alternating."""
    import json

    from vae_los_angeles_torch.data.splits import train_val_indices
    from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
    from vae_los_angeles_torch.models.directional_vae import rna2dna_vae_init
    from vae_los_angeles_torch.training import engine

    _build.build_all(cs.SOURCES)
    card = cs.card_line()
    out = {}
    tpm, beta, site = generate_synthetic_arrays(n_samples=8000, seed=1)
    tr, _ = train_val_indices(8000, cs.CFG.train_test_split, cs.CFG.random_seed)
    n = len(tr) // 32
    x, t, s = (torch.as_tensor(a[tr[: n * 32]]).to(dev) for a in (tpm, beta, site))
    params, state = cs.train_params(dev, 4)
    zt = ft.unflatten({k: torch.zeros_like(v) for k, v in ft.flatten_params(params).items()})
    dp, ds = cs.d2r_params(dev, 14)
    zd = ft.unflatten({k: torch.zeros_like(v) for k, v in ft.flatten_params(dp, cs.D2R).items()},
                      cs.D2R)
    kw = dict(seed=2, beta=cs.BETA, lr=cs.LR, weight_decay=cs.WD, n_batches=n)
    out["b2_epoch_ms"] = cs.time_call(lambda: fe.rna2dna_fused_epoch(
        params, zt, zt, state, x, t, s, N_SITES, **kw), reps=10, warmup=2)
    out["b5_epoch_ms"] = cs.time_call(lambda: fe.dna2rna_fused_epoch(
        dp, zd, zd, ds, t, x, s, N_SITES, **kw), reps=10, warmup=2)
    r, rd = cs.train_rows(dev, 32, 10), cs.d2r_rows(dev, 32, 20)
    out["b1_step_ms"] = cs.time_call(lambda: ft.rna2dna_fused_train_step(
        params, state, r["x"], r["t"], r["site"], N_SITES, seed=1, step=0, beta=cs.BETA))
    out["b4_step_ms"] = cs.time_call(lambda: ft.dna2rna_fused_train_step(
        dp, ds, rd["t"], rd["x"], rd["site"], N_SITES, seed=1, step=0, beta=cs.BETA))
    for task in ("rna2dna", "dna2rna"):
        out[f"fit_8000_{task}_ms"] = cs.time_fit(dev, card, 8000, 3, task)[0]
    del x, t, s
    width = 262_144
    tpm, beta, site = generate_synthetic_arrays(n_samples=512, dim_b=width, seed=5)
    tr, va = train_val_indices(512, cs.CFG.train_test_split, cs.CFG.random_seed)
    rows = [[torch.as_tensor(a[idx]).to(dev) for a in (tpm, beta, site)] for idx in (tr, va)]
    cfg = cs.CFG.replace(input_dim_b=width)
    init = rna2dna_vae_init(torch.Generator().manual_seed(0), cfg.input_dim_a, width, N_SITES,
                            cfg.latent_dim, cfg.embed_dim, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["b2_path_262144_before_gib"] = torch.cuda.memory_allocated() / 2**30
    engine.fit("rna2dna", cfg, *rows, 0, N_SITES, num_epochs=3, device=dev,
               init_params=init[0], init_state=init[1], fused_epoch=True)
    torch.cuda.synchronize()
    out["b2_path_262144_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print("[directional] " + json.dumps(out) + f"; {card}", flush=True)


def probe_epoch64(dev):
    """`chip_smoke.compare_wide_epochs` with the plain version also run in
    float64: how far each fp32 version is from float64 at those widths."""
    _build.build_all(cs.SOURCES)
    print(cs.card_line())
    cs.compare_wide_epochs(dev, float64=True)


def serving_model(dev, direction, width, seed=0):
    """A seeded serving wrapper at the cohort's widths but for DNA→RNA's DNA
    input or RNA→DNA's DecoderB output, which is ``width`` wide; weights
    drawn as the port initialises them, BN statistics moved off their
    defaults."""
    import numpy as np

    from vae_los_angeles_torch.models import DNA2RNAVAE, RNA2DNAVAE
    from vae_los_angeles_torch.ops.kernels import fused_vae as fv
    from vae_los_angeles_torch.utils.weights import jax_from_state_dict

    model_cls, fused_cls = ((RNA2DNAVAE, fv.FusedRNA2DNA) if direction == "rna2dna"
                            else (DNA2RNAVAE, fv.FusedDNA2RNA))
    g = torch.Generator().manual_seed(seed)
    model = model_cls(cs.CFG.input_dim_a, width, N_SITES, cs.CFG.latent_dim, cs.CFG.embed_dim)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 2:
                bound = 1.0 / np.sqrt(p.shape[1])
                p.uniform_(-bound, bound, generator=g)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    params, state = jax_from_state_dict(model.eval().state_dict(), direction)
    return fused_cls(params, state, dev)


def serving_rows(dev, fused, batch, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand((batch, fused.in_dim), generator=g, device=dev),
            torch.randint(0, N_SITES, (batch,), generator=g, device=dev))


def probe_serving(dev):
    from vae_los_angeles_torch.ops.kernels import fused_vae as fv

    _build.build_all(["fused_vae"])
    card = cs.card_line()
    print(card, flush=True)
    sweep_min_default = fv.SWEEP_MIN_IN, fv.SWEEP_MIN_OUT
    for direction, widths in (("dna2rna", (1211, 2048, 4096, 8192, 16384, 32768, 65536)),
                              ("rna2dna", (1211, 2048, 4096, 8192, 16384, 32768, 65536, 131072))):
        for width in widths:
            fused = serving_model(dev, direction, width)
            for batch in (37, 103, 205):
                x, site = serving_rows(dev, fused, batch)
                times = {}
                wide = (width, 1 << 30) if direction == "dna2rna" else (1 << 30, width)
                for route, sweep_min in (("trunk", (1 << 30, 1 << 30)), ("sweep", wide)):
                    fv.SWEEP_MIN_IN, fv.SWEEP_MIN_OUT = sweep_min
                    fused._calls.clear()  # plans are laid out with the thresholds of their time
                    times[route] = time_ms(lambda: fused(x, site, seed=3))
                    times[route + "_kernels"] = fused.plan(batch).plan.kernels
                fv.SWEEP_MIN_IN, fv.SWEEP_MIN_OUT = sweep_min_default
                fused._calls.clear()
                print(f"[serving] {direction} width {width} B={batch}: trunk "
                      f"{times['trunk']:.4f} ms ({times['trunk_kernels']} kernels), sweep "
                      f"{times['sweep']:.4f} ms ({times['sweep_kernels']} kernels); {card}",
                      flush=True)
            del fused
            torch.cuda.empty_cache()


def device_us(fn):
    """{kernel: (device µs, launches)} of one call of ``fn`` (torch.profiler),
    after a warm-up call."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            us = us if us is not None else ev.self_cuda_time_total
            # kernels in an anonymous namespace: the key starts with "(anonymous namespace)::"
            name = cs.short_name(ev.key)
            total, count = rows.get(name, (0.0, 0))
            rows[name] = (total + us, count + ev.count)
    return rows


def probe_serving_calls(dev):
    import json

    _build.build_all(["fused_vae"])
    card = cs.card_line()
    out = {}
    for direction in ("rna2dna", "dna2rna"):
        fused = serving_model(dev, direction, cs.CFG.input_dim_b)
        for batch in (1, 205, 1600, 4096):
            x, site = serving_rows(dev, fused, batch)
            out[f"{direction}_B{batch}_call_ms"] = cs.time_call(lambda: fused(x, site, seed=3))
            out[f"{direction}_B{batch}_loop_ms"] = time_ms(lambda: fused(x, site, seed=3), 50)
            if batch in (1, 205):
                prof = device_us(lambda: fused(x, site, seed=3))
                out[f"{direction}_B{batch}_device_us"] = sum(us for us, _ in prof.values())
                out[f"{direction}_B{batch}_kernels"] = sum(n for _, n in prof.values())
                out[f"{direction}_B{batch}_by_kernel"] = prof
    for direction, width, batch in (("dna2rna", 65536, 205), ("rna2dna", 450_000, 103)):
        key = f"{direction}_{width}_B{batch}"
        try:
            fused = serving_model(dev, direction, width)
            x, site = serving_rows(dev, fused, batch)
            out[key + "_call_ms"] = cs.time_call(lambda: fused(x, site, use_noise=False), 10, 2)
        except (RuntimeError, ValueError) as e:
            out[key + "_call_ms"] = f"raises: {str(e)[:120]}"
        fused = x = site = None
        torch.cuda.empty_cache()
    print("[serving_calls] " + json.dumps(out) + f"; {card}", flush=True)


LOSS_SHAPES = ((32, 1211), (205, 1211), (32, 450_000), (103, 450_000))


def loss_library(path):
    """The loss pair's library built from the ``fused_loss.cu`` at ``path``
    (an older tree's), its entries bound as its wrapper binds them."""
    so = _build.BUILD_DIR / "other" / "libfused_loss.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(path)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, n = ctypes.c_void_p, ctypes.c_longlong
    lib.rna2dna_loss_forward.argtypes = [p, p, n, p, p, n, p, p, p, p]
    lib.rna2dna_loss_backward.argtypes = [p, p, n, p, p, n, p, p, p, p, p, p]
    lib.rna2dna_loss_workspace_floats.argtypes = []
    lib.fused_loss_error_string.argtypes = [ctypes.c_int]
    lib.fused_loss_error_string.restype = ctypes.c_char_p
    return lib


def loss_wrappers(parent=None):
    """{"change": this tree's ``ops/kernels/fused_loss`` module} and, with an
    older tree's root, {"parent": that tree's module bound to its library}."""
    import importlib.util

    from vae_los_angeles_torch.ops.kernels import fused_loss

    mods = {"change": fused_loss}
    if parent is not None:
        spec = importlib.util.spec_from_file_location(
            "older_fused_loss", Path(parent) / "vae_los_angeles_torch/ops/kernels/fused_loss.py")
        mods["parent"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods["parent"])
        lib = loss_library(Path(parent) / "vae_los_angeles_torch/csrc/fused_loss.cu")
        mods["parent"]._library = lambda: lib
    return mods


def probe_loss(dev, parent=None):
    """The loss pair at the cohort's and the wide paths' shapes, through its
    C entries and through its Python wrappers (``_forward``, ``_backward``),
    this tree's against an older tree's (``parent``: that tree's root, whose
    wrapper module is loaded beside this one and bound to its own library),
    alternated older, this, this, older: ms a call back to back (CUDA events
    over 50 calls), the median of 30 single calls and of their host time
    (the enqueue), and the device µs and kernels of one C call
    (torch.profiler); one JSON line."""
    import json

    card = cs.card_line()
    mods = loss_wrappers(parent)
    libs = {who: mod._library() for who, mod in mods.items()}
    order = ["parent", "change", "change", "parent"] if parent is not None else ["change"] * 2
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for batch, width in LOSS_SHAPES:
        g = torch.Generator(device=dev).manual_seed(batch)
        logits = torch.randn((batch, width), generator=g, device=dev)
        t = torch.rand((batch, width), generator=g, device=dev)
        mu = torch.randn((batch, cs.CFG.latent_dim), generator=g, device=dev)
        lv = torch.randn((batch, cs.CFG.latent_dim), generator=g, device=dev) * 0.5
        beta, one = torch.tensor(1e-3, device=dev), torch.tensor(1.0, device=dev)
        res = torch.empty(2, device=dev)
        grads = [torch.empty_like(a) for a in (logits, mu, lv)]
        calls = {}
        for who, lib in libs.items():
            work = torch.zeros(lib.rna2dna_loss_workspace_floats(), device=dev)
            args = (logits.data_ptr(), t.data_ptr(), logits.numel(), mu.data_ptr(),
                    lv.data_ptr(), mu.numel(), beta.data_ptr())
            calls[who, "forward"] = functools.partial(
                lib.rna2dna_loss_forward, *args, res.data_ptr(), work.data_ptr(), stream)
            calls[who, "backward"] = functools.partial(
                lib.rna2dna_loss_backward, *args, one.data_ptr(), *(x.data_ptr() for x in grads),
                stream)
            mod = mods[who]
            calls[who, "forward_wrapper"] = functools.partial(mod._forward, logits, t, mu, lv,
                                                              beta)
            calls[who, "backward_wrapper"] = functools.partial(mod._backward, logits, t, mu, lv,
                                                               beta, one)
        for kernel in ("forward", "backward"):
            key = f"{kernel}_{batch}x{width}"
            for who in order:
                for what, fn in (("", calls[who, kernel]),
                                 ("wrapper_", calls[who, kernel + "_wrapper"])):
                    out.setdefault(f"{key}_{who}_{what}loop_ms", []).append(time_ms(fn, 50))
                    out.setdefault(f"{key}_{who}_{what}call_ms", []).append(cs.time_call(fn))
                    out.setdefault(f"{key}_{who}_{what}host_ms", []).append(host_ms(fn))
            for who in libs:
                prof = device_us(calls[who, kernel])
                out[f"{key}_{who}_device_us"] = sum(us for us, _ in prof.values())
                out[f"{key}_{who}_kernels"] = sum(k for _, k in prof.values())
            nbytes = cs.loss_work(batch, kernel == "backward", width)[1]
            out[f"{key}_bound_ms"] = nbytes / cs.PEAK_BYTES * 1e3
        del logits, t, grads, calls
        torch.cuda.empty_cache()
    print("[loss] " + json.dumps(out) + f"; {card}", flush=True)


# ---- the train-step kernels (B1, B4, B6) against an older tree ----
STEP_TASKS = ("multimodal", "dna2rna", "rna2dna")
EPOCH_FN = {"multimodal": "multimodal_fused_epoch", "dna2rna": "dna2rna_fused_epoch",
            "rna2dna": "rna2dna_fused_epoch"}


def load_module(name, path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree_modules(name, root):
    """(``fused_train``, ``fused_epoch``) of the tree at ``root`` loaded as
    modules of their own: the first bound to a library built from the
    tree's ``fused_train.cu``, the second to the first."""
    import types

    root = Path(root) / "vae_los_angeles_torch"
    so = _build.BUILD_DIR / "other" / name / "libfused_train.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(root / "csrc/fused_train.cu")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    mod_ft = load_module(f"{name}_fused_train", root / "ops/kernels/fused_train.py")
    mod_ft.build = lambda _: types.SimpleNamespace(lib=lib)
    mod_ft.library.cache_clear()
    mod_fe = load_module(f"{name}_fused_epoch", root / "ops/kernels/fused_epoch.py")
    mod_fe.ft = mod_ft
    return mod_ft, mod_fe


def step_modules(parent=None):
    """{"change": (this tree's ``fused_train``, ``fused_epoch``)} and, with an
    older tree's root, {"parent": that tree's two modules (`tree_modules`)}."""
    mods = {"change": (ft, fe)}
    if parent is not None:
        mods["parent"] = tree_modules("parent", parent)
    return mods


def host_profile(call, calls=200, top=14):
    """[(function, its own host µs a call)] of the ``top`` costliest
    functions over ``calls`` calls of ``call`` (cProfile, which slows what
    it profiles: read the shares, not the sums)."""
    import cProfile
    import pstats

    call()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        call()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, f"{Path(f).name}:{line} {fn}") for (f, line, fn), (_, _, tt, _, _)
                   in stats.items()), reverse=True)[:top]
    return [[name, round(1e6 * tt / calls, 2)] for tt, name in rows]


def step_inputs(dev):
    """{task: (params, state, rows)} at the full width, B = 32 (chip_smoke's
    timing inputs)."""
    return {"multimodal": (*cs.mm_params(dev, 24), cs.mm_rows(dev, 32, 30)),
            "dna2rna": (*cs.d2r_params(dev, 14), cs.d2r_rows(dev, 32, 20)),
            "rna2dna": (*cs.train_params(dev, 4), cs.train_rows(dev, 32, 10))}


def epoch_call(mod_fe, task, data):
    """One 200-step epoch of ``task`` through ``mod_fe``'s epoch wrapper on the
    8000-sample cohort's rows, from zero moments, Philox noise."""
    mod_ft = mod_fe.ft
    order = {"multimodal": mod_ft.PARAM_ORDER_MM, "dna2rna": mod_ft.PARAM_ORDER_D2R,
             "rna2dna": mod_ft.PARAM_ORDER}[task]
    (params, state, _), (x, t, s, cw, n) = data[task], data["rows"]
    zt = mod_ft.unflatten({k: torch.zeros_like(v) for k, v in
                           mod_ft.flatten_params(params, order).items()}, order)
    rows = (t, x) if task == "dna2rna" else (x, t)
    kw = dict(seed=2, beta=cs.BETA, lr=cs.LR, weight_decay=cs.WD, n_batches=n)
    if task == "multimodal":
        kw.update(gamma=cs.GAMMA, class_weights=cw)
    fn = getattr(mod_fe, EPOCH_FN[task])
    return lambda: fn(params, zt, zt, state, *rows, s, N_SITES, **kw)


def flat_out(x):
    """Every tensor of a nested result, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in flat_out(v)]
    return [t for v in x for t in flat_out(v)]


def probe_steps(dev, parent=None):
    """The train-step kernels B6 (tri-modal), B4 (DNA→RNA) and B1 (RNA→DNA)
    at the full width, B = 32, Philox noise: each wrapper call and its C
    entry alone (a step graph's launch, or an older tree's host-loop entry),
    back to back (CUDA events over 50 calls), one call at a time (median of
    30) and their host time (the enqueue, after the card has drained), the
    device µs by kernel and the kernels of one wrapper call
    (torch.profiler); the 200-step epochs (B2, B5, B7) of the 8000-sample
    cohort (median of 10, the turns twice over); ``engine.fit(fused_step=True)``
    over 3 epochs of the 1024-sample cohort after a warm-up epoch; the
    cProfile of 200 calls of each of this tree's wrappers (`host_profile`).
    With an older tree's root
    (``parent``: its ``vae_los_angeles_torch/`` unpacked with ``git
    archive`` into a gitignored directory), that tree's wrappers and library
    are timed in turns with this tree's (older, this, this, older), and each
    step's and epoch's results are compared bit for bit between the trees.
    One JSON line."""
    import json

    from vae_los_angeles_torch.data.splits import train_val_indices
    from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
    from vae_los_angeles_torch.training import engine
    from vae_los_angeles_torch.training.cli import compute_class_weights

    _build.build_all(cs.SOURCES)
    card = cs.card_line()
    mods = step_modules(parent)
    order = ["parent", "change", "change", "parent"] if parent is not None else ["change"] * 2
    inputs = step_inputs(dev)
    out = {"card": card}
    for task in STEP_TASKS:
        calls = {who: {"wrapper": cs.step_call(m[0], task, inputs[task]),
                       "c_entry": cs.c_entry(m[0], task, inputs[task])} for who, m in mods.items()}
        for who in order:
            for what, fn in calls[who].items():
                key = f"{task}_{who}_{what}"
                out.setdefault(key + "_loop_ms", []).append(time_ms(fn, 50))
                out.setdefault(key + "_call_ms", []).append(cs.time_call(fn))
                out.setdefault(key + "_host_ms", []).append(host_ms(fn))
        out[f"{task}_change_host_profile"] = host_profile(calls["change"]["wrapper"])
        for who, (mod, _) in mods.items():
            prof = device_us(calls[who]["wrapper"])
            out[f"{task}_{who}_device_us"] = sum(us for us, _ in prof.values())
            out[f"{task}_{who}_kernels"] = sum(k for _, k in prof.values())
            out[f"{task}_{who}_by_kernel"] = {k: [round(us, 2), n] for k, (us, n) in prof.items()}
            graphs = getattr(mod, "step_graphs", {})
            if task in graphs:
                g = graphs[task][1]
                out[f"{task}_{who}_graph_nodes"] = g.nodes
                out[f"{task}_{who}_capture_ms"] = g.capture_seconds * 1e3
        if parent is not None:
            for injected in (False, True):
                got = {who: cs.step_values(task, cs.step_call(
                    m[0], task, inputs[task], seed=2**40 + 3, step=5, injected=injected)())
                       for who, m in mods.items()}
                out[f"{task}_{'injected' if injected else 'philox'}_step_bits_equal"] = all(
                    torch.equal(a, b) for a, b in zip(got["parent"], got["change"]))

    tpm, beta, site = generate_synthetic_arrays(n_samples=8000, seed=1)
    tr, _ = train_val_indices(8000, cs.CFG.train_test_split, cs.CFG.random_seed)
    n = len(tr) // 32
    x, t, s = (torch.as_tensor(a[tr[: n * 32]]).to(dev) for a in (tpm, beta, site))
    cw = torch.as_tensor(compute_class_weights(s.cpu().numpy(), N_SITES)).to(dev)
    data = dict(inputs, rows=(x, t, s, cw, n))
    for task in STEP_TASKS:
        calls = {who: epoch_call(m[1], task, data) for who, m in mods.items()}
        for who in order + order:
            out.setdefault(f"{task}_{who}_epoch_ms", []).append(
                cs.time_call(calls[who], reps=10, warmup=1))
        if parent is not None:
            got = {who: flat_out(fn()) for who, fn in calls.items()}
            out[f"{task}_epoch_bits_equal"] = all(
                torch.equal(a, b) for a, b in zip(got["parent"], got["change"]))
    del x, t, s

    tpm, beta, site = generate_synthetic_arrays(n_samples=1024, seed=2)
    tr, va = train_val_indices(1024, cs.CFG.train_test_split, cs.CFG.random_seed)
    arrays = lambda idx: (tpm[idx], beta[idx], site[idx])  # noqa: E731
    for task in STEP_TASKS:
        tri = task == "multimodal"
        cwf = compute_class_weights(site[tr], N_SITES) if tri else None
        plain = engine.FUSED[task]

        def fit(mod, epochs):
            engine.FUSED[task] = plain._replace(step=getattr(mod, cs.STEP_FN[task]))
            try:
                return engine.fit(task, cs.CFG, arrays(tr), arrays(va), 0, N_SITES,
                                  num_epochs=epochs, device=dev, class_weights=cwf,
                                  fused_step=True)
            finally:
                engine.FUSED[task] = plain

        for who in order:
            mod = mods[who][0]
            fit(mod, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fit(mod, 3)
            torch.cuda.synchronize()
            out.setdefault(f"{task}_{who}_fit_step_epoch_ms", []).append(
                (time.perf_counter() - t0) * 1e3 / res.epochs_ran)
    print("[steps] " + json.dumps(out), flush=True)


def probe_pdl(dev):
    """What programmatic dependent launch buys: in turns (PDL, plain, plain,
    PDL; `cs.launch_mode`), the three step graphs' C entry
    alone (50 launches back to back, CUDA events) and the three 200-step
    epochs (the 8000-sample cohort, median of 5), each graph captured with
    its phases launched programmatically or as plain stream launches (where
    ``fe._EpochGraph``'s choice by task came from); one JSON line."""
    import json

    from vae_los_angeles_torch.data.splits import train_val_indices
    from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
    from vae_los_angeles_torch.training.cli import compute_class_weights

    _build.build_all(cs.SOURCES)
    card = cs.card_line()
    inputs = step_inputs(dev)
    tpm, beta, site = generate_synthetic_arrays(n_samples=8000, seed=1)
    tr, _ = train_val_indices(8000, cs.CFG.train_test_split, cs.CFG.random_seed)
    n = len(tr) // 32
    x, t, s = (torch.as_tensor(a[tr[: n * 32]]).to(dev) for a in (tpm, beta, site))
    cw = torch.as_tensor(compute_class_weights(s.cpu().numpy(), N_SITES)).to(dev)
    data = dict(inputs, rows=(x, t, s, cw, n))
    out = {"card": card}
    for pdl in (True, False, False, True):
        mode = "pdl" if pdl else "plain"
        with cs.launch_mode(pdl):
            for task in STEP_TASKS:
                entry = cs.c_entry(ft, task, inputs[task])
                out.setdefault(f"{task}_step_{mode}_ms", []).append(time_ms(entry, 50))
            for task in STEP_TASKS:
                out.setdefault(f"{task}_epoch_{mode}_ms", []).append(
                    cs.time_call(epoch_call(fe, task, data), reps=5, warmup=1))
            torch.cuda.synchronize()
    print("[pdl] " + json.dumps(out), flush=True)


PROBES = {"serving": probe_serving, "serving_calls": probe_serving_calls, "first": probe_first,
          "grads": probe_grads, "race": probe_race, "chain": probe_chain, "widths": probe_widths,
          "directional": probe_directional, "epoch64": probe_epoch64, "loss": probe_loss,
          "steps": probe_steps, "pdl": probe_pdl}


def main(argv):
    if (not argv or argv[0] not in PROBES
            or (len(argv) > 1 and argv[0] not in ("loss", "steps")) or len(argv) > 2):
        raise SystemExit(f"usage: python3 chip_probes.py {'|'.join(PROBES)} "
                         "(loss|steps [OLDER_TREE])")
    PROBES[argv[0]](cs.device_policy.require_cuda(), *argv[1:])


if __name__ == "__main__":
    main(sys.argv[1:])
