"""Diagnostic probes of the training kernels on one NVIDIA GPU.

    python3 chip_probes.py first|grads|race|chain

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
    stage.
"""

from __future__ import annotations

import ctypes
import sys
import time

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
        got = ft._launch_step(flat, {"mean": rm, "var": rv}, x, t, site, eps, drop, False, 0, 0,
                              1e-3)
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
    print("step ms", time_ms(lambda: ft._launch_step(flat, {"mean": rm, "var": rv}, x, t, site,
                                                       None, None, True, 0, 0, 1e-3)))
    print("plain step ms", time_ms(lambda: ft.rna2dna_train_step_reference(
        flat, rm, rv, x, t, site, ee[:32], de[:32], 1e-3)))
    print("epoch25 ms", time_ms(lambda: fe._launch_epoch(
        flat, zeros, zeros, {"mean": rm, "var": rv}, xe, te, se, None, None, True, 0, 1e-3, 5e-4,
        1e-5, 0, n), 5))


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    lib = ft.library()
    params, state = cs.train_params(dev, 1)
    flat, bn = ft.flatten_params(params), state["encoder_rna"]["bn"]
    r = cs.train_rows(dev, batch, batch)
    _, hid, lat, _, emb, d1, d2, out = ft.dims_of(flat)
    dims = (ctypes.c_int * 8)(*ft.dims_of(flat))
    p, loss = ft.pack(flat), torch.empty(1, device=dev)
    g = torch.empty_like(p)
    rm, rv = torch.empty_like(bn["mean"]), torch.empty_like(bn["var"])
    work = torch.full((lib.rna2dna_train_workspace_floats(dims, batch, 0),), float("nan"),
                      device=dev)
    err = lib.rna2dna_train_step(
        r["x"].data_ptr(), r["t"].data_ptr(), r["site"].data_ptr(), p.data_ptr(), dims, batch,
        bn["mean"].data_ptr(), bn["var"].data_ptr(), rm.data_ptr(), rv.data_ptr(),
        r["eps"].data_ptr(), r["drop"].data_ptr(), ft.NOISE_INJECTED, 0, 0, 1e-3,
        loss.data_ptr(), g.data_ptr(), work.data_ptr(), 0)
    torch.cuda.synchronize()
    ft.raise_on(lib, err, "rna2dna_train_step")
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
    G = {k: v.double() for k, v in ft.unpack(g, flat).items()}
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


PROBES = {"first": probe_first, "grads": probe_grads, "race": probe_race, "chain": probe_chain}


def main(argv):
    if len(argv) != 1 or argv[0] not in PROBES:
        raise SystemExit(f"usage: python3 chip_probes.py {'|'.join(PROBES)}")
    PROBES[argv[0]](cs.device_policy.require_cuda())


if __name__ == "__main__":
    main(sys.argv[1:])
