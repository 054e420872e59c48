"""The multi-device dry run (counterpart of
``__graft_entry__.dryrun_multichip``): every multi-device path of the port
once, at tiny shapes, on N ranks.

    python -m vae_los_angeles_torch.parallel.dryrun N [--backend gloo|nccl] [--device cpu]

In the JAX dry run's order: the DP × TP train step (a 2-way "model" axis
when N is even) with its bf16 and Adafactor variants; a fold population of
uneven folds sharded over the ranks (one masked population, the default);
the data-parallel fit; a sharded predict of 43 rows (an uneven
split); the data-parallel resume (rank 0 writes the carry, every rank reads
it after a barrier and trains on); the sharded kNN, silhouette, fused
scores, t-SNE, grid and multi-k; and the classifier population. Rank 0
prints one ``dryrun_multidevice OK: ...`` line with the JAX line's fields.

The ranks are this module's own processes (``comm.spawn``): NCCL puts rank
i on ``cuda:i``; gloo puts every rank on card 0 (several ranks on one card,
as on a one-card machine) or, with ``--device cpu``, on the CPU. Under
``python -m torch.distributed.run`` (``WORLD_SIZE`` set) it runs in the
launched ranks instead. Without a card and without ``--device cpu`` it
raises.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from vae_los_angeles_torch.parallel import comm


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run() -> dict:
    """Every leg on the ranks of the current process group; returns the
    line's fields (the same on every rank)."""
    from vae_los_angeles_torch.config import Config
    from vae_los_angeles_torch.evaluation.mlp_classifier import fit_classifier_folds
    from vae_los_angeles_torch.ops.cluster_metrics import cluster_scores, silhouette_score
    from vae_los_angeles_torch.ops.knn import KNNRegressor, knn_grid_mse
    from vae_los_angeles_torch.ops.tsne import TSNE
    from vae_los_angeles_torch.parallel import sharding, vmap_meta
    from vae_los_angeles_torch.training import checkpoint, engine

    device = comm.device()
    n_devices = comm.world()
    model_parallel = 2 if n_devices % 2 == 0 else 1
    mesh = sharding.make_mesh(n_devices, model_parallel=model_parallel)
    cfg = Config(input_dim_a=64, input_dim_b=96, latent_dim=8, batch_size=8,
                 platform=device.type)
    n_sites = 4
    params, state, opt = sharding.make_sharded_train_state("rna2dna", cfg, n_sites, mesh, 0,
                                                           device)
    n = cfg.batch_size * max(n_devices // model_parallel, 1)
    ones = (np.ones((n, cfg.input_dim_a), np.float32),
            np.full((n, cfg.input_dim_b), 0.5, np.float32), np.zeros(n, np.int64))
    batch = sharding.shard_arrays(ones, mesh, device)
    step = sharding.sharded_train_step("rna2dna")
    step_args = (5e-4, 1e-5, 1e-3, 1.0)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params, state, opt, loss = step(params, state, opt, batch, gen, *step_args)
    _sync(device)
    compile_and_step_s = time.perf_counter() - t0
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("sharded train step produced non-finite loss")
    t0 = time.perf_counter()
    params, state, opt, loss = step(params, state, opt, batch, gen, *step_args)
    _sync(device)
    steady_step_s = time.perf_counter() - t0

    variant_losses = {}
    for label, step_kw, cfg_v in (("bf16", dict(compute_dtype="bfloat16"), cfg),
                                  ("adafactor", dict(optimizer="adafactor"),
                                   cfg.replace(optimizer="adafactor"))):
        p_v, s_v, o_v = sharding.make_sharded_train_state("rna2dna", cfg_v, n_sites, mesh, 0,
                                                          device)
        step_v = sharding.sharded_train_step("rna2dna", **step_kw)
        _, _, _, loss_v = step_v(p_v, s_v, o_v, batch, gen, *step_args)
        if not bool(torch.isfinite(loss_v)):
            raise RuntimeError(f"sharded {label} train step produced non-finite loss")
        variant_losses[label] = float(loss_v)

    pop_mesh = vmap_meta.population_mesh()
    if pop_mesh is not None:
        arrays = (np.ones((48, cfg.input_dim_a), np.float32),
                  np.full((48, cfg.input_dim_b), 0.5, np.float32), np.zeros(48, np.int64))
        take = lambda idx: tuple(a[idx] for a in arrays)  # noqa: E731
        # three uneven folds, one masked population (no 1-row final batch)
        folds = [take(np.arange(i, 40)) for i in range(3)]
        vals = [take(np.arange(40, 48 - i)) for i in range(3)]
        fits = vmap_meta.fit_folds("rna2dna", cfg, folds, vals, 0, n_sites, num_epochs=1,
                                   mesh=pop_mesh, device=device)
        if not all(np.isfinite(f.val_losses[0]) for f in fits):
            raise RuntimeError("sharded fold population produced non-finite val loss")

        dp_fit = engine.fit("rna2dna", cfg, take(np.arange(40)), take(np.arange(40, 48)), 0,
                            n_sites, num_epochs=1, mesh=pop_mesh, device=device)
        if not np.isfinite(dp_fit.val_losses[0]):
            raise RuntimeError("data-parallel fit produced non-finite val loss")

        preds = engine.predict("rna2dna", dp_fit.params, dp_fit.state, take(np.arange(43)),
                               mesh=pop_mesh, device=device)
        if preds.shape[0] != 43 or not bool(torch.isfinite(preds).all()):
            raise RuntimeError("sharded predict produced a bad output")

        made = tempfile.mkdtemp(prefix="dryrun_") if comm.is_writer() else None
        ckpt_dir = comm.gather_objects(made)[0]
        checkpoint.save_resume("rna2dna", "dryrun", comm.to_numpy_tree(dp_fit.carry), 1,
                               ckpt_dir, seed=0)
        carry, epochs_done, _, _ = checkpoint.load_resume("rna2dna", "dryrun", ckpt_dir)
        dp_resumed = engine.fit("rna2dna", cfg, take(np.arange(40)), take(np.arange(40, 48)), 0,
                                n_sites, num_epochs=1, resume_carry=carry,
                                start_epoch=epochs_done, mesh=pop_mesh, device=device)
        if not np.isfinite(dp_resumed.val_losses[0]):
            raise RuntimeError("sharded resume continuation produced non-finite val loss")
        comm.barrier()
        if made is not None:
            shutil.rmtree(made)

        rng = np.random.default_rng(0)
        xk = rng.normal(size=(50, 12)).astype(np.float32)
        yk = rng.normal(size=(50, 3)).astype(np.float32)
        knn = KNNRegressor(n_neighbors=5, shard=True, device=device).fit(xk, yk)
        if knn._mesh is None or not np.isfinite(knn.predict(xk[:9])).all():
            raise RuntimeError("sharded kNN did not take the mesh or gave non-finite values")
        sil = silhouette_score(xk, rng.integers(0, 3, 50), chunk_size=16, shard=True,
                               device=device)
        fsil, fnh = cluster_scores(xk, rng.integers(0, 3, 50), chunk_size=16, shard=True,
                                   device=device)
        if not (np.isfinite(sil) and np.isfinite(fsil) and np.isfinite(fnh)):
            raise RuntimeError("sharded silhouette or fused scores non-finite")
        emb = TSNE(perplexity=8.0, max_iter=12, shard=True, device=device).fit_transform(xk)
        if emb.shape != (50, 2) or not np.isfinite(emb).all():
            raise RuntimeError("sharded t-SNE produced a bad embedding")
        grid = knn_grid_mse(xk, yk, xk[:9], yk[:9], ks=(3, 5), modes=("uniform", "distance"),
                            shard=True, device=device)
        if len(grid) != 4 or not all(np.isfinite(v) for v in grid.values()):
            raise RuntimeError("sharded fused grid produced non-finite MSEs")
        multi = knn.predict_multi_k(xk[:9], (3, 5))
        if set(multi) != {3, 5} or not all(np.isfinite(v).all() for v in multi.values()):
            raise RuntimeError("sharded multi-k sweep produced non-finite predictions")

        xc = rng.normal(size=(60, 20)).astype(np.float32)
        yc = rng.integers(0, 3, 60)
        cwc = np.ones(3, np.float32)
        cls_fit = fit_classifier_folds([(xc[:40], yc[:40], xc[40:], yc[40:], cwc),
                                        (xc[20:], yc[20:], xc[:20], yc[:20], cwc)], 3,
                                       num_epochs=2, device=device)
        if cls_fit.best_val_acc.shape[0] != 2 or not np.isfinite(cls_fit.best_val_acc).all():
            raise RuntimeError("sharded classifier population produced non-finite accuracy")

    fields = {"mesh": dict(mesh.shape), "loss": float(loss),
              "step_compile+run": compile_and_step_s, "step_ms": steady_step_s * 1e3,
              **{f"{k}_loss": v for k, v in variant_losses.items()}}
    if comm.is_writer():
        print(f"dryrun_multidevice OK: mesh={fields['mesh']} loss={fields['loss']:.2f} "
              f"step_compile+run={compile_and_step_s:.3f}s step={steady_step_s * 1e3:.2f}ms "
              + " ".join(f"{k}_loss={v:.2f}" for k, v in variant_losses.items())
              + " dp_resume=ok sharded_eval=ok sharded_classifier=ok", flush=True)
    return fields


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="multi-device dry run of the port")
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                        help="default: NCCL on cards, gloo on the CPU")
    parser.add_argument("--device", choices=["cpu"], default=None,
                        help="run the ranks on the CPU (gloo)")
    args = parser.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # launched by torch.distributed.run
        comm.ensure_group(args.device)
        if comm.world() != args.n_devices:
            raise SystemExit(f"{comm.world()} ranks launched for a dry run of {args.n_devices}")
        return run()
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False; the dry run "
                           "runs on cards unless asked for the CPU (--device cpu)")
    device = "cpu" if args.device == "cpu" else (None if backend == "nccl" else "cuda:0")
    return comm.spawn(run, args.n_devices, backend, device)[0]


if __name__ == "__main__":
    main()
