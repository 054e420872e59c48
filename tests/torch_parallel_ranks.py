"""Rank programs of the port's multi-device CPU tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_sharded_eval.py``).

Each runs in a gloo world started by ``parallel.comm.spawn``: fresh
processes with one torch thread each that import this module, torch and the
port, never jax or the tests' conftest. A program computes every result its
test module compares at once and returns it as numpy; `shared_result` runs a
world once a test session, however many xdist workers ask for it.
"""

import fcntl
import os
import pickle

import numpy as np
import torch

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data.synthetic import generate_synthetic_arrays
from vae_los_angeles_torch.parallel import comm

DIM_A, DIM_B, N_SITES, LATENT, EMBED, BATCH = 21, 29, 5, 6, 16, 16
DIMS = dict(input_dim_a=DIM_A, input_dim_b=DIM_B, latent_dim=LATENT, embed_dim=EMBED,
            batch_size=BATCH)
TASKS = ["rna2dna", "dna2rna", "rna2dna_ae", "dna2rna_ae", "multimodal", "multimodal_padded",
         "rna2dna_unified", "dna2rna_unified"]
LR, STEPS = 5e-4, 2
POP = {"lr": np.array([1e-3, 5e-4, 2e-3], np.float32),
       "weight_decay": np.array([1e-5, 1e-4, 1e-6], np.float32)}


def shared_result(tmp_path_factory, name, compute):
    """``compute()``'s picklable result, computed by the first process of
    the session that asks and read back by the others (a file lock in the
    session's temp root, shared by the xdist workers)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path, lock = root / f"{name}.pkl", root / f"{name}.lock"
    with open(lock, "w") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        if not path.exists():
            result = compute()
            with open(path, "wb") as f:
                pickle.dump(result, f)
    with open(path, "rb") as f:
        return pickle.load(f)


def cfg(**kw) -> Config:
    return Config(**{**DIMS, "platform": "cpu", **kw})


def cohort(n=200, seed=3):
    return generate_synthetic_arrays(n_samples=n, dim_a=DIM_A, dim_b=DIM_B, n_sites=N_SITES,
                                     seed=seed)


def cv_folds(data, n_folds=3):
    """The CV's inner (train, validation) triples of each fold."""
    from vae_los_angeles_torch.data.splits import cv_inner_split, kfold_indices

    tr, va = [], []
    for train_index, _ in kfold_indices(len(data[0]), n_folds):
        a, b = cv_inner_split(train_index)
        tr.append(tuple(x[a] for x in data))
        va.append(tuple(x[b] for x in data))
    return tr, va


def split(data):
    """(train, validation) triples: the first 160 rows and the rest."""
    return tuple(x[:160] for x in data), tuple(x[160:] for x in data)


def np_tree(tree):
    return comm.to_numpy_tree(tree)


def fit_record(res):
    return {"val": res.val_losses, "train": res.train_losses, "params": np_tree(res.params),
            "state": np_tree(res.state), "epochs": res.epochs_ran}


def first_grads(mesh, batch_size: int):
    """Loss and gradients of the first training step of a fit's epoch 0
    (its shuffle and noise) on this mesh (None: the single device)."""
    from vae_los_angeles_torch.parallel.sharding import Mesh, sharded_loss_and_grads
    from vae_los_angeles_torch.training import engine
    from vae_los_angeles_torch.training.tasks import get_task

    task = get_task("rna2dna")
    tr, _ = split(cohort())
    params, state = task.init(torch.Generator().manual_seed(0), cfg(), N_SITES, "cpu")
    train = engine._as_batch(tr, "cpu")
    gen, perm = engine.epoch_noise(0, 0, len(train), "cpu")
    idx = perm[:batch_size]
    mesh = mesh or Mesh(1, 1)
    lo, hi = mesh.row_range(len(idx))
    loss, grads, _ = sharded_loss_and_grads(task, params, state, train.take(idx[lo:hi]), 1e-3,
                                            gen, mesh, len(idx), split=False)
    return float(loss), np_tree(grads)


def dp_fits(mesh):
    """The data-parallel (or, without a mesh, single-device) fits the tests
    compare: batches that divide by two ranks and ones that do not, a
    resume, a predict of 43 rows."""
    from vae_los_angeles_torch.training import checkpoint, engine
    from vae_los_angeles_torch.training.tasks import get_task

    data = cohort()
    tr, va = split(data)
    out = {}
    for name, kw in (("even", dict(drop_last=True)), ("uneven", dict(drop_last=False))):
        c = cfg() if name == "even" else cfg(batch_size=15)
        out[f"fit_{name}"] = fit_record(engine.fit("rna2dna", c, tr, va, 0, N_SITES,
                                                   num_epochs=2, mesh=mesh, device="cpu",
                                                   **kw))
    out["grads"] = first_grads(mesh, 15)
    res = engine.fit("multimodal", cfg(), tr, va, 1, N_SITES, num_epochs=2, mesh=mesh,
                     device="cpu", class_weights=np.ones(N_SITES, np.float32))
    out["fit_multimodal"] = fit_record(res)
    params, state = get_task("rna2dna").init(torch.Generator().manual_seed(4), cfg(), N_SITES,
                                             "cpu")
    state["encoder_rna"]["bn"] = {"mean": torch.full((128,), 0.1), "var": torch.full((128,), 2.0)}
    out["predict"] = engine.predict("rna2dna", params, state, tuple(x[:43] for x in data),
                                    seed=5, mesh=mesh, device="cpu").numpy()
    out["predict_chunked"] = engine.predict("rna2dna", params, state,
                                            tuple(x[:43] for x in data), seed=5, mesh=mesh,
                                            chunk_size=20, device="cpu")
    first = engine.fit("rna2dna", cfg(), tr, va, 0, N_SITES, num_epochs=1, mesh=mesh,
                       device="cpu")
    ckpt = os.environ["PARALLEL_TEST_DIR"] + f"/resume_{comm.world()}"
    checkpoint.save_resume("rna2dna", "r", np_tree(first.carry), 1, ckpt, seed=0)
    carry, done, _, _ = checkpoint.load_resume("rna2dna", "r", ckpt)
    out["resumed"] = fit_record(engine.fit("rna2dna", cfg(), tr, va, 0, N_SITES, num_epochs=1,
                                           resume_carry=carry, start_epoch=done, mesh=mesh,
                                           device="cpu"))
    out["two_epochs"] = fit_record(engine.fit("rna2dna", cfg(), tr, va, 0, N_SITES,
                                              num_epochs=2, mesh=mesh, device="cpu"))
    return out


def populations(mesh):
    """A fold population (3 folds, 4 epochs) in exact-shape groups and the
    same folds as one masked population (the default), and a trial
    population (3 trials, 2 epochs, masked) on this mesh (None: one
    device)."""
    from vae_los_angeles_torch.parallel import vmap_meta

    data = cohort()
    tr, va = cv_folds(data)
    folds = vmap_meta.fit_folds("rna2dna", cfg(), tr, va, 0, N_SITES, num_epochs=4,
                                drop_last=False, mask_sizes=False, mesh=mesh, device="cpu")
    masked = vmap_meta.fit_folds("dna2rna", cfg(), tr, va, 0, N_SITES, num_epochs=2,
                                 drop_last=False, mask_sizes=True, mesh=mesh, device="cpu")
    t, v = split(data)
    trials = vmap_meta.fit_trials("multimodal", cfg(), t, v, 0, N_SITES, POP, num_epochs=2,
                                  seeds=[11, 12, 13], mesh=mesh, device="cpu")
    return {"folds": [fit_record(r) for r in folds],
            "masked_folds": [fit_record(r) for r in masked],
            "trials": [fit_record(r) for r in trials]}


def cli_dp(workdir):
    """``--dp`` through ``run_training`` in ``workdir``: the files written
    and the printed report (rank 0's)."""
    import contextlib
    import io

    from vae_los_angeles_torch.training.cli import run_training

    c = cfg(checkpoint_dir=os.path.join(workdir, "checkpoints"),
            plots_dir=os.path.join(workdir, "plots"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result, run_id, _ = run_training("rna2dna", "rna2dna", cfg=c,
                                         argv=["--dp", "--epochs", "2"], data=cohort(),
                                         device="cpu", root=workdir)
    comm.barrier()
    files = sorted(os.path.relpath(os.path.join(d, f), workdir)
                   for d, _, fs in os.walk(workdir) for f in fs)
    return {"stdout": out.getvalue(), "files": files, "val": result.val_losses,
            "run_id": run_id}


def imported():
    """Modules of jax, the JAX package or the tests' conftest in this rank."""
    import sys

    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "vae_los_angeles_tpu", "conftest"))


def routes():
    """The group's routes, and an all-gather, a broadcast and the axis
    index through them."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * comm.rank()
    want = torch.cat([torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
                      for r in range(comm.world())], 1)
    return {"table": comm.routes(), "gathered": comm.all_gather(t, 1).numpy(),
            "want": want.numpy(), "broadcast": comm.broadcast(t, src=1).numpy(),
            "axis_index": comm.axis_index()}


def world2():
    """Every world-2 result of ``tests/test_torch_parallel.py``."""
    from vae_los_angeles_torch.parallel import sharding, vmap_meta

    mesh = vmap_meta.population_mesh()
    out = {"rank": comm.rank(), "dp": dp_fits(mesh), "pops": populations(mesh),
           "routes": routes(), "imported": imported()}
    sub = [[0, 1], [2, 2]][comm.rank()]  # this rank's members of the padded population
    data = cohort()
    tr, va = cv_folds(data)
    seeds = vmap_meta.member_seeds(0, 3) + vmap_meta.member_seeds(0, 3)[-1:]
    alone = vmap_meta.fit_folds("rna2dna", cfg(), [tr[i] for i in sub], [va[i] for i in sub],
                                0, N_SITES, num_epochs=4, drop_last=False, mask_sizes=False,
                                seeds=[seeds[i] for i in sub], device="cpu")
    t, v = split(data)
    alone_trials = vmap_meta.fit_trials(
        "multimodal", cfg(), t, v, 0, N_SITES, {k: x[sub] for k, x in POP.items()},
        num_epochs=2, seeds=[[11, 12, 13][i] for i in sub], device="cpu")
    out["alone"] = {"folds": [fit_record(r) for r in alone],
                    "trials": [fit_record(r) for r in alone_trials], "members": sub}
    workdir = comm.gather_objects(os.environ["PARALLEL_TEST_DIR"] + "/cli_world2")[0]
    os.makedirs(workdir, exist_ok=True)
    out["cli"] = cli_dp(workdir)
    try:
        sharding.make_mesh(model_parallel=3)
    except ValueError as e:
        out["mp3"] = str(e)
    return out


def tp_steps(mesh, runs=None):
    """Two steps of the DP × TP step (or, without a mesh, the single-device
    step) of every task from the same weights, batch and generator, and of
    its bf16 and Adafactor variants for two tasks: the losses of both steps,
    the parameters (gathered whole) and state after the first."""
    from vae_los_angeles_torch.ops import nn as ops_nn
    from vae_los_angeles_torch.ops import optim
    from vae_los_angeles_torch.parallel import sharding
    from vae_los_angeles_torch.training import engine
    from vae_los_angeles_torch.training.tasks import get_task

    data = cohort(n=37, seed=2)
    out = {}
    if runs is None:
        runs = [(t, "float32", "adamw") for t in TASKS]
        runs += [(t, dtype, opt) for t in ("rna2dna", "dna2rna_ae")
                 for dtype, opt in (("bfloat16", "adamw"), ("float32", "adafactor"))]
    for task, dtype, optimizer in runs:
        params, state = get_task(task).init(torch.Generator().manual_seed(1), cfg(), N_SITES,
                                            "cpu")
        step = sharding.sharded_train_step(task, compute_dtype=dtype, optimizer=optimizer)
        opt_init = optim.OPTIMIZERS[optimizer][0]
        if mesh is None:
            p, o, batch = params, opt_init(params), data
        else:
            p = sharding.shard_params(params, mesh)
            o = opt_init(params if optimizer == "adafactor" else p)
            batch = sharding.shard_arrays(data, mesh, "cpu")
        if mesh is None:  # the first step's gradients, for the test's Adam rule
            _, grads, _ = sharding.sharded_loss_and_grads(
                get_task(task), params, state, engine._as_batch(data, "cpu"), 0.5,
                torch.Generator().manual_seed(9), sharding.Mesh(1, 1), len(data[0]),
                ops_nn.resolve_compute_dtype(dtype), gamma=1.0,
                class_weights=torch.ones(N_SITES))
            out[("grads",) + (task, dtype, optimizer)] = np_tree(grads)
        gen = torch.Generator().manual_seed(9)
        losses = []
        for i in range(STEPS):
            p, state, o, loss = step(p, state, o, batch, gen, LR, 1e-5, 0.5, 1.0,
                                     np.ones(N_SITES, np.float32))
            losses.append(float(loss))
            if i == 0:
                first = {"params": np_tree(p if mesh is None
                                           else sharding.gather_params(p, mesh)),
                         "state": np_tree(state)}
        out[(task, dtype, optimizer)] = {"losses": losses, **first}
    return out


def world4():
    """Every world-4 result: the 2 x 2 DP × TP steps, the whole tree of a
    split step written by rank 0 and read back, and the dry run."""
    from vae_los_angeles_torch.parallel import dryrun, sharding
    from vae_los_angeles_torch.training import checkpoint

    mesh = sharding.make_mesh(4, model_parallel=2)
    out = {"steps": tp_steps(mesh), "mesh": (mesh.data_index, mesh.model_index)}
    # 4-way: a split 512-wide layer is 128 wide on a rank, as RNA2DNAAE's narrow one
    out["steps_mp4"] = tp_steps(sharding.make_mesh(4, model_parallel=4),
                                [(t, "float32", "adamw") for t in ("rna2dna_ae", "dna2rna_ae")])
    path = comm.gather_objects(os.environ["PARALLEL_TEST_DIR"] + "/tp_ckpt.npz")[0]
    whole = out["steps"][("rna2dna", "float32", "adamw")]
    checkpoint.save(path, whole["params"], whole["state"])
    params, _ = checkpoint.load(path)
    out["checkpoint"] = params
    out["dryrun"] = dryrun.run()
    return out


# --- the sharded evaluation programs ------------------------------------------------

def _blobs(n, dim, n_labels, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_labels, n)
    centers = rng.normal(size=(n_labels, dim)) * 3.0
    return (centers[labels] + rng.normal(size=(n, dim))).astype(np.float32), labels


def eval_inputs():
    """The inputs of every sharded evaluation program the tests hold (n = 123,
    203, 83 and 77 do not divide by two ranks, nor 20 by three; k = 12 is
    more than the 10 or 7 local rows of 20)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(123, 17)).astype(np.float32)
    y = rng.normal(size=(123, 3)).astype(np.float32)
    q = np.concatenate([rng.normal(size=(34, 17)).astype(np.float32), x[[3, 40, 100]]])
    sites = rng.integers(0, 4, 123)
    q_sites = np.concatenate([rng.integers(0, 4, 36), [9]])  # 9: a site never fitted
    blobs, labels = _blobs(203, 19, 5, seed=203)
    tsne_x, _ = _blobs(83, 12, 4, seed=83)
    y0 = (np.random.RandomState(3).standard_normal((83, 2)) * 1e-4).astype(np.float32)
    return {"x": x, "y": y, "q": q, "xc": np.column_stack([x, sites]).astype(np.float32),
            "qc": np.column_stack([q, q_sites]).astype(np.float32),
            "yv": rng.normal(size=(37, 3)).astype(np.float32), "blobs": blobs,
            "labels": labels, "tsne_x": tsne_x, "y0": y0}


def eval_programs(shard):
    """Every sharded evaluation program's output (``shard=None`` in a world
    of two or more ranks; ``False`` for the single-device programs)."""
    from vae_los_angeles_torch.ops import cluster_metrics as cm
    from vae_los_angeles_torch.ops import knn, pca, tsne

    d = eval_inputs()
    x, y, q = d["x"], d["y"], d["q"]
    out = {}
    for w in ("uniform", "distance"):
        for metric in ("euclidean", "manhattan"):
            est = knn.KNNRegressor(7, weights=w, metric=metric, shard=shard, device="cpu")
            out[f"knn/{w}/{metric}"] = est.fit(x, y).predict(q)
            cond = knn.ConditionedKNNRegressor(7, weights=w, metric=metric, shard=shard,
                                               device="cpu")
            out[f"cknn/{w}/{metric}"] = cond.fit(d["xc"], y).predict(d["qc"])
    out["knn/k_over_local"] = knn.KNNRegressor(12, shard=shard, device="cpu").fit(
        x[:20], y[:20]).predict(q)
    out["knn/zero_distance"] = knn.KNNRegressor(5, weights="distance", shard=shard,
                                                device="cpu").fit(x, y).predict(x[[3, 40, 100]])
    multi = knn.KNNRegressor(5, weights="distance", shard=shard, device="cpu").fit(x, y)
    for k, v in multi.predict_multi_k(q, (3, 5, 9)).items():
        out[f"multi/{k}"] = v
    modes = ("uniform", "distance")
    grid = knn.knn_grid_mse(x, y, q, d["yv"], (3, 5, 9), modes, chunk_size=16, shard=shard,
                            device="cpu")
    cgrid = knn.knn_grid_mse(d["xc"], y, d["qc"], d["yv"], (3, 5), modes, conditioned=True,
                             shard=shard, device="cpu")
    out["grid"] = np.array([grid[key] for key in sorted(grid, key=str)])
    out["cgrid"] = np.array([cgrid[key] for key in sorted(cgrid, key=str)])
    blobs, labels = d["blobs"], d["labels"]
    out["silhouette"] = cm.silhouette_score(blobs, labels, chunk_size=64, shard=shard,
                                            device="cpu")
    out["silhouette_compensated"] = cm.silhouette_score(blobs, labels, chunk_size=64,
                                                        shard=shard, compensated=True,
                                                        device="cpu")
    out["nh"] = cm.neighborhood_hit(blobs[:77], labels[:77], k=11, chunk_size=50, shard=shard,
                                    device="cpu")
    out["scores"] = np.array(cm.cluster_scores(blobs, labels, k=5, chunk_size=50, shard=shard,
                                               device="cpu"))
    for name, dim in (("pca", 93), ("pca_even", 96)):
        est = pca.PCA(2, shard=shard, device="cpu")
        out[name] = est.fit_transform(pca.standardize(torch.as_tensor(wide(blobs, dim))))
        out[name + "_evr"] = est.explained_variance_ratio_
    for it in (0, 5):
        est = tsne.TSNE(perplexity=20.0, max_iter=it, init=d["y0"], shard=shard, device="cpu")
        out[f"tsne/{it}"] = est.fit_transform(d["tsne_x"])
        out[f"tsne_kl/{it}"] = est.kl_divergence_
    return out


def wide(blobs, dim):
    """(110, dim) rows: the blobs' first 110 rows, columns repeated with a
    per-column shift so that the width does not divide evenly."""
    reps = -(-dim // blobs.shape[1])
    wide = np.tile(blobs[:110], (1, reps))[:, :dim]
    return (wide + np.arange(dim, dtype=np.float32)[None, :] * 0.01).astype(np.float32)


def eval_world():
    return {"rank": comm.rank(), "out": eval_programs(None)}
