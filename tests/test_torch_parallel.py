"""The port's multi-device training against its single-device runs and the
JAX package's sharded programs, on the CPU: gloo worlds of 2 ranks and of
4 ranks (2 x 2) started by ``parallel.comm.spawn`` (``torch_parallel_ranks``
holds their programs; each world runs once a session), the JAX side on the
conftest's virtual 8-device mesh.

Tolerances:
  * the DP x TP step against the single-device step from the same weights,
    batch and generator: the losses of two steps rtol 1e-5, the parameters
    after the first atol 1e-5, the JAX package's own
    (``tests/test_parallel.py``, one step), for every task. Adam's first
    step is lr·g/(|g| + 1e-8), ±lr but where g is within rounding of 0: an
    entry whose single-device gradient lies within the gradient tolerance
    of 0 (1e-5 of its tensor's largest |g|: a sum that cancels, as in the
    encoder biases that feed train-mode BatchNorm, whose true gradient is
    0, ROADMAP C, and rarely active hidden units) may take the other sign
    under another order of the sums, so those entries are held within 2·lr.
    From the second step on, Adam amplifies rounding wherever a moment
    cancels, which is why the parameters are held after the first. The bf16
    variant's products round their operands to bf16, where an activation on
    the other side of a rounding boundary flips a small gradient's sign:
    its parameters are held within 2·lr, its first loss at rtol 1e-5 and its
    second (after those steps) at rtol 1e-4;
  * the data-parallel fit against the single-device fit of the same seed:
    the first step's gradients within 1e-5 of each tensor's largest |g|,
    validation losses within 1e-3 relative over 2 epochs, the pre-BN biases
    within 2·lr·steps;
  * a sharded population member against its sub-population run alone: bit
    for bit; the fold population's final validation losses within rtol 0.05
    of JAX's sharded population (``tests/test_torch_cv.py``'s rule: JAX
    draws threefry noise, the port torch generators);
  * a sharded predict and the DP resume: equal to the single call and to
    the uninterrupted run, bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from vae_los_angeles_torch.ops import nn as ops_nn
from vae_los_angeles_torch.parallel import comm, sharding, vmap_meta
from vae_los_angeles_torch.training import engine, tasks
from vae_los_angeles_tpu.config import Config as JaxConfig
from vae_los_angeles_tpu.data.dataset import MultiModalArrays
from vae_los_angeles_tpu.parallel import sharding as jax_sharding
from vae_los_angeles_tpu.parallel import vmap_meta as jax_vm
from vae_los_angeles_tpu.training.tasks import TASKS as JAX_TASKS

torch.set_num_threads(1)

HAZARD = 2 * ranks.LR  # pre-BN bias drift bound of one TP step
FIT_HAZARD = 2 * 1e-3 * 20  # the fits: lr 1e-3, at most 20 steps


def _spawned(tmp_path_factory, name, world, fn):
    def compute():
        workdir = tmp_path_factory.mktemp(name)
        os.environ["PARALLEL_TEST_DIR"] = str(workdir)
        try:
            return comm.spawn(fn, world, "gloo", "cpu")
        finally:
            del os.environ["PARALLEL_TEST_DIR"]

    return ranks.shared_result(tmp_path_factory, name, compute)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawned(tmp_path_factory, "parallel_world2", 2, ranks.world2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawned(tmp_path_factory, "parallel_world4", 4, ranks.world4)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    def compute():
        workdir = tmp_path_factory.mktemp("parallel_single")
        os.environ["PARALLEL_TEST_DIR"] = str(workdir)
        try:
            return {"dp": ranks.dp_fits(None), "pops": ranks.populations(None),
                    "steps": ranks.tp_steps(None)}
        finally:
            del os.environ["PARALLEL_TEST_DIR"]

    return ranks.shared_result(tmp_path_factory, "parallel_single", compute)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), np.asarray(tree, np.float64)


def _pre_bn_biases(task):
    """The names of the biases that feed train-mode BatchNorm in a task."""
    params, _ = tasks.get_task(task).init(torch.Generator().manual_seed(0), ranks.cfg(),
                                          ranks.N_SITES, "cpu")
    names = {name for name, _ in _leaves(params)}
    out = set()
    for name in names:
        head, _, leaf = name.rpartition("/")
        module, _, layer = head.rpartition("/")
        prefix = f"{module}/" if module else ""
        bns = {layer.replace("fc", "bn")} | ({"enc_bn"} if layer == "enc_fc1" else set())
        if leaf == "b" and any(f"{prefix}{bn}/gamma" in names for bn in bns):
            out.add(name)
    return out


def _close_trees(got, want, atol, hazard_names=(), hazard=0.0, what="", grads=None):
    """Every leaf within ``atol``; a leaf in ``hazard_names`` within
    ``hazard`` more, and with ``grads`` (the single-device gradients) so is
    every entry whose gradient is within 1e-5 of its tensor's largest |g|
    of 0 (module docstring)."""
    small = dict(_leaves(grads)) if grads is not None else {}
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        tol = hazard + atol if name in hazard_names else atol
        err = np.abs(a - b)
        if name in small:
            g = np.abs(small[name])
            err = np.where(g <= 1e-5 * g.max(), np.maximum(err - hazard, 0.0), err)
        err = float(err.max()) if a.size else 0.0
        assert err <= tol, f"{what} {name}: {err} > {tol}"


# --- the mesh and the Megatron table ---------------------------------------------------

@pytest.mark.parametrize("task", ["rna2dna", "dna2rna", "rna2dna_ae", "dna2rna_ae",
                                  "multimodal"])
def test_param_specs_equal_jax(task):
    """Five model families at the 512-wide TP layers: the port's column/row
    table is JAX's, the narrow RNA2DNAAE encoder replicated."""
    from jax.sharding import PartitionSpec as P

    params, _ = tasks.get_task(task).init(torch.Generator().manual_seed(0), ranks.cfg(),
                                          ranks.N_SITES, "meta")
    jax_params, _ = JAX_TASKS[task].init(jax.random.PRNGKey(0), JaxConfig(**ranks.DIMS),
                                         ranks.N_SITES)
    want = {"col": P(None, "model"), "row": P("model"), "rep": P()}
    specs = sharding.param_specs(params)
    jax_specs = jax_sharding.param_specs(jax_params)

    def walk(port, jx, path=""):
        if isinstance(port, dict):
            assert set(port) == set(jx), path
            for k in port:
                walk(port[k], jx[k], f"{path}/{k}")
            return
        if port == "col" and path.endswith("/b"):
            assert jx == P("model"), path
        else:
            assert jx == want[port], (path, port, jx)

    walk(specs, jax_specs)
    split = {name for name, s in _flat_specs(specs) if s != "rep"}
    if task == "rna2dna_ae":
        assert not any(name.startswith("enc_fc") for name in split)
    if task in ("dna2rna", "dna2rna_ae", "multimodal"):
        assert split  # the 512-wide encoder is split


def _flat_specs(specs, prefix=""):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from _flat_specs(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_make_mesh_layout_and_refusals(world4, world2):
    assert [r["mesh"] for r in world4] == [(0, 0), (0, 1), (1, 0), (1, 1)]  # JAX grid order
    assert world2[0]["mp3"] == world2[1]["mp3"] == "model_parallel=3 must divide 2 devices"
    mesh = sharding.make_mesh()
    assert mesh.size == 1 and mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="model_parallel=2 must divide 1 devices"):
        sharding.make_mesh(model_parallel=2)
    assert vmap_meta.population_mesh() is None


# --- the sharded step ----------------------------------------------------------------

@pytest.mark.parametrize("run", [(t, "float32", "adamw") for t in ranks.TASKS]
                         + [(t, "bfloat16", "adamw") for t in ("rna2dna", "dna2rna_ae")]
                         + [(t, "float32", "adafactor") for t in ("rna2dna", "dna2rna_ae")],
                         ids=lambda r: "-".join(r))
def test_dp_tp_step_equals_single_device_step(world4, single, run):
    want = single["steps"][run]
    biases = _pre_bn_biases(run[0])  # |a step| <= lr (AdamW; Adafactor's first)
    means = {n for n, _ in _leaves(want["state"]) if n.endswith("/mean")} if biases else set()
    bf16 = run[1] == "bfloat16"
    grads = single["steps"][("grads",) + run]
    for r in world4:
        got = r["steps"][run]
        np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=1e-5)
        np.testing.assert_allclose(got["losses"][1:], want["losses"][1:],
                                   rtol=1e-4 if bf16 else 1e-5)
        _close_trees(got["params"], want["params"], HAZARD if bf16 else 1e-5, biases, HAZARD,
                     f"{run} params", grads)
        # a running mean follows its pre-BN bias
        _close_trees(got["state"], want["state"], 1e-5, means, HAZARD, f"{run} state")


@pytest.mark.parametrize("task", ["rna2dna_ae", "dna2rna_ae"])
def test_four_way_tensor_parallel_step(world4, single, task):
    """A 1 x 4 mesh: DNA2RNAAE's 512-wide encoder split four ways (128 a
    rank), RNA2DNAAE's 128-wide one replicated, as at two ways."""
    run = (task, "float32", "adamw")
    want = single["steps"][run]
    for r in world4:
        got = r["steps_mp4"][run]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        _close_trees(got["params"], want["params"], 1e-5, _pre_bn_biases(task), HAZARD,
                     f"{run} params", single["steps"][("grads",) + run])


def test_split_step_checkpoint_is_the_whole_tree(world4, single):
    """Rank 0 writes the gathered tree of a split step; it reads back as the
    single-device tree's layout (shapes and keys), values to the step's
    tolerance."""
    want = single["steps"][("rna2dna", "float32", "adamw")]["params"]
    for r in world4:
        got = r["checkpoint"]
        assert {n: a.shape for n, a in _leaves(got)} == {n: a.shape for n, a in _leaves(want)}
        _close_trees(got, want, 1e-5, _pre_bn_biases("rna2dna"), HAZARD, "checkpoint")


def test_dryrun_passes_at_world_4(world4):
    for r in world4:
        d = r["dryrun"]
        assert d["mesh"] == {"data": 2, "model": 2}
        assert np.isfinite(d["loss"]) and np.isfinite(d["bf16_loss"])
        assert np.isfinite(d["adafactor_loss"])


# --- the data-parallel fit, predict and resume -----------------------------------------

def test_dp_fit_first_step_gradients(world2, single):
    """Each gradient within 1e-5 of its tensor's largest |g|; a pre-BN bias,
    whose true gradient is 0, within 1e-5 of the largest |g| of all."""
    loss_w, grads_w = single["dp"]["grads"]
    top = max(float(np.abs(w).max()) for _, w in _leaves(grads_w))
    biases = _pre_bn_biases("rna2dna")
    for r in world2:
        loss, grads = r["dp"]["grads"]
        assert loss == pytest.approx(loss_w, rel=1e-5)
        for (name, g), (_, w) in zip(_leaves(grads), _leaves(grads_w)):
            scale = top if name in biases else float(np.abs(w).max())
            assert float(np.abs(g - w).max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("fit", ["fit_even", "fit_uneven", "fit_multimodal"])
def test_dp_fit_equals_single_device_fit(world2, single, fit):
    """2 epochs of data-parallel training at world 2 against the single
    device's: ``fit_uneven`` trains batches of 15 rows (8 + 7) and a last
    batch of 10 (drop_last=False)."""
    want = single["dp"][fit]
    task = "multimodal" if fit == "fit_multimodal" else "rna2dna"
    for r in world2:
        got = r["dp"][fit]
        assert got["epochs"] == want["epochs"] == 2
        np.testing.assert_allclose(got["val"], want["val"], rtol=1e-3)
        _close_trees(got["params"], want["params"], 2e-4, _pre_bn_biases(task), FIT_HAZARD,
                     fit)
    for (_, a), (_, b) in zip(_leaves(world2[0]["dp"][fit]), _leaves(world2[1]["dp"][fit])):
        np.testing.assert_array_equal(a, b)  # every rank returns the same run


def test_dp_predict_equals_single_call(world2, single):
    """43 rows split 22 + 21 with the noise the single call draws for them;
    the products of fewer rows round alike to within an ulp or so."""
    for r in world2:
        for key in ("predict", "predict_chunked"):
            assert r["dp"][key].shape == single["dp"][key].shape == (43, ranks.DIM_B)
            np.testing.assert_allclose(r["dp"][key], single["dp"][key], rtol=1e-6, atol=1e-7)


def test_dp_resume_continues_on_the_mesh(world2):
    for r in world2:
        np.testing.assert_array_equal(r["dp"]["resumed"]["val"][0],
                                      r["dp"]["two_epochs"]["val"][1])
        _close_trees(r["dp"]["resumed"]["params"], r["dp"]["two_epochs"]["params"], 0.0)


def test_fit_with_a_mesh_refuses_the_kernels():
    data = ranks.cohort()
    tr, va = ranks.split(data)
    with pytest.raises(ValueError, match="mesh-sharded fit requires the plain path"):
        engine.fit("rna2dna", ranks.cfg(), tr, va, 0, ranks.N_SITES, num_epochs=1,
                   fused_epoch=True, mesh=sharding.make_mesh(), device="cpu")


# --- the sharded populations ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["folds", "trials"])
def test_sharded_population_member_is_its_slice_alone(world2, single, kind):
    for r in world2:
        members = r["alone"]["members"]
        for j, i in enumerate(members):
            got, alone = r["pops"][kind][i], r["alone"][kind][j]
            np.testing.assert_array_equal(got["val"], alone["val"])
            _close_trees(got["params"], alone["params"], 0.0)
        for got, want in zip(r["pops"][kind], single["pops"][kind]):
            np.testing.assert_array_equal(got["val"], want["val"])
    assert len(world2[0]["pops"][kind]) == 3  # the padding is dropped


def test_sharded_masked_population_is_the_unsharded_one(world2, single):
    """Uneven folds as one masked population sharded over 2 ranks: every
    rank pads to the maxima of all folds, so each member is the one-device
    population's bit for bit."""
    for r in world2:
        assert len(r["pops"]["masked_folds"]) == 3
        for got, want in zip(r["pops"]["masked_folds"], single["pops"]["masked_folds"]):
            np.testing.assert_array_equal(got["val"], want["val"])
            _close_trees(got["params"], want["params"], 0.0)


@pytest.fixture(scope="module")
def jax_sharded_folds(tmp_path_factory):
    def compute():
        tr, va = ranks.cv_folds(ranks.cohort())
        arrays = lambda t: MultiModalArrays(*(jnp.asarray(x) for x in t))  # noqa: E731
        res = jax_vm.fit_folds("rna2dna", JaxConfig(**ranks.DIMS), [arrays(t) for t in tr],
                               [arrays(v) for v in va], jax.random.PRNGKey(0), ranks.N_SITES,
                               num_epochs=4, drop_last=False, mask_sizes=False,
                               mesh=jax_vm.population_mesh(jax.devices()[:2]))
        return [np.asarray(jax.device_get(r.val_losses)) for r in res]

    return ranks.shared_result(tmp_path_factory, "parallel_jax_folds", compute)


def test_sharded_fold_population_agrees_with_jax(world2, jax_sharded_folds):
    for r in world2:
        for got, want in zip(r["pops"]["folds"], jax_sharded_folds):
            np.testing.assert_allclose(got["val"][-1], want[-1], rtol=0.05)
            assert got["val"][-1] < got["val"][0]


# --- the CLI ---------------------------------------------------------------------------

def test_cli_dp_world_2_rank_0_writes(world2):
    rank0, rank1 = world2[0]["cli"], world2[1]["cli"]
    assert "Data-parallel over 2 devices" in rank0["stdout"]
    assert "Training complete!" in rank0["stdout"] and rank1["stdout"] == ""
    run_id = rank0["run_id"]
    assert rank1["run_id"] == run_id
    np.testing.assert_array_equal(rank0["val"], rank1["val"])
    assert rank0["files"] == sorted([
        f"checkpoints/best_rna2dna_{run_id}.npz", f"checkpoints/resume_rna2dna_{run_id}.npz",
        "latest_rna2dna_run_id.txt", f"plots/metrics_rna2dna_{run_id}.jsonl"]
        + [f for f in rank0["files"] if f.startswith("plots/") and f.endswith(".png")])


def test_cli_dp_world_1_says_single_chip(tmp_path, monkeypatch, capsys):
    from vae_los_angeles_torch.training.cli import run_training

    monkeypatch.chdir(tmp_path)
    cfg = ranks.cfg(checkpoint_dir=str(tmp_path / "c"), plots_dir=str(tmp_path / "p"))
    res, _, _ = run_training("rna2dna", "rna2dna", cfg=cfg, argv=["--dp", "--epochs", "1"],
                             data=ranks.cohort(), device="cpu", root=str(tmp_path))
    out = capsys.readouterr().out
    assert "--dp requested but only one device is visible; running single-chip" in out
    assert res.epochs_ran == 1


# --- the device policy ---------------------------------------------------------------

def test_rank_card_is_local_rank(monkeypatch):
    from vae_los_angeles_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert device.resolve_device() == torch.device("cuda", 1)
    assert device.resolve_device("cuda") == torch.device("cuda", 1)
    device.share_card(True)
    try:
        assert device.resolve_device() == torch.device("cuda", 0)
    finally:
        device.share_card(False)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=2 needs cuda:2"):
        device.resolve_device()


def test_rank_without_a_card_raises(monkeypatch):
    from vae_los_angeles_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device()
    assert device.resolve_device("cpu") == torch.device("cpu")  # asked for: the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comm.init("gloo", rank=0, world_size=1, init_method="file:///nonexistent")


def test_spawned_ranks_import_no_jax(world2):
    assert [r["imported"] for r in world2] == [[], []]


def test_collective_routes_in_a_world(world2):
    """gloo on the CPU: every collective native; all-gather tiled in rank
    order, broadcast from a rank, the axis index."""
    for r in world2:
        got = r["routes"]
        assert got["table"] == {"all_reduce": "native", "broadcast": "native",
                                "all_gather": "native"}
        np.testing.assert_array_equal(got["gathered"], got["want"])
        np.testing.assert_array_equal(got["broadcast"], got["want"][:, 3:])
    assert [r["routes"]["axis_index"] for r in world2] == [0, 1]


def test_sync_batchnorm_single_rank_matches_plain():
    """`SyncBatchNorm` on one rank (no sums across ranks) is ``ops.nn``'s
    train-mode BatchNorm up to the order of its sums, gradients included."""
    x = torch.randn(13, 7, dtype=torch.float32, requires_grad=True)
    g = torch.randn(13, 7)
    params = {"gamma": torch.rand(7) + 0.5, "beta": torch.randn(7)}
    state = {"mean": torch.zeros(7), "var": torch.ones(7)}
    want, want_state = ops_nn.batchnorm_plain(params, state, x, True)
    (dx_want,) = torch.autograd.grad((want * g).sum(), x)
    xhat, mean, var = sharding.SyncBatchNorm.apply(x, 13, lambda t: t)
    got = xhat * params["gamma"] + params["beta"]
    (dx_got,) = torch.autograd.grad((got * g).sum(), x)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dx_got, dx_want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(0.9 + 0.1 * var * 13 / 12, want_state["var"])
