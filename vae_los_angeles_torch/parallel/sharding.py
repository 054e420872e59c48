"""Multi-device training: the ("data", "model") mesh, the rank's rows of a
batch, the Megatron column/row table and the sharded train step
(counterpart of ``vae_los_angeles_tpu/parallel/sharding.py``).

The JAX package annotates shardings and lets GSPMD insert the collectives;
the port runs one process a device (``parallel.comm``) and says where each
collective goes:

  * `make_mesh` lays the ranks out in the JAX grid's order, rank r at
    ("data" r // model_parallel, "model" r % model_parallel), with one
    subgroup a column (the ranks that share a "model" index: the gradient
    sums) and one a row (the ranks that share a "data" index: the tensor-
    parallel sums).
  * `shard_arrays` gives a rank its rows of the global batch (`ShardedBatch`,
    which carries the mesh, as JAX's committed arrays carry their sharding);
    the rows split as evenly as they go (sizes differing by one at most), so
    a batch that does not divide by the data axis still trains.
  * `param_specs` is the JAX table (`_TP_LAYERS`, the 512-width guard): each
    leaf is ``"col"`` (the output dim split), ``"row"`` (the input dim
    split) or ``"rep"``. `shard_params` cuts a full tree to the rank's
    slices; `gather_params` puts the full tree back together (what a
    checkpoint writes: the single-device loaders read it unchanged).
  * `ShardContext` runs the layers of ``ops.nn`` for a rank (``ops.nn.sharded``):
      - the column linear is identity forward and all-reduce backward on its
        input (`comm.CopyToGroup`), then the rank's columns; the row linear
        multiplies the rank's rows and all-reduces the partial product
        forward (`comm.ReduceFromGroup`), then adds the bias once: one
        all-reduce at the pair's boundary each way;
      - BatchNorm in train mode normalises with the global batch's
        statistics (`SyncBatchNorm`: the forward all-reduces the per-feature
        sums, the backward the two sums its gradient needs), so the running
        statistics move identically on every rank; on a column-split
        activation it is exact on the rank's features with its slice of γ/β,
        whose gradients reach the replicated copies through
        `comm.CopyToGroup`, and the new running statistics are gathered;
      - noise (dropout masks, eps) is drawn for the global batch and whole
        columns from the shared generator, then sliced to the rank's rows
        and columns: every rank draws what the single-device step draws.
  * `sharded_train_step` is one step of any task in ``TASKS``: fp32 or bf16
    compute, AdamW (moments follow their parameters' split) or Adafactor
    (its factored statistics replicated: the split gradients are gathered
    and the full update is sliced). Loss sums and gradients are summed over
    the data axis, so the step is the single-device step up to the order of
    its sums; given a plain batch it is the single-device step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vae_los_angeles_torch.ops import nn as ops_nn
from vae_los_angeles_torch.ops import optim
from vae_los_angeles_torch.parallel import comm
from vae_los_angeles_torch.training.tasks import Batch, get_task
from vae_los_angeles_torch.utils.tree import tree_leaves, tree_map


class Mesh:
    """A ("data", "model") grid over the ranks of the process group."""

    axis_names = ("data", "model")

    def __init__(self, n: int, model_parallel: int, data_group=None, model_group=None):
        self.size = n
        self.shape = {"data": n // model_parallel, "model": model_parallel}
        r = comm.rank() if n > 1 else 0
        self.data_index, self.model_index = divmod(r, model_parallel)
        self._groups = {"data": data_group, "model": model_group}

    def group(self, axis: str):
        return self._groups[axis]

    def psum(self, t, axis: str):
        """``t`` summed over the axis (itself when the axis has one rank)."""
        return t if self.shape[axis] == 1 else comm.all_reduce(t, self._groups[axis])

    def gather(self, t, axis: str, dim: int = 0):
        """Every rank's ``t`` along the axis, concatenated on ``dim``."""
        return t if self.shape[axis] == 1 else comm.all_gather(t, dim, self._groups[axis])

    def row_range(self, n: int):
        """(lo, hi) of this rank's rows of ``n`` along "data": contiguous,
        in rank order, sizes differing by one at most."""
        return _split(n, self.shape["data"], self.data_index)

    def row_counts(self, n: int):
        d = self.shape["data"]
        return [_split(n, d, i)[1] - _split(n, d, i)[0] for i in range(d)]

    def __repr__(self):
        return f"Mesh({self.shape})"


def _split(n: int, parts: int, i: int):
    base, extra = divmod(n, parts)
    lo = i * base + min(i, extra)
    return lo, lo + base + (1 if i < extra else 0)


def make_mesh(n_devices=None, model_parallel: int = 1) -> Mesh:
    """Mesh over ("data", "model") of every rank of the process group (one
    device a rank; a single process is a mesh of one). ``model_parallel``
    must divide the rank count. Every rank must call it (the subgroups are
    made collectively)."""
    n = comm.world()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"n_devices={n_devices}: a mesh spans the process group's {n} "
                         "rank(s), one device a rank")
    model_parallel = int(model_parallel)
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide {n} devices")
    if n == 1:
        return Mesh(1, 1)
    n_data = n // model_parallel
    data_groups = ([None] if model_parallel == 1 else
                   [comm.new_group([d * model_parallel + m for d in range(n_data)])
                    for m in range(model_parallel)])
    model_groups = ([None] if model_parallel == 1 else
                    [comm.new_group(range(d * model_parallel, (d + 1) * model_parallel))
                     for d in range(n_data)])
    r = comm.rank()
    return Mesh(n, model_parallel, data_groups[0 if model_parallel == 1 else r % model_parallel],
                model_groups[0 if model_parallel == 1 else r // model_parallel])


class ShardedBatch(NamedTuple):
    """A rank's rows [lo, hi) of an ``n``-row global batch on ``mesh``."""

    tpm: torch.Tensor
    beta: torch.Tensor
    site: torch.Tensor
    lo: int
    hi: int
    n: int
    mesh: Mesh

    def rows(self) -> Batch:
        return Batch(self.tpm, self.beta, self.site)


def data_sharding(mesh: Mesh):
    """The batch-axis layout: (rank's first row, rank's end) of an n-row
    batch, as a function of n."""
    return mesh.row_range


def shard_arrays(arrays, mesh: Mesh, device=None) -> ShardedBatch:
    """This rank's rows of a global (tpm, beta, site) batch."""
    from vae_los_angeles_torch.training.engine import _as_batch

    n = len(arrays[0])
    lo, hi = data_sharding(mesh)(n)
    device = comm.device() if device is None else device
    part = _as_batch([a[lo:hi] for a in arrays], device)
    return ShardedBatch(*part, lo, hi, n, mesh)


# Wide layers worth tensor-sharding, keyed by (module, layer): True = shard
# the OUTPUT dim (column parallel), False = shard the INPUT dim (row
# parallel); pairs column then row, so activations need one sum at the pair's
# boundary. The JAX package's table.
_COL = True
_ROW = False
_TP_LAYERS = {
    ("encoder_b", "fc1"): _COL,  # dim_b → 512, shard 512
    ("encoder_b", "fc2"): _ROW,  # 512 → 256, shard 512 (contraction)
    ("encoder_dna", "fc1"): _COL,
    ("encoder_dna", "fc2"): _ROW,
    ("enc_fc1",): _COL,  # DNA2RNAAE encoder
    ("enc_fc2",): _ROW,
    ("decoder_b", "fc2"): _COL,  # 256 → 512, shard 512
    ("decoder_b", "fc3"): _ROW,  # 512 → dim_b, shard 512 (contraction)
    ("decoder_dna", "fc2"): _COL,
    ("decoder_dna", "fc3"): _ROW,
}
_TP_MIN_WIDTH = 512


def param_specs(params) -> dict:
    """``"col"``/``"row"``/``"rep"`` a leaf of a model's parameter tree.

    The 512-wide layers of the table split over "model"; the rest is
    replicated. A name match alone is not enough: RNA2DNAAE's narrow
    rna → 128 → latent encoder reuses DNA2RNAAE's ``enc_fc1``/``enc_fc2``
    names, so the split dimension must also be at least 512 wide. Read on
    the whole tree: a cut one's widths no longer tell (`_specs_of`)."""

    def walk(tree, path):
        if isinstance(tree, dict) and "w" in tree and "b" in tree:
            for tp_path, col in _TP_LAYERS.items():
                if path[-len(tp_path):] == tp_path:
                    if tree["w"].shape[1 if col else 0] < _TP_MIN_WIDTH:
                        break  # a narrow layer with a colliding name: replicate
                    return {"w": "col", "b": "col"} if col else {"w": "row", "b": "rep"}
            return {k: "rep" for k in tree}
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return "rep"

    return walk(params, ())


def _cut(t, spec, mesh: Mesh):
    mp = mesh.shape["model"]
    if spec == "rep" or mp == 1:
        return t
    dim = 1 if spec == "col" and t.dim() == 2 else 0
    width = t.shape[dim]
    if width % mp:
        raise ValueError(f"a split dimension of {width} does not divide by model_parallel={mp}")
    part = width // mp
    return t.narrow(dim, mesh.model_index * part, part).contiguous()


def _join(t, spec, mesh: Mesh):
    if spec == "rep" or mesh.shape["model"] == 1:
        return t
    return mesh.gather(t, "model", 1 if spec == "col" and t.dim() == 2 else 0)


# the specs of every tree `shard_params` cut, by the tree's leaf names: a cut
# tree's widths no longer tell a split 512-wide layer from a narrow one (at
# 4-way, 512 / 4 is RNA2DNAAE's 128)
_SPECS = {}


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return tuple(n for k, v in tree.items() for n in _leaf_names(v, f"{prefix}{k}/"))
    return (prefix,)


def _specs_of(params) -> dict:
    """The `param_specs` of the whole tree a cut ``params`` came from."""
    try:
        return _SPECS[_leaf_names(params)]
    except KeyError:
        raise ValueError("these parameters were not cut by shard_params (or "
                         "make_sharded_train_state)") from None


def shard_params(params, mesh: Mesh):
    """The rank's slices of a full parameter tree (`param_specs`)."""
    specs = param_specs(params)
    _SPECS[_leaf_names(params)] = specs
    return tree_map(lambda t, s: _cut(t, s, mesh), params, specs)


def gather_params(params, mesh: Mesh):
    """The full tree of a rank's slices, on every rank (the checkpoint's
    layout)."""
    return tree_map(lambda t, s: _join(t, s, mesh), params, _specs_of(params))


def make_sharded_train_state(task_name: str, cfg, n_sites: int, mesh: Mesh, seed: int,
                             device=None):
    """(params, state, opt) of a fresh run laid out on the mesh: the task's
    init from ``seed`` (every rank draws the same), cut to the rank's
    slices; the BatchNorm state replicated; AdamW's m/v shaped as the
    slices, the step counter and Adafactor's factored statistics (of the
    full tree) replicated. ``cfg.moments_dtype`` "bfloat16" stores the
    moments reduced."""
    task = get_task(task_name)
    device = comm.device() if device is None else device
    params, state = task.init(torch.Generator().manual_seed(int(seed)), cfg, n_sites, device)
    optimizer = getattr(cfg, "optimizer", "adamw")
    if optimizer not in optim.OPTIMIZERS:
        raise ValueError(f"unsupported optimizer {optimizer!r}; valid: {sorted(optim.OPTIMIZERS)}")
    opt_init, _ = optim.OPTIMIZERS[optimizer]
    moments = ops_nn.resolve_compute_dtype(getattr(cfg, "moments_dtype", None))
    local = shard_params(params, mesh)
    opt = opt_init(params if optimizer == "adafactor" else local, moments)
    return local, state, opt


class SyncBatchNorm(torch.autograd.Function):
    """x̂ = (x − mean)·rsqrt(var + eps) with the statistics of the global
    batch of ``n`` rows, whose per-feature sums ``psum`` adds up over the
    ranks. Returns (x̂, mean, var); the backward sums Σg and Σg·x̂."""

    @staticmethod
    def forward(ctx, x, n, psum):
        mean = psum(x.sum(0)) / n
        xc = x - mean
        var = psum(torch.sum(xc * xc, 0)) / n  # biased, used to normalise
        rstd = torch.rsqrt(var + ops_nn.BN_EPS)
        xhat = xc * rstd
        ctx.save_for_backward(xhat, rstd)
        ctx.n, ctx.psum = n, psum
        ctx.mark_non_differentiable(mean, var)
        return xhat, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        xhat, rstd = ctx.saved_tensors
        sums = ctx.psum(torch.stack([g.sum(0), torch.sum(g * xhat, 0)]))
        return rstd * (g - sums[0] / ctx.n - xhat * (sums[1] / ctx.n)), None, None


def _product(x, w):
    """``x @ w`` in fp32, a reduced-precision weight upcast as
    ``ops.nn.linear_plain`` does."""
    if w.dtype == torch.float32:
        return x @ w
    return x.to(w.dtype).to(torch.float32) @ w.to(torch.float32)


class ShardContext:
    """A rank's layers (module docstring): ``roles`` maps id(weight) of the
    split linears to "col"/"row"; `set_rows` names the rank's rows of the
    batch the next forward sees."""

    def __init__(self, mesh: Mesh, roles: Optional[dict] = None):
        self.mesh = mesh
        self.roles = roles or {}
        self.rows = None  # (lo, hi, n) of the batch in flight
        self.open = None  # (c0, c1, width) of the column-split activation in flight

    def set_rows(self, n: int):
        lo, hi = self.mesh.row_range(n)
        self.rows = (lo, hi, n)
        return lo, hi

    def _data_psum(self, t):
        return self.mesh.psum(t, "data")

    def linear(self, params, x):
        role = self.roles.get(id(params["w"]))
        if role is None:
            return ops_nn.linear_plain(params, x)
        group = self.mesh.group("model")
        if role == "col":
            width = params["w"].shape[1]
            c0 = self.mesh.model_index * width
            self.open = (c0, c0 + width, width * self.mesh.shape["model"])
            return _product(comm.CopyToGroup.apply(x, group), params["w"]) + params["b"]
        self.open = None
        return comm.ReduceFromGroup.apply(_product(x, params["w"]), group) + params["b"]

    def batchnorm(self, params, state, x, train: bool):
        gamma, beta = params["gamma"], params["beta"]
        run_mean, run_var = state["mean"], state["var"]
        cols = None
        if self.open is not None and x.shape[-1] != gamma.shape[-1]:
            c0, c1, width = self.open
            if (x.shape[-1], gamma.shape[-1]) != (c1 - c0, width):
                raise ValueError(f"BatchNorm of {gamma.shape[-1]} features on a {x.shape[-1]}-"
                                 f"column slice of a {width}-wide activation")
            cols = (c0, c1)
            group = self.mesh.group("model")
            gamma = comm.CopyToGroup.apply(gamma, group)[c0:c1]
            beta = comm.CopyToGroup.apply(beta, group)[c0:c1]
            run_mean, run_var = run_mean[c0:c1], run_var[c0:c1]
        if not train:
            return (x - run_mean) * torch.rsqrt(run_var + ops_nn.BN_EPS) * gamma + beta, state
        n = self.rows[2] if self.rows is not None else x.shape[0]
        if n <= 1:
            raise ValueError(f"train-mode BatchNorm requires batch size > 1, got {n}")
        xhat, mean, var = SyncBatchNorm.apply(x, n, self._data_psum)
        new = {"mean": (1.0 - ops_nn.BN_MOMENTUM) * run_mean + ops_nn.BN_MOMENTUM * mean,
               "var": (1.0 - ops_nn.BN_MOMENTUM) * run_var
               + ops_nn.BN_MOMENTUM * var * (n / (n - 1))}
        if cols is not None:
            new = {k: self.mesh.gather(v.detach(), "model") for k, v in new.items()}
        return xhat * gamma + beta, new

    def draw(self, sampler, shape, generator, device, dtype):
        rows, cols = shape
        lo, hi, n = self.rows if self.rows is not None else (0, rows, rows)
        if hi - lo != rows:
            raise ValueError(f"a draw of {rows} rows where this rank holds rows [{lo}, {hi})")
        c0, c1, width = 0, cols, cols
        if self.open is not None and cols == self.open[1] - self.open[0]:
            c0, c1, width = self.open
        full = ops_nn.draw_plain(sampler, (n, width), generator, device, dtype)
        return full[lo:hi, c0:c1]


def _roles(fwd_params, mesh: Mesh) -> dict:
    """id(weight) → "col"/"row" of the split linears of a (cast) tree."""
    if mesh.shape["model"] == 1:
        return {}
    specs = _specs_of(fwd_params)
    roles = {}

    def walk(tree, spec):
        if isinstance(tree, dict) and "w" in tree and "b" in tree and isinstance(spec, dict) \
                and spec.get("w") in ("col", "row"):
            roles[id(tree["w"])] = spec["w"]
            return
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], spec[k])

    walk(fwd_params, specs)
    return roles


def sharded_loss_and_grads(task, params, state, rows: Batch, beta_kl, generator, mesh: Mesh,
                           n: int, compute_dtype=torch.float32, split: bool = True, **loss_kw):
    """A rank's part of one train step of ``task`` on an ``n``-row global
    batch: (global loss sum, gradients summed over the data axis, new
    state). ``params`` are the rank's slices (``split``), or the full tree
    replicated (data parallelism alone, ``split=False``). A mesh of one is
    the single-device step, with no parallel context."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    fwd = ops_nn.cast_matmul_params(leaves, compute_dtype)
    if mesh.size == 1:
        loss, new_state = task.loss(fwd, state, rows, beta_kl, True, generator, **loss_kw)
    else:
        ctx = ShardContext(mesh, _roles(fwd, mesh) if split else None)
        ctx.rows = (*mesh.row_range(n), n)
        with ops_nn.sharded(ctx):
            loss, new_state = task.loss(fwd, state, rows, beta_kl, True, generator, **loss_kw)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat)
    summed = _psum_flat([loss.detach().reshape(1)] + list(grads), mesh)
    it = iter(summed[1:])
    return summed[0][0], tree_map(lambda _: next(it), leaves), tree_map(torch.Tensor.detach,
                                                                        new_state)


def _psum_flat(tensors, mesh: Mesh):
    """The tensors summed over "data" in one all-reduce of their
    concatenation (fp32)."""
    if mesh.shape["data"] == 1:
        return tensors
    flat = mesh.psum(torch.cat([t.reshape(-1) for t in tensors]), "data")
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def sharded_train_step(task_name: str, compute_dtype: str = "float32",
                       optimizer: str = "adamw", donate: bool = False):
    """One forward + backward + optimizer step of ``task_name`` over the
    mesh its batch carries (`shard_arrays`); given a plain (tpm, beta, site)
    batch, the single-device step on the whole of it.

    ``step(params, state, opt, batch, generator, lr, weight_decay, beta_kl,
    gamma=1.0, class_weights=None)`` returns (params, state, opt, loss):
    ``params`` are the rank's slices (`shard_params`), ``state`` and the
    returned loss (the global sum) replicated, ``generator`` the shared one
    the noise of the global batch is drawn from. ``donate`` is accepted for
    the JAX signature: the step never writes its inputs, and they are freed
    once the caller drops them."""
    task = get_task(task_name)
    dtype = ops_nn.resolve_compute_dtype(compute_dtype)
    if optimizer not in optim.OPTIMIZERS:
        raise ValueError(f"unsupported optimizer {optimizer!r}; valid: {sorted(optim.OPTIMIZERS)}")
    _, opt_update = optim.OPTIMIZERS[optimizer]
    expected = {"adamw": {"step", "m", "v"}, "adafactor": {"step", "vr", "vc"}}[optimizer]
    del donate

    def step(params, state, opt, batch, generator, lr, weight_decay, beta_kl, gamma=1.0,
             class_weights=None):
        if set(opt) != expected:
            raise ValueError(
                f"optimizer state slots {sorted(opt)} don't match {optimizer!r} (expected "
                f"{sorted(expected)}) — build the state and the step from the same "
                "Config.optimizer")
        if isinstance(batch, ShardedBatch):
            mesh, rows, n = batch.mesh, batch.rows(), batch.n
        else:
            device = tree_leaves(params)[0].device
            from vae_los_angeles_torch.training.engine import _as_batch

            mesh, rows = Mesh(1, 1), _as_batch(batch, device)
            n = len(rows)
        loss, grads, new_state = sharded_loss_and_grads(
            task, params, state, rows, beta_kl, generator, mesh, n, dtype, gamma=gamma,
            class_weights=class_weights)
        if optimizer == "adafactor" and mesh.shape["model"] > 1:
            specs = _specs_of(params)
            full_p = tree_map(lambda t, s: _join(t, s, mesh), params, specs)
            full_g = tree_map(lambda t, s: _join(t, s, mesh), grads, specs)
            full_p, opt = opt_update(full_p, full_g, opt, lr, weight_decay)
            params = tree_map(lambda t, s: _cut(t, s, mesh), full_p, specs)
        else:
            params, opt = opt_update(params, grads, opt, lr, weight_decay)
        return params, new_state, opt, loss

    return step


__all__ = ["Mesh", "ShardContext", "ShardedBatch", "SyncBatchNorm", "data_sharding",
           "gather_params", "make_mesh", "make_sharded_train_state", "param_specs",
           "shard_arrays", "shard_params", "sharded_loss_and_grads", "sharded_train_step"]

