"""The process group and its collectives: everything multi-device goes
through here (the port's counterpart of the JAX package's mesh collectives,
``psum``, ``all_gather(..., tiled=True)``, broadcast and ``axis_index``).

The JAX package is single-controller: one process drives every device. The
port is SPMD, one process a device (a "rank"): every entry point runs on
every rank, outputs the JAX package returns replicated are returned on
every rank, and only rank 0 writes files (`is_writer`, `barrier`).

  * `init` starts the group from torch's launch variables (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, as
    ``python -m torch.distributed.run`` sets them) or from explicit
    arguments. The backend defaults to NCCL for a card and gloo for the CPU.
    A rank's card is ``cuda:LOCAL_RANK``; ``share_card=True`` puts every
    rank on ``cuda:0`` (several gloo ranks on one card; NCCL refuses two
    ranks on one card).
  * `rank`, `world`, `barrier`, `is_writer`, `writes_files`.
  * `all_reduce` (sum), `all_gather` (along an axis, tiled), `broadcast`,
    `axis_index`, `gather_objects`, each over a group (None: every rank).
  * `spawn` runs a function on ``world`` ranks through
    ``torch.multiprocessing`` with a ``file://`` store (no port), for the
    tests, the dry run and ``chip_smoke.py``.
  * The autograd pieces of the Megatron linears: `CopyToGroup` (identity
    forward, sum backward) and `ReduceFromGroup` (sum forward, identity
    backward).

The route each collective takes is chosen once, from the group's backend
and device, and printed by `init` (`routes`): NCCL runs every collective
natively on CUDA tensors; gloo runs them natively on the CPU and on CUDA
tensors (its CUDA algorithms stage through host memory themselves: torch
2.11.0+cu128 on an H100 runs all-reduce, broadcast and all-gather of CUDA
tensors over gloo, although PyTorch's backend table lists only the first
two), so no collective needs a staged route of its own. Any other
(backend, device) pair raises at `init`. No call tries one route and drops
to another.
"""

from __future__ import annotations

import functools
import os
import pickle
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist

from vae_los_angeles_torch import device as device_policy

_STATE = {"device": None, "routes": None}

# a route a collective: "native", the backend's own call on the tensor's device
_ROUTE_TABLE = {
    ("nccl", "cuda"): {"all_reduce": "native", "broadcast": "native", "all_gather": "native"},
    ("gloo", "cpu"): {"all_reduce": "native", "broadcast": "native", "all_gather": "native"},
    ("gloo", "cuda"): {"all_reduce": "native", "broadcast": "native", "all_gather": "native"},
}


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    return dist.get_rank(group) if initialized() else 0


def world(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


def is_writer() -> bool:
    """Whether this rank writes files: rank 0, or the only process."""
    return rank() == 0


def barrier():
    if world() > 1:
        dist.barrier()


_WRITING = [0]  # depth of the `writes_files` calls running on this rank


def writes_files(fn):
    """Run ``fn`` (a function that writes files: plots, JSON, pickles) on
    the writing rank only, then hold every rank at a barrier; the other
    ranks get None. A call made inside another runs as it is (the outer
    call already chose the rank and holds the one barrier)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _WRITING[0]:
            return fn(*args, **kwargs)
        out = None
        if is_writer():
            _WRITING[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                _WRITING[0] -= 1
        barrier()
        return out

    return wrapper


def device() -> torch.device:
    """The device this rank's collectives and entry points use."""
    if _STATE["device"] is not None:
        return _STATE["device"]
    return device_policy.resolve_device()


def routes() -> dict:
    """{collective: route} of the group (module docstring)."""
    if _STATE["routes"] is None:
        raise RuntimeError("no process group: call comm.init first")
    return dict(_STATE["routes"])


def init(backend: Optional[str] = None, *, rank: Optional[int] = None,
         world_size: Optional[int] = None, local_rank: Optional[int] = None,
         init_method: Optional[str] = None, device=None, share_card: bool = False):
    """Start the process group (module docstring). ``device`` "cpu" keeps
    the rank on the CPU; otherwise the rank's card is ``cuda:LOCAL_RANK``
    (``cuda:0`` with ``share_card``) and a rank without one raises. Returns
    the rank's device."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    device_policy.share_card(share_card)
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        dev = device_policy.rank_device(local_rank)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "gloo" if cpu else "nccl"
    key = (backend, dev.type)
    if key not in _ROUTE_TABLE:
        raise ValueError(f"backend {backend!r} on {dev.type}: the port runs NCCL on cards and "
                         "gloo on the CPU or on cards")
    if init_method is None and "MASTER_ADDR" not in env:
        raise ValueError("no rendezvous: pass init_method (tcp://host:port or file://path) or "
                         "set MASTER_ADDR/MASTER_PORT (python -m torch.distributed.run does)")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            **kw)
    env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"] = str(rank), str(world_size), str(local_rank)
    _STATE.update(device=dev, routes=dict(_ROUTE_TABLE[key]))
    if rank == 0:
        print(f"comm: {backend} over {world_size} rank(s) on {dev}"
              f"{' (one shared card)' if share_card and dev.type == 'cuda' else ''}; routes "
              + ", ".join(f"{op}={r}" for op, r in _STATE["routes"].items()), flush=True)
    return dev


def ensure_group(device=None, cfg=None):
    """Start the process group from the launcher's variables when a launcher
    started this process (``WORLD_SIZE`` > 1) and none is up; the ranks stay
    on the CPU when ``device`` (or ``cfg.platform``, ``DEVICE``) asks for it."""
    if initialized() or int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return
    cpu = (torch.device(device).type == "cpu" if device is not None
           else cfg is not None and (cfg.platform or "").lower() == "cpu")
    init(device="cpu" if cpu else None)


def shutdown():
    if initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, routes=None)
    device_policy.share_card(False)


def new_group(ranks):
    """A subgroup over ``ranks`` (every rank must call this, in the same
    order, for every subgroup); None when it spans the whole world."""
    ranks = list(ranks)
    if not initialized() or len(ranks) == world():
        return None
    return dist.new_group(ranks)


def axis_index(group=None) -> int:
    """This rank's index along ``group`` (``jax.lax.axis_index``)."""
    return rank(group)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``, on every rank of it (``psum``); a
    new tensor, ``t`` is left as it is."""
    if world(group) == 1:
        return t.clone()
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, group=group)
    return out


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` (a group rank) on every rank of ``group``."""
    if world(group) == 1:
        return t
    out = t.detach().clone().contiguous()
    src_global = dist.get_global_rank(group, src) if group is not None else src
    dist.broadcast(out, src_global, group=group)
    return out


def all_gather(t: torch.Tensor, axis: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``axis`` in rank
    order (``jax.lax.all_gather(..., tiled=True)``)."""
    n = world(group)
    if n == 1:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=axis)


def all_gather_rows(t: torch.Tensor, counts, group=None) -> torch.Tensor:
    """Uneven row blocks gathered in rank order: rank i holds ``counts[i]``
    rows of ``t`` (padded to the largest count for the gather, trimmed)."""
    if world(group) == 1:
        return t
    most = max(counts)
    pad = torch.zeros((most - t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    full = all_gather(torch.cat([t.detach(), pad]), 0, group)
    return torch.cat([full[i * most:i * most + c] for i, c in enumerate(counts)])


def gather_objects(obj, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank (a
    collective through the backend's own object gather)."""
    if world(group) == 1:
        return [obj]
    out = [None] * world(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class CopyToGroup(torch.autograd.Function):
    """Identity forward, sum backward: the input of a column-parallel linear
    (each rank's gradient covers its columns' share of the input's)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """Sum forward, identity backward: the output of a row-parallel linear
    (each rank holds a partial product; the loss sees the sum, replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _spawned(index, fn, world_size, backend, device, store, out_dir, args, threads):
    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(index)
    share = device is not None and torch.device(device).type == "cuda" and \
        torch.device(device).index is not None
    init(backend, rank=index, world_size=world_size, local_rank=index,
         init_method=f"file://{store}", device=device, share_card=share)
    try:
        result = fn(*args)
        with open(os.path.join(out_dir, f"rank{index}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        shutdown()


def spawn(fn: Callable, world_size: int, backend: str = "gloo", device=None, args=(),
          threads: int = 1) -> list:
    """Run ``fn(*args)`` on ``world_size`` fresh ranks (``torch.multiprocessing``
    with a ``file://`` store), each with ``threads`` torch threads, and
    return their results in rank order (``fn`` and its results must pickle).
    ``device`` "cpu" keeps the ranks on the CPU; "cuda:0" puts every rank on
    card 0 (several gloo ranks on one card); None gives rank i ``cuda:i``.
    A rank that raises raises here, after every rank has stopped."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        mp.start_processes(_spawned, args=(fn, world_size, backend, device, store, tmp, tuple(args),
                                           threads),
                           nprocs=world_size, join=True, start_method="spawn")
        out = []
        for i in range(world_size):
            with open(os.path.join(tmp, f"rank{i}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def to_numpy_tree(tree):
    """A tree of tensors as numpy arrays (for results that cross processes)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


__all__ = ["CopyToGroup", "ReduceFromGroup", "all_gather", "all_gather_rows", "all_reduce",
           "axis_index", "barrier", "broadcast", "device", "ensure_group", "gather_objects",
           "init", "initialized", "is_writer", "new_group", "rank", "routes", "shutdown",
           "spawn", "to_numpy_tree", "world", "writes_files"]
