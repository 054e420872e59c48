"""What the step graphs of the RNA→DNA, DNA→RNA and tri-modal train steps
(``ops/kernels/fused_train.py``, B1, B4 and B6) decide on the host, held here
on the CPU: the StepArgs bytes each launch sets (against a numpy emulation of
``struct StepArgs`` in ``csrc/fused_train.cu``), the key a graph is cached
for, the checks of the parameters the wrappers take, the buffer layout (the
RNA→DNA graph's BatchNorm views through a stand-in of the built library), and
the one-graph-a-task cache. The graphs themselves run on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from vae_los_angeles_torch.models.directional_vae import dna2rna_vae_init, rna2dna_vae_init
from vae_los_angeles_torch.models.vae import multimodal_vae_init
from vae_los_angeles_torch.ops.kernels import fused_train as ft

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

DIM_A, DIM_B, N_SITES, LATENT, EMBED = 37, 53, 5, 7, 6

# struct StepArgs: struct EpochArgs {u64 seed; float beta, gamma, lr, wd;}, int step, int pad
STEP_ARGS = np.dtype([("seed", "<u8"), ("beta", "<f4"), ("gamma", "<f4"), ("lr", "<f4"),
                      ("wd", "<f4"), ("step", "<i4"), ("pad", "<i4")])


def emulated_step_args(seed, step, beta, gamma):
    a = np.zeros((), STEP_ARGS)
    a["seed"], a["step"] = seed, step
    a["beta"], a["gamma"] = beta, gamma
    return a.tobytes()


@pytest.mark.parametrize("seed, step, beta, gamma", [
    (0, 0, 1e-3, 0.0),
    (2**40 + 3, 5, 1e-3, 1.7),
    (2**63 - 1, 2**31 - 1, 0.1, 1.0 / 3.0),
    (7, -1, 0.0, 2.5),
])
def test_step_args_match_the_struct(seed, step, beta, gamma):
    got = ft.step_args(seed, step, beta, gamma)
    assert len(got) == STEP_ARGS.itemsize == 32 == 8 * 4  # the graph's args buffer: 8 floats
    assert got == emulated_step_args(seed, step, beta, gamma)
    back = np.frombuffer(got, STEP_ARGS)[0]
    assert int(back["seed"]) == seed and int(back["step"]) == step
    assert back["beta"] == np.float32(beta) and back["gamma"] == np.float32(gamma)
    assert back["lr"] == back["wd"] == back["pad"] == 0
    # the seed's low word first, as the kernels read it (philox_bits's key)
    words = np.frombuffer(got[:8], "<u4")
    assert (int(words[0]), int(words[1])) == (seed & 0xFFFFFFFF, seed >> 32)


def test_step_args_refuse_a_step_outside_32_bits():
    with pytest.raises(Exception):
        ft.step_args(0, 2**31, 1e-3)
    params, state = dna2rna_vae_init(torch.Generator().manual_seed(0), DIM_A, DIM_B, N_SITES,
                                     LATENT, EMBED, "cpu")
    flat = ft.flatten_params(params, ft.PARAM_ORDER_D2R)
    site = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="32 bits"):
        ft._run_step("dna2rna", flat, ft.bn_d2r(state), (), site, (), None, 0, 2**31, 1e-3, 0.0)


def dims(task, **over):
    base = {"rna2dna": dict(zip(("in", "hid", "L", "S", "E", "d1", "d2", "out"),
                                (DIM_A, 128, LATENT, N_SITES, EMBED, 256, 512, DIM_B))),
            "dna2rna": dict(zip(("in", "h1", "h2", "L", "S", "E", "d1", "out"),
                                (DIM_B, 512, 256, LATENT, N_SITES, EMBED, 128, DIM_A))),
            "multimodal": dict(zip(("a", "b", "ha", "hb1", "hb2", "L", "S", "E", "da", "db1",
                                    "db2", "dc"),
                                   (DIM_A, DIM_B, 128, 512, 256, LATENT, N_SITES, EMBED, 128,
                                    256, 512, 64)))}[task]
    base.update(over)
    return tuple(base.values())


@pytest.mark.parametrize("task", ft.STEP_GRAPH_TASKS)
def test_step_graph_key_is_equal_for_equal_calls_and_differs_otherwise(task):
    dev = torch.device("cpu")
    key = ft.step_graph_key(task, dev, dims(task), 32, False, task == "multimodal")
    assert key == ft.step_graph_key(task, torch.device("cpu"), list(dims(task)), 32, 0,
                                    task == "multimodal")
    width = "a" if task == "multimodal" else "in"
    others = [
        ft.step_graph_key(task, dev, dims(task, **{width: 41}), 32, False, task == "multimodal"),
        ft.step_graph_key(task, dev, dims(task, S=6), 32, False, task == "multimodal"),
        ft.step_graph_key(task, dev, dims(task), 31, False, task == "multimodal"),
        ft.step_graph_key(task, dev, dims(task), 32, True, task == "multimodal"),
        ft.step_graph_key(task, dev, dims(task), 32, False, task != "multimodal"),
        ft.step_graph_key("dna2rna" if task == "multimodal" else "multimodal", dev, dims(task),
                          32, False, task == "multimodal"),
    ]
    assert all(other != key for other in others)
    assert len(set(others)) == len(others)


INITS = {
    "rna2dna": lambda: rna2dna_vae_init(torch.Generator().manual_seed(1), DIM_A, DIM_B, N_SITES,
                                        LATENT, EMBED, "cpu"),
    "dna2rna": lambda: dna2rna_vae_init(torch.Generator().manual_seed(2), DIM_A, DIM_B, N_SITES,
                                        LATENT, EMBED, "cpu"),
    "multimodal": lambda: multimodal_vae_init(torch.Generator().manual_seed(3), DIM_A, DIM_B,
                                              N_SITES, LATENT, EMBED, "cpu"),
}


@pytest.mark.parametrize("task", sorted(INITS))
def test_check_params_takes_the_models_tensors_and_refuses_others(task):
    params, _ = INITS[task]()
    order = ft.ORDERS[task]
    flat = ft.flatten_params(params, order)
    assert ft._check_params(flat, task, N_SITES) == (torch.device("cpu"),
                                                     ft.DIMS_OF[task](flat))
    with pytest.raises(TypeError, match=f"{order[3][0]} must be torch.float32"):
        ft._check_params(dict(flat, **{order[3][0]: flat[order[3][0]].double()}), task, N_SITES)
    w = order[0][0]
    with pytest.raises(ValueError, match=f"{w} must be contiguous"):
        ft._check_params(dict(flat, **{w: flat[w].t().contiguous().t()}), task, N_SITES)
    with pytest.raises(ValueError, match="n_sites=6"):
        ft._check_params(flat, task, 6)


@pytest.mark.parametrize("task", ft.STEP_GRAPH_TASKS)
def test_a_step_call_refuses_a_parameter_of_another_shape(task):
    params, _ = INITS[task]()
    order = ft.ORDERS[task]
    flat = ft.flatten_params(params, order)
    sources = [flat[name] for name, _ in order]
    # the views of a graph's input buffer, shaped at capture like the first call's
    targets = torch._C._nn.unflatten_dense_tensors(
        torch.empty(sum(t.numel() for t in sources)), sources)
    ft.check_shapes(order, sources, targets)
    bias = order[-1][0]  # the output bias: a (1,) tensor would broadcast in the copy
    width = {"rna2dna": DIM_B, "dna2rna": DIM_A, "multimodal": N_SITES}[task]
    with pytest.raises(ValueError, match=rf"{bias} must have shape \({width},\), got \(1,\)"):
        ft.check_shapes(order, sources[:-1] + [flat[bias][:1]], targets)
    names = [name for name, _ in order]
    i = names.index("da_w1" if task == "multimodal" else "d1w")  # (latent, d1), transposed
    with pytest.raises(ValueError, match=f"{names[i]} must have shape"):
        ft.check_shapes(order, sources[:i] + [sources[i].t()] + sources[i + 1:], targets)


@pytest.mark.parametrize("task", ft.STEP_GRAPH_TASKS)
def test_graph_widths_are_the_wrappers_rows_noise_and_statistics(task):
    params, state = INITS[task]()
    flat = ft.flatten_params(params, ft.ORDERS[task])
    d = ft.DIMS_OF[task](flat)
    bn_floats, rows, noise = ft.graph_widths(task, d)
    bn = {"rna2dna": lambda s: tuple(s["encoder_rna"]["bn"].values()), "dna2rna": ft.bn_d2r,
          "multimodal": ft.bn_mm}[task](state)
    assert bn_floats == sum(t.numel() for t in bn)
    # the rows in the graph's order: the input then the target (directional), RNA then DNA
    # (tri-modal); the injected noise: eps, then each dropout layer's mask
    assert rows == ((DIM_B, DIM_A) if task == "dna2rna" else (DIM_A, DIM_B))
    assert noise == {"rna2dna": (LATENT, 128), "dna2rna": (LATENT, 512, 256),
                     "multimodal": (LATENT, 128, 512, 256)}[task]


class _StandInLibrary:
    """What the graph cache calls of the built library: the destroy entry."""

    def __init__(self):
        self.freed = []

    def graph_destroy(self, handle):
        self.freed.append(handle)


def test_step_graph_cache_keeps_one_graph_a_task(monkeypatch):
    monkeypatch.setattr(ft, "step_graphs", {})
    lib, built = _StandInLibrary(), []

    def build(handle):
        def make():
            built.append(handle)
            g = ft._StepGraph.__new__(ft._StepGraph)
            g.lib, g.handle = lib, handle
            return g
        return make

    keys = {task: ft.step_graph_key(task, "cuda:0", dims(task), 32, False, False)
            for task in ft.STEP_GRAPH_TASKS}
    handles = {task: h for h, task in enumerate(ft.STEP_GRAPH_TASKS, 1)}
    first = {task: ft.cached_graph(ft.step_graphs, task, keys[task], build(handles[task]))
             for task in ft.STEP_GRAPH_TASKS}
    for _ in range(2):  # the tasks alternate, call by call: nothing is captured again
        for task in first:
            assert ft.cached_graph(ft.step_graphs, task, keys[task], build(99)) is first[task]
    assert built == [1, 2, 3] and lib.freed == []
    del first
    other = ft.step_graph_key("multimodal", "cuda:0", dims("multimodal"), 32, True, False)
    ft.cached_graph(ft.step_graphs, "multimodal", other, build(4))
    # its old graph only, before the capture
    assert lib.freed == [handles["multimodal"]] and built == [1, 2, 3, 4]
    assert {t: g.handle for t, (_, g) in ft.step_graphs.items()} == dict(handles, multimodal=4)


class _CaptureLibrary(_StandInLibrary):
    """What `_StepGraph` calls to capture an RNA→DNA step, recording the
    pointers the capture entry is given."""

    def __init__(self, n_params):
        super().__init__()
        self.n_params, self.created = n_params, None

    def rna2dna_param_count(self, dims):
        return self.n_params

    def rna2dna_train_workspace_floats(self, dims, batch, with_grads):
        return 8

    def rna2dna_step_graph_create(self, *args):
        self.created = args
        return 7

    def graph_nodes(self, handle):
        return 18


@pytest.mark.parametrize("injected", [False, True])
def test_rna2dna_graph_takes_the_statistics_as_rm_then_rv(injected):
    """The B1 wrapper's BatchNorm views: rm and rv copied into one buffer, rm
    first, whose start is the entry's bn_in (the C entry takes rv at bn_in +
    hidden); the new statistics written at bn_out, rm then rv, after the
    gradients, and read back by the wrapper as (rm, rv)."""
    params, state = INITS["rna2dna"]()
    flat = ft.flatten_params(params)
    bn = state["encoder_rna"]["bn"]
    rows = (torch.zeros(4, DIM_A), torch.zeros(4, DIM_B))
    noise = (torch.zeros(4, LATENT), torch.ones(4, 128)) if injected else ()
    sources = [flat[name] for name, _ in ft.PARAM_ORDER] + [bn["mean"], bn["var"]] + [
        *rows, *noise]
    n_params = sum(t.numel() for t in sources[:len(ft.PARAM_ORDER)])
    lib = _CaptureLibrary(n_params)
    d = ft.dims_of(flat)
    key = ft.step_graph_key("rna2dna", torch.device("cpu"), d, 4, injected, False)
    g = ft._StepGraph(lib, key, sources)
    assert (g.handle, g.nodes) == (7, 18) and ft.graph_widths("rna2dna", d)[0] == 2 * 128
    n = len(ft.PARAM_ORDER)
    rm, rv = g.targets[n], g.targets[n + 1]
    x, t, site, p, dims_c, batch, bn_in, bn_out, eps, drop, mode, args, loss, grads, work, pdl, \
        err = lib.created
    assert (x, t, site, p) == (rows_ptr := g.targets[n + 2].data_ptr(),
                               g.targets[n + 3].data_ptr(), g.site.data_ptr(),
                               g.inp.data_ptr()) and rows_ptr == rm.data_ptr() + 4 * 256
    assert list(dims_c) == list(d) and batch == 4 and pdl == 1
    assert bn_in == rm.data_ptr() and rv.data_ptr() == bn_in + 4 * 128
    assert bn_out == g.out[n_params].data_ptr() and grads == g.out.data_ptr()
    assert loss == g.out[-1].data_ptr() and g.out.numel() == n_params + 2 * 128 + 1
    assert (work, args) == (g.work.data_ptr(), g.args.data_ptr())
    if injected:
        assert (eps, drop, mode) == (g.targets[n + 4].data_ptr(), g.targets[n + 5].data_ptr(),
                                     ft.NOISE_INJECTED)
    else:
        assert (eps, drop, mode) == (None, None, ft.NOISE_PHILOX)
    # the outputs as `_run_step` splits them: the gradients, rm, rv, the loss
    g.out.copy_(torch.arange(g.out.numel(), dtype=torch.float32))
    out = torch._C._nn.unflatten_dense_tensors(g.out.clone(), g.out_like)
    assert [tuple(o.shape) for o in out[:n]] == [tuple(flat[k].shape) for k, _ in ft.PARAM_ORDER]
    got_rm, got_rv = out[n:-1]
    assert torch.equal(got_rm, torch.arange(n_params, n_params + 128, dtype=torch.float32))
    assert torch.equal(got_rv, torch.arange(n_params + 128, n_params + 256, dtype=torch.float32))
    assert out[-1].shape == () and out[-1].item() == n_params + 256
    g.handle = None  # the stand-in's handle is not freed
