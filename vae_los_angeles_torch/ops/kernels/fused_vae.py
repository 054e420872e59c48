"""Fused eval forwards of the directional VAEs (counterpart of
``vae_los_angeles_tpu/ops/pallas/fused_vae.py``).

`FusedRNA2DNA` / `FusedDNA2RNA` take the JAX package's ``(params, state)``
pytrees (the checkpoint layout), fold eval BatchNorm into the encoder
Linears once (`ops.nn.fold_bn_eval`), stage the folded weights on their
device once, and serve ``recon, mu, logvar = fused(x, site, seed=...)``:

  * for CUDA tensors, one call of the hand-written kernels in
    ``csrc/fused_vae.cu`` (built at first use, see `_build`): the cluster
    trunk, plus a whole-grid sweep for a first layer at least `SWEEP_MIN_IN`
    or an output layer at least `SWEEP_MIN_OUT` wide, as `serving_plan` lays
    out once per batch bucket (`serving_bucket`: one to three kernel launches
    on the caller's stream); a tensor the
    kernels do not take, or a plan that cannot launch, raises, and nothing
    falls back;
  * for CPU tensors, the plain PyTorch version beside it
    (`rna2dna_fused_reference` / `dna2rna_fused_reference`), which computes
    the same function on the same folded weights.

Noise: ``use_noise=False`` gives z = mu; an injected ``eps`` (B, latent)
gives z = mu + eps·exp(logvar/2) exactly, on both routes; otherwise eps is
drawn from ``seed`` — in the kernel by Philox4x32-10 and Box–Muller at
(seed, global row, latent index), which `philox_normal_reference` computes
in plain PyTorch, in the plain version from a ``torch.Generator`` seeded
with it, so the two routes agree only in distribution there. ``row0`` is
the global row of the call's first row (a rank serving its rows of a
sharded cohort): the kernel draws at row0 + row, and the plain version
draws the whole ``rows_total``-row cohort's eps and takes its rows, so
either route gives each row the noise of the whole cohort's call.

``launches`` (a class attribute) counts the calls of each class's C entry,
one per served batch, so a run can show that its serving path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from vae_los_angeles_torch.ops.kernels._build import build
from vae_los_angeles_torch.ops.nn import fold_bn_eval

NOISE_NONE, NOISE_PHILOX, NOISE_EPS = 0, 1, 2
ACT_NONE, ACT_RELU, ACT_SIGMOID = 0, 1, 2

# csrc/fused_vae.cu's tiling constants, mirrored for `serving_plan`
MAX_SMEM = 232_448  # shared memory a block can opt into on sm_90
TRUNK_THREADS = 512
TR = 4  # rows of a trunk thread's register tile
SLOTS = 4  # slots of a trunk CTA's weight ring
SLOT_MAX = 8192  # floats a slot at most
SLOT_MIN = 1024
RED_FLOATS = 16 * TRUNK_THREADS
PIECE_FLOATS = 1024
MAX_PIECES = 24
SW_COLS, SW_ROWS = 128, 128  # a sweep CTA's output columns and rows
SW_KC = 32  # input columns a sweep chunk stages
SWEEP_SMEM = 4 * 2 * (SW_ROWS * SW_KC + SW_KC * SW_COLS)
MAX_ROWS = 32  # rows of a trunk tile at most
CLUSTER = 8  # CTAs of a trunk cluster (the portable maximum)
# A first layer this many inputs wide, or an output layer this many outputs
# wide, leaves the cluster trunk for a whole-grid sweep that reads its weight
# once a call (PERF.md: `python3 chip_probes.py serving`, the call's time by
# width both ways on the card).
SWEEP_MIN_IN = 8_192
SWEEP_MIN_OUT = 16_384


def _site_rows(table, site):
    """Embedding rows of ``site``; an index outside the table gives a zero
    row, as the TPU kernel's one-hot matmul does."""
    n = table.shape[0]
    valid = (site >= 0) & (site < n)
    return table[site.clamp(0, n - 1)] * valid[:, None].to(table.dtype)


def _posterior(f, h, site, noise, eps, seed, row0=0, rows_total=None):
    mu = h @ f["wmu"] + f["bmu"]
    logvar = h @ f["wlv"] + f["blv"]
    if site is not None:
        e = _site_rows(f["emb"], site)
        mu = 0.5 * (mu + (e @ f["smu_w"] + f["smu_b"]))
        logvar = 0.5 * (logvar + (e @ f["slv_w"] + f["slv_b"]))
    if noise == NOISE_NONE:
        return mu, logvar, mu
    if noise == NOISE_PHILOX:
        g = torch.Generator(device=mu.device).manual_seed(seed)
        rows = mu.shape[0]
        total = row0 + rows if rows_total is None else rows_total
        eps = torch.randn((total, mu.shape[1]), generator=g, device=mu.device,
                          dtype=mu.dtype)[row0:row0 + rows]
    return mu, logvar, mu + eps * torch.exp(0.5 * logvar)


def rna2dna_fused_reference(f, x, site=None, noise=NOISE_NONE, eps=None, seed=0, row0=0,
                            rows_total=None):
    """Plain PyTorch version of the RNA→DNA kernel on folded weights ``f``:
    returns (recon in [0, 1], mu, logvar)."""
    h = torch.relu(x @ f["w1"] + f["b1"])
    mu, logvar, z = _posterior(f, h, site, noise, eps, seed, row0, rows_total)
    h1 = torch.relu(z @ f["d1w"] + f["d1b"])
    h2 = torch.relu(h1 @ f["d2w"] + f["d2b"])
    return torch.sigmoid(h2 @ f["d3w"] + f["d3b"]), mu, logvar


def dna2rna_fused_reference(f, x, site=None, noise=NOISE_NONE, eps=None, seed=0, row0=0,
                            rows_total=None):
    """Plain PyTorch version of the DNA→RNA kernel on folded weights ``f``:
    returns (recon, mu, logvar)."""
    h = torch.relu(x @ f["w1"] + f["b1"])
    h = torch.relu(h @ f["w2"] + f["b2"])
    mu, logvar, z = _posterior(f, h, site, noise, eps, seed, row0, rows_total)
    h1 = torch.relu(z @ f["d1w"] + f["d1b"])
    return h1 @ f["d2w"] + f["d2b"], mu, logvar


# ---------------------------------------------------------------------------
# the kernel's Philox4x32-10 draw in plain PyTorch

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of the constant ``a`` times ``b`` (int64
    holding uint32 values), from 16-bit halves so nothing overflows int64."""
    u, t = (a >> 16) * b, (a & 0xFFFF) * b  # each < 2**48
    return (u + (t >> 16)) >> 16, (((u & 0xFFFF) << 16) + t) & _M32


def philox4x32_10_reference(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    counter words, key (k0, k1): the four output words, as the kernel's
    ``philox4x32_10``."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def philox_normal_reference(seed: int, rows: int, latent: int, device=None, row0: int = 0):
    """The (rows, latent) float32 standard normals the serving kernel draws
    for global rows [row0, row0 + rows): Philox4x32-10 keyed by the 64-bit
    seed at counter (row, j, 0, 0), then Box–Muller on the top 24 bits of the
    first two words as (0, 1] uniforms, in float32 as the kernel computes
    it. Passed as ``eps``, it gives the kernel's Philox call bit for bit."""
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(latent, dtype=torch.int64, device=device)[None, :]
    c0, c1 = r.expand(rows, latent), j.expand(rows, latent)
    zero = torch.zeros_like(c0)
    w0, w1, _, _ = philox4x32_10_reference(c0, c1, zero, zero, seed & _M32, (seed >> 32) & _M32)
    u1 = ((w0 >> 8) + 1).to(torch.float32) * (1.0 / 16777216.0)
    u2 = ((w1 >> 8) + 1).to(torch.float32) * (1.0 / 16777216.0)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.283185307179586 * u2)


# ---------------------------------------------------------------------------
# the launch plan


def _pad(n: int) -> int:
    return -(-n // 4) * 4


def _round64(n: int) -> int:
    return -(-n // 64) * 64


def _layers(dims):
    """(encoder widths, decoder widths) of the nine widths of a model
    (in, h1, h2, latent, sites, embed, d1, d2, out): RNA→DNA has h2 = 0 and
    a decoder d1 -> d2 -> out, DNA→RNA d2 = 0 and d1 -> out."""
    _, h1, h2, _, _, _, d1, d2, out = dims
    enc = (h1,) if h2 == 0 else (h1, h2)
    dec = (d1, d2, out) if h2 == 0 else (d1, out)
    return enc, dec


def _act_floats(dims, rows):
    """The activation buffers of a trunk CTA in floats."""
    enc, dec = _layers(dims)
    return _pad(rows) * (sum(_pad(n) for n in enc) + 5 * _pad(dims[3]) + _pad(dims[5])
                         + sum(_pad(n) for n in dec[:-1]))


def _trunk_floats(dims, rows, slot_f):
    """Shared memory of a trunk CTA in floats (csrc/fused_vae.cu trunk_smem)."""
    return PIECE_FLOATS + SLOTS * slot_f + RED_FLOATS + _act_floats(dims, rows)


def _slot_floats(dims, rows):
    """The largest slot (a multiple of 4 floats, at most SLOT_MAX) that the
    shared memory left by the other buffers holds SLOTS of."""
    free = MAX_SMEM // 4 - PIECE_FLOATS - RED_FLOATS - _act_floats(dims, rows)
    return min(SLOT_MAX, (free // SLOTS) & ~3)


def _piece_quads(rows, slot_f, rows_staged):
    rb = _pad(rows)
    return min(TRUNK_THREADS // (rb // TR), (slot_f - (4 * rb if rows_staged else 0)) // 20)


def trunk_columns(n: int, rows: int = 4, slot_f: int = SLOT_MAX, rows_staged: bool = False):
    """For each CTA rank of a cluster, the column ranges [c0, c1) of the
    pieces in which it computes an n-wide trunk product (csrc/fused_vae.cu
    quad_range and add_pieces): its run of the quads of four columns, cut
    into pieces of at most `_piece_quads`; c1 may pass n by the zero
    padding."""
    q, qmax = _pad(n) // 4, _piece_quads(rows, slot_f, rows_staged)
    out = []
    for r in range(CLUSTER):
        q0, q1 = r * q // CLUSTER, (r + 1) * q // CLUSTER
        out.append([(4 * a, 4 * min(a + qmax, q1)) for a in range(q0, q1, qmax)])
    return out


def _max_pieces(dims, rows, slot_f, in_sweep, out_sweep):
    """The most pieces a trunk CTA builds (csrc/fused_vae.cu max_pieces)."""
    enc, dec = _layers(dims)
    products = [(n, False) for n in enc[1:]] + [(2 * _pad(dims[3]), False)] * 2
    products += [(n, False) for n in (dec[:-1] if out_sweep else dec)]
    if not in_sweep:
        products.append((enc[0], True))
    return max(sum(len(trunk_columns(n, rows, slot_f, staged)[r])
                   for n, staged in products) for r in range(CLUSTER))


class Plan(NamedTuple):
    """The launch plan of calls of up to ``batch`` rows (the C struct Plan's
    fields, then the grids, scratch and kernel count of a call of ``batch``
    rows; a call of n rows launches ceil(n / rows) clusters and ceil(n /
    SW_ROWS) sweep row blocks)."""
    batch: int  # rows a call at most
    rows: int  # rows of a trunk tile (one cluster of CLUSTER CTAs)
    trunk_smem: int  # bytes a trunk CTA
    slot_f: int  # floats a slot of a trunk CTA's weight ring
    in_sweep: int  # 1: the first layer runs as the input sweep
    in_slabs: int
    in_splits: int
    in_kps: int  # inputs of a split
    out_sweep: int  # 1: the output layer runs as the output sweep
    out_slabs: int
    clusters: int
    in_row_blocks: int
    out_row_blocks: int
    part_floats: int  # the input sweep's partial sums (in_splits x batch x pad4(h1))
    hid_floats: int  # the trunk's last hidden layer for the output sweep
    sweep_smem: int  # bytes a sweep CTA
    kernels: int  # kernel launches a call


def serving_bucket(batch: int) -> int:
    """The batch bucket of a call of ``batch`` rows: the power of two at or
    above it. A wrapper lays out one plan a bucket (`serving_plan` of the
    bucket), which serves every batch in it."""
    return 1 << max(0, batch - 1).bit_length()


def serving_plan(dims, batch: int, sms: int) -> Plan:
    """The launch plan of calls of up to ``batch`` rows on a card with
    ``sms`` SMs, for a model of the nine widths ``dims`` (see `_layers`).

    The trunk's tile is the multiple of 4 rows (at most `MAX_ROWS`) that lets
    one cluster per `CLUSTER` SMs cover the batch in one wave where it can
    (B = 205: 16 rows, 13 clusters of 8, 104 SMs), and fewer where the
    shared memory does not hold it. A first layer of at least `SWEEP_MIN_IN`
    inputs runs as the input sweep, its inputs split so that about four CTAs
    an SM share the work; an output layer of at least `SWEEP_MIN_OUT` columns
    as the output sweep."""
    if batch < 1 or sms < 1:
        raise ValueError(f"no plan for batch {batch} on {sms} SMs")
    enc, dec = _layers(dims)
    d_in, out = dims[0], dims[8]
    in_sweep, out_sweep = int(d_in >= SWEEP_MIN_IN), int(out >= SWEEP_MIN_OUT)
    waves = max(1, sms // CLUSTER)
    rows = min(MAX_ROWS, 4 * -(-batch // (4 * waves)))
    fits = lambda r: (_slot_floats(dims, r) >= SLOT_MIN and _max_pieces(  # noqa: E731
        dims, r, _slot_floats(dims, r), in_sweep, out_sweep) <= MAX_PIECES)
    while rows > 4 and not fits(rows):
        rows -= 4
    if not fits(rows):
        raise ValueError(f"no trunk tile fits the shared memory of a CTA for widths {dims}")
    slot_f = _slot_floats(dims, rows)
    trunk_smem = 4 * _trunk_floats(dims, rows, slot_f)
    row_blocks = -(-batch // SW_ROWS)
    in_slabs = in_splits = in_kps = in_rb = part = 0
    if in_sweep:
        in_slabs, in_rb = -(-_pad(enc[0]) // SW_COLS), row_blocks
        want = max(1, -(-4 * sms // (in_slabs * in_rb)))
        in_kps = SW_KC * max(8, -(-d_in // (SW_KC * want)))
        in_splits = -(-d_in // in_kps)
        part = in_splits * batch * _pad(enc[0])
    out_slabs = out_rb = hid = 0
    if out_sweep:
        out_slabs, out_rb = -(-out // SW_COLS), row_blocks
        hid = batch * _pad(dec[-2])
    return Plan(batch, rows, trunk_smem, slot_f, in_sweep, in_slabs, in_splits, in_kps,
                out_sweep, out_slabs, -(-batch // rows), in_rb, out_rb, part, hid, SWEEP_SMEM,
                1 + in_sweep + out_sweep)


# ---------------------------------------------------------------------------
# the C side


class _Model(ctypes.Structure):
    _fields_ = [
        ("ew", ctypes.c_void_p * 2), ("eb", ctypes.c_void_p * 2),
        ("wh", ctypes.c_void_p), ("bh", ctypes.c_void_p), ("emb", ctypes.c_void_p),
        ("ws", ctypes.c_void_p), ("bs", ctypes.c_void_p),
        ("dw", ctypes.c_void_p * 3), ("db", ctypes.c_void_p * 3),
        ("d_in", ctypes.c_int), ("en", ctypes.c_int * 2), ("n_enc", ctypes.c_int),
        ("latent", ctypes.c_int), ("sites", ctypes.c_int), ("embed", ctypes.c_int),
        ("dn", ctypes.c_int * 3), ("n_dec", ctypes.c_int), ("out_act", ctypes.c_int),
    ]


class _Plan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in Plan._fields[:10]]


@functools.lru_cache(maxsize=None)
def _library():
    """libfused_vae.so, built at first use, with its C signatures declared."""
    lib = build("fused_vae").lib
    for entry in ("rna2dna_fused_forward", "dna2rna_fused_forward"):
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 11 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    lib.fused_vae_setup.argtypes = []
    lib.fused_vae_setup.restype = ctypes.c_int
    lib.fused_vae_max_clusters.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.fused_vae_max_clusters.restype = ctypes.c_int
    lib.fused_vae_tables.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_longlong]
    lib.fused_vae_tables.restype = ctypes.c_int
    lib.fused_vae_table_bytes.argtypes = []
    lib.fused_vae_table_bytes.restype = ctypes.c_int
    lib.fused_vae_error_string.argtypes = [ctypes.c_int]
    lib.fused_vae_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(lib, err, what):
    if err != 0:
        msg = lib.fused_vae_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _setup(index: int):
    """The kernels' attributes on card ``index``, once a process."""
    lib = _library()
    with torch.cuda.device(index):
        _check_cuda(lib, lib.fused_vae_setup(), "fused_vae_setup")


def _t(a, device):
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.array(a, np.float32, order="C")).to(device)  # own copy


def _pad4(t):
    """``t`` with every dim zero-padded to a multiple of 4 (``t`` itself
    where every dim is one already)."""
    if all(n % 4 == 0 for n in t.shape) and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros([_pad(n) for n in t.shape])
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _slab_major(w):
    """The padded (Kp, Np) weight ``w`` in the trunk's slab-major order:
    cluster rank r's columns [4 q0, 4 q1) (its quads, csrc/fused_vae.cu
    quad_range) as one contiguous (Kp, 4 (q1 - q0)) block, the blocks in rank
    order, so a CTA streams its slab as whole chunks."""
    q = w.shape[1] // 4
    return torch.cat([w[:, 4 * (r * q // CLUSTER): 4 * ((r + 1) * q // CLUSTER)].reshape(-1)
                      for r in range(CLUSTER)])


def _pack_heads(w_mu, w_lv, b_mu, b_lv):
    """[mu | logvar] heads, each half pad4(latent) wide, rows padded: the
    kernel computes both in one product."""
    lp = _pad(w_mu.shape[1])
    w = w_mu.new_zeros((_pad(w_mu.shape[0]), 2 * lp))
    b = b_mu.new_zeros((2 * lp,))
    w[: w_mu.shape[0], : w_mu.shape[1]] = w_mu
    w[: w_lv.shape[0], lp: lp + w_lv.shape[1]] = w_lv
    b[: b_mu.shape[0]] = b_mu
    b[lp: lp + b_lv.shape[0]] = b_lv
    return w, b


def _site_heads(params):
    s = params["encoder_site"]
    return {
        "emb": s["embedding"]["table"],
        "smu_w": s["mu"]["w"], "smu_b": s["mu"]["b"],
        "slv_w": s["logvar"]["w"], "slv_b": s["logvar"]["b"],
    }


class _Call(NamedTuple):
    """What the calls of one batch bucket need, built once
    (`_FusedForward.plan`)."""
    plan: Plan
    cplan: ctypes.Structure  # the C Plan (kept alive for plan_addr)
    plan_addr: int
    tables: list  # the trunk's piece tables on the card, without and with a site
    table_ptrs: tuple
    scratch: tuple  # floats of the partial sums and of the hidden rows, for plan.batch rows


class _FusedForward:
    launches = 0  # calls of this class's C entry; set to 0 to start a count
    _entry = ""  # C entry point in libfused_vae.so
    _reference = None
    _enc = ()  # folded encoder weights, in order
    _dec = ()  # folded decoder weights, in order; the last is the output layer
    _out_act = ACT_NONE

    def __init__(self, folded: dict, device=None):
        device = torch.device("cpu" if device is None else device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.in_dim = int(folded["w1"].shape[0])
        self.latent = int(folded["wmu"].shape[1])
        self.n_sites = int(folded["emb"].shape[0])
        if device.type != "cuda":
            self.folded = {k: _t(v, device) for k, v in folded.items()}
            return
        # The kernels' copies, every dim zero-padded to a multiple of 4 floats
        # so each weight row starts 16-byte aligned; `folded` holds views of
        # them (the plain version's operands), so a wide layer is held once.
        padded, self.folded = {}, {}
        for k, v in folded.items():
            padded[k] = _pad4(_t(v, device))
            self.folded[k] = padded[k][tuple(slice(0, n) for n in v.shape)]
        f = self.folded
        padded["wh"], padded["bh"] = _pack_heads(f["wmu"], f["wlv"], f["bmu"], f["blv"])
        padded["ws"], padded["bs"] = _pack_heads(f["smu_w"], f["slv_w"], f["smu_b"], f["slv_b"])
        for k in ("wmu", "wlv", "bmu", "blv", "smu_w", "slv_w", "smu_b", "slv_b"):
            del padded[k]  # the packed copies serve the kernel; the views stay
        self._padded = padded  # keeps the kernel's weights alive
        p = lambda k: padded[k].data_ptr()  # noqa: E731
        dims = self._dims()
        enc, dec = _layers(dims)
        m = _Model()
        for i, (w, b) in enumerate(self._enc):
            m.ew[i], m.eb[i] = p(w), p(b)
        for i, (w, b) in enumerate(self._dec):
            m.dw[i], m.db[i] = p(w), p(b)
        m.wh, m.bh, m.emb, m.ws, m.bs = p("wh"), p("bh"), p("emb"), p("ws"), p("bs")
        m.d_in, m.n_enc, m.n_dec, m.out_act = dims[0], len(enc), len(dec), self._out_act
        m.latent, m.sites, m.embed = dims[3], dims[4], dims[5]
        for i, n in enumerate(enc):
            m.en[i] = n
        for i, n in enumerate(dec):
            m.dn[i] = n
        self._cmodel = m
        self._model_addr = ctypes.addressof(m)
        self._slabs = {}  # weight -> its slab-major copy (`_table_model`)
        self._sms = torch.cuda.get_device_properties(device).multi_processor_count
        self._calls = {}  # batch bucket -> its `_Call`
        _setup(device.index)
        self._fn = getattr(_library(), self._entry)
        self._out = dims[-1]

    def _dims(self):
        raise NotImplementedError

    def _table_model(self, plan):
        """The C model with its trunk weights slab-major (`_slab_major`),
        each copy made once per weight (a wide first or output layer only
        once a plan runs it in the trunk); the piece tables point into these
        copies."""
        m = _Model.from_buffer_copy(self._cmodel)
        enc, dec = [w for w, _ in self._enc], [w for w, _ in self._dec]
        skip = {enc[0]} if plan.in_sweep else set()
        if plan.out_sweep:
            skip.add(dec[-1])

        def slab(name):
            if name in skip:
                return self._padded[name].data_ptr()  # the sweep's, unused by the trunk
            if name not in self._slabs:
                self._slabs[name] = _slab_major(self._padded[name])
            return self._slabs[name].data_ptr()

        for i, name in enumerate(enc):
            m.ew[i] = slab(name)
        for i, name in enumerate(dec):
            m.dw[i] = slab(name)
        m.wh, m.ws = slab("wh"), slab("ws")
        return m

    def plan(self, batch: int):
        """The `_Call` of ``batch`` rows' bucket (`serving_bucket`): built and
        checked once a bucket, so a call only allocates and launches."""
        key = serving_bucket(batch)
        got = self._calls.get(key)
        if got is None:
            got = self._calls[key] = self._build_call(serving_plan(self._dims(), key, self._sms))
        return got

    def _build_call(self, plan: Plan):
        """The C plan and the piece tables of ``plan``, the tables copied to
        the card from pinned memory without waiting for the stream; a plan
        whose trunk cluster cannot be resident raises."""
        lib, n = _library(), ctypes.c_int(0)
        with torch.cuda.device(self.device):
            err = lib.fused_vae_max_clusters(plan.trunk_smem, ctypes.byref(n))
        _check_cuda(lib, err, "fused_vae_max_clusters")
        if n.value < 1:
            raise RuntimeError(f"{self._entry}: no cluster of {CLUSTER} CTAs with "
                               f"{plan.trunk_smem} bytes of shared memory can be resident")
        cplan = _Plan(*plan[:10])
        tmodel = self._table_model(plan)
        nbytes = lib.fused_vae_table_bytes() * CLUSTER
        tables = []
        for has_site in (0, 1):
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            err = lib.fused_vae_tables(ctypes.addressof(tmodel), ctypes.addressof(cplan),
                                       has_site, host.data_ptr(), nbytes)
            _check_cuda(lib, err, "fused_vae_tables")
            tables.append(host.to(self.device, non_blocking=True))
        return _Call(plan, cplan, ctypes.addressof(cplan), tables,
                     tuple(t.data_ptr() for t in tables),
                     (_round64(plan.part_floats), _round64(plan.hid_floats)))

    def _check(self, name, t, dtype, shape):
        if (isinstance(t, torch.Tensor) and t.dtype == dtype and t.shape == shape
                and t.device == self.device and t.is_contiguous()):
            return
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != self.device:
            raise ValueError(f"{name} is on {t.device}; this model's weights are on {self.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    def __call__(self, x, site: Optional[torch.Tensor] = None, seed: int = 0,
                 use_noise: bool = True, eps: Optional[torch.Tensor] = None, row0: int = 0,
                 rows_total: Optional[int] = None):
        if not isinstance(x, torch.Tensor) or x.dim() != 2:
            raise ValueError("x must be a 2-D torch.Tensor (batch, features)")
        batch = x.shape[0]
        self._check("x", x, torch.float32, (batch, self.in_dim))
        if site is not None:
            self._check("site", site, torch.int64, (batch,))
        if eps is not None:
            if not use_noise:
                raise ValueError("eps was given with use_noise=False")
            self._check("eps", eps, torch.float32, (batch, self.latent))
            noise = NOISE_EPS
        else:
            noise = NOISE_PHILOX if use_noise else NOISE_NONE
        seed = int(seed)
        if not 0 <= seed < 2**63:
            raise ValueError(f"seed must be in [0, 2**63), got {seed}")

        row0 = int(row0)
        if row0 < 0 or (rows_total is not None and row0 + batch > rows_total):
            raise ValueError(f"rows [{row0}, {row0 + batch}) outside a cohort of {rows_total}")
        if self.device.type == "cpu":
            return type(self)._reference(self.folded, x, site, noise, eps, seed, row0, rows_total)
        if self.device.type != "cuda":
            raise ValueError(f"no kernel for device {self.device}")
        return self._launch(x, site, eps, noise, seed, row0)

    def _launch(self, x, site, eps, noise, seed, row0=0):
        batch, dev = x.shape[0], self.device
        if batch == 0:
            return (torch.empty((0, self._out), device=dev),
                    torch.empty((0, self.latent), device=dev),
                    torch.empty((0, self.latent), device=dev))
        c = self.plan(batch)
        # one allocation: recon, mu, logvar, then the sweeps' scratch (sized
        # for the bucket), each starting 256-byte aligned
        n_out, n_lat = _round64(batch * self._out), _round64(batch * self.latent)
        sizes = (n_out, n_lat, n_lat) + c.scratch
        buf = torch.empty(sum(sizes), device=dev, dtype=torch.float32)
        p0 = buf.data_ptr()
        p1 = p0 + 4 * n_out
        p2 = p1 + 4 * n_lat
        p3 = p2 + 4 * n_lat
        p4 = p3 + 4 * c.scratch[0]
        args = (
            self._model_addr, c.plan_addr, c.table_ptrs[site is not None], x.data_ptr(),
            None if site is None else site.data_ptr(), None if eps is None else eps.data_ptr(),
            p0, p1, p2, p3 if c.scratch[0] else None, p4 if c.scratch[1] else None, batch,
            int(site is not None), noise, seed, row0,
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
        if torch.cuda.current_device() == dev.index:
            err = self._fn(*args)
        else:
            with torch.cuda.device(dev):
                err = self._fn(*args)
        recon, mu, logvar = buf.split_with_sizes(sizes)[:3]
        recon = recon[: batch * self._out].view(batch, self._out)
        mu = mu[: batch * self.latent].view(batch, self.latent)
        logvar = logvar[: batch * self.latent].view(batch, self.latent)
        if err != 0:
            _check_cuda(_library(), err, f"{self._entry} (launch)")
        type(self).launches += 1
        return recon, mu, logvar


class FusedRNA2DNA(_FusedForward):
    """Fused eval forward over trained RNA2DNAVAE params (JAX layout):
    ``recon, mu, logvar = fused(rna, site, seed=..., use_noise=..., eps=...)``.
    """

    launches = 0
    _entry = "rna2dna_fused_forward"
    _reference = staticmethod(rna2dna_fused_reference)
    _enc = (("w1", "b1"),)
    _dec = (("d1w", "d1b"), ("d2w", "d2b"), ("d3w", "d3b"))
    _out_act = ACT_SIGMOID

    def __init__(self, params, state, device=None):
        w1, b1 = fold_bn_eval(
            {k: _t(v, "cpu") for k, v in params["encoder_rna"]["fc"].items()},
            {k: _t(v, "cpu") for k, v in params["encoder_rna"]["bn"].items()},
            {k: _t(v, "cpu") for k, v in state["encoder_rna"]["bn"].items()},
        )
        enc, dec = params["encoder_rna"], params["decoder_dna"]
        super().__init__({
            "w1": w1, "b1": b1,
            "wmu": enc["mu"]["w"], "bmu": enc["mu"]["b"],
            "wlv": enc["logvar"]["w"], "blv": enc["logvar"]["b"],
            **_site_heads(params),
            "d1w": dec["fc1"]["w"], "d1b": dec["fc1"]["b"],
            "d2w": dec["fc2"]["w"], "d2b": dec["fc2"]["b"],
            "d3w": dec["fc3"]["w"], "d3b": dec["fc3"]["b"],
        }, device)

    def _dims(self):
        f = self.folded
        return (self.in_dim, f["w1"].shape[1], 0, self.latent, self.n_sites,
                f["emb"].shape[1], f["d1w"].shape[1], f["d2w"].shape[1], f["d3w"].shape[1])


class FusedDNA2RNA(_FusedForward):
    """Fused eval forward over trained DNA2RNAVAE params (JAX layout);
    mirrors `FusedRNA2DNA` with a linear RNA head."""

    launches = 0
    _entry = "dna2rna_fused_forward"
    _reference = staticmethod(dna2rna_fused_reference)
    _enc = (("w1", "b1"), ("w2", "b2"))
    _dec = (("d1w", "d1b"), ("d2w", "d2b"))
    _out_act = ACT_NONE

    def __init__(self, params, state, device=None):
        enc, dec = params["encoder_dna"], params["decoder_rna"]
        enc_s = state["encoder_dna"]
        folded = {}
        for i in (1, 2):
            folded[f"w{i}"], folded[f"b{i}"] = fold_bn_eval(
                {k: _t(v, "cpu") for k, v in enc[f"fc{i}"].items()},
                {k: _t(v, "cpu") for k, v in enc[f"bn{i}"].items()},
                {k: _t(v, "cpu") for k, v in enc_s[f"bn{i}"].items()},
            )
        super().__init__({
            **folded,
            "wmu": enc["mu"]["w"], "bmu": enc["mu"]["b"],
            "wlv": enc["logvar"]["w"], "blv": enc["logvar"]["b"],
            **_site_heads(params),
            "d1w": dec["fc1"]["w"], "d1b": dec["fc1"]["b"],
            "d2w": dec["fc2"]["w"], "d2b": dec["fc2"]["b"],
        }, device)

    def _dims(self):
        f = self.folded
        return (self.in_dim, f["w1"].shape[1], f["w2"].shape[1], self.latent, self.n_sites,
                f["emb"].shape[1], f["d1w"].shape[1], 0, f["d2w"].shape[1])
