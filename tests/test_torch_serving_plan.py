"""The serving kernels' launch plan and Philox draw (``ops/kernels/fused_vae.py``),
on the CPU.

`serving_plan` lays out a call of ``csrc/fused_vae.cu``: the cluster trunk's
row tiles, each CTA's column pieces, shared memory, and the sweeps a wide
first or output layer leaves for, laid out once a batch bucket. These tests
hold the plan's arithmetic at the widths the port trains (RNA 1177, DNA 1211,
the DNA inputs and outputs of the wide regime) for the batches it serves,
and that the batches of a bucket share one plan; the kernels themselves run
only on a card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
`philox_normal_reference` is held against the Random123 known-answer vectors
of Philox4x32-10."""

import numpy as np
import pytest
import torch

from vae_los_angeles_torch.models import DNA2RNAVAE, RNA2DNAVAE
from vae_los_angeles_torch.ops.kernels import fused_vae as fv
from vae_los_angeles_torch.utils.weights import jax_from_state_dict

# Tiny tensors: one intra-op thread, so that the xdist workers' OpenMP threads,
# which spin at each barrier, do not oversubscribe the cores.
torch.set_num_threads(1)

SMS = 132  # the H100 SXM's SMs
WIDTHS = (1177, 1211, 6_623, 65_536, 450_000)
SERVED = (1, 37, 205, 1600, 4096)


def dims(model_type, dna):
    """The nine widths (in, h1, h2, latent, sites, embed, d1, d2, out) of a
    directional model at the live widths, DNA ``dna`` wide."""
    if model_type == "rna2dna":
        return (1177, 128, 0, 20, 24, 32, 256, 512, dna)
    return (dna, 512, 256, 20, 24, 32, 128, 0, 1177)


def trunk_products(d, plan):
    """(width, input rows staged) of each product the trunk computes."""
    enc, dec = fv._layers(d)
    out = [] if plan.in_sweep else [(enc[0], True)]
    out += [(n, False) for n in enc[1:]] + [(2 * fv._pad(d[3]), False)] * 2
    return out + [(n, False) for n in (dec[:-1] if plan.out_sweep else dec)]


@pytest.mark.parametrize("model_type", ["rna2dna", "dna2rna"])
@pytest.mark.parametrize("dna", WIDTHS)
def test_plan_covers_every_row_and_column_once(model_type, dna):
    d = dims(model_type, dna)
    for batch in SERVED:
        plan = fv.serving_plan(d, batch, SMS)
        # row tiles: the clusters cover the batch, none of them idle
        assert plan.clusters * plan.rows >= batch > (plan.clusters - 1) * plan.rows
        assert plan.rows % 4 == 0 and plan.rows <= fv.MAX_ROWS
        # every column of every trunk product on exactly one CTA of a cluster
        for n, staged in trunk_products(d, plan):
            pieces = fv.trunk_columns(n, plan.rows, plan.slot_f, staged)
            cols = [c for rank in pieces for a, b in rank for c in range(a, b)]
            assert sorted(cols) == list(range(fv._pad(n)))
        assert fv._max_pieces(d, plan.rows, plan.slot_f, plan.in_sweep,
                              plan.out_sweep) <= fv.MAX_PIECES
        # the sweeps: slabs of 128 columns, splits of the input, blocks of 128 rows
        if plan.in_sweep:
            h1 = fv._pad(d[1])
            assert plan.in_slabs * fv.SW_COLS >= h1 > (plan.in_slabs - 1) * fv.SW_COLS
            assert plan.in_splits * plan.in_kps >= dna > (plan.in_splits - 1) * plan.in_kps
            assert plan.in_kps % fv.SW_KC == 0
            assert plan.in_row_blocks * fv.SW_ROWS >= batch
            assert plan.part_floats == plan.in_splits * batch * h1
        if plan.out_sweep:
            assert plan.out_slabs * fv.SW_COLS >= dna > (plan.out_slabs - 1) * fv.SW_COLS
            rb = plan.out_row_blocks
            assert rb * fv.SW_ROWS >= batch > (rb - 1) * fv.SW_ROWS
            assert plan.hid_floats == batch * fv._pad(d[7])
        assert plan.kernels == 1 + plan.in_sweep + plan.out_sweep


@pytest.mark.parametrize("model_type", ["rna2dna", "dna2rna"])
@pytest.mark.parametrize("dna", WIDTHS)
@pytest.mark.parametrize("end", ["bottom", "top"])
def test_plan_fits_a_cta_and_the_cluster_divides_the_grid(model_type, dna, end):
    """The plan of each served batch's bucket, at the bucket's bottom or top
    batch: a CTA's shared memory, the grid a call of that batch launches
    (whole clusters covering its rows, as csrc/fused_vae.cu forward derives
    it), and the scratch the bucket's plan sizes for it."""
    d = dims(model_type, dna)
    for served in SERVED:
        bucket = fv.serving_bucket(served)
        batch = bucket // 2 + 1 if end == "bottom" and bucket > 1 else bucket
        assert fv.serving_bucket(batch) == bucket
        plan = fv.serving_plan(d, bucket, SMS)
        assert plan.trunk_smem == 4 * fv._trunk_floats(d, plan.rows, plan.slot_f)
        assert plan.trunk_smem <= fv.MAX_SMEM and plan.sweep_smem <= fv.MAX_SMEM
        assert plan.slot_f % 4 == 0 and plan.slot_f >= fv.SLOT_MIN
        clusters = -(-batch // plan.rows)
        grid = clusters * fv.CLUSTER
        assert grid % fv.CLUSTER == 0 and clusters * plan.rows >= batch
        # one wave of clusters where the batch allows it
        if batch <= (SMS // fv.CLUSTER) * 4:
            assert clusters <= SMS // fv.CLUSTER
        # the bucket's scratch holds the call's partial sums and hidden rows
        assert plan.part_floats >= plan.in_splits * batch * fv._pad(d[1]) * plan.in_sweep
        assert plan.hid_floats >= batch * fv._pad(fv._layers(d)[1][-2]) * plan.out_sweep


@pytest.mark.parametrize("model_type", ["rna2dna", "dna2rna"])
def test_wide_layers_go_to_the_sweeps(model_type):
    for dna in WIDTHS:
        plan = fv.serving_plan(dims(model_type, dna), 205, SMS)
        if model_type == "dna2rna":
            assert plan.in_sweep == int(dna >= fv.SWEEP_MIN_IN) and not plan.out_sweep
        else:
            assert plan.out_sweep == int(dna >= fv.SWEEP_MIN_OUT) and not plan.in_sweep
    # the whole methylome's output layer and a 65,536-wide input: always swept
    assert fv.serving_plan(dims("rna2dna", 450_000), 103, SMS).out_sweep
    assert fv.serving_plan(dims("dna2rna", 65_536), 205, SMS).in_sweep
    # the cohort's widths stay in the one trunk launch
    assert fv.serving_plan(dims("rna2dna", 1211), 205, SMS).kernels == 1
    assert fv.serving_plan(dims("dna2rna", 1211), 205, SMS).kernels == 1

def test_the_thresholds_move_a_layer_either_way(monkeypatch):
    monkeypatch.setattr(fv, "SWEEP_MIN_IN", 1211)
    assert fv.serving_plan(dims("dna2rna", 1211), 37, SMS).in_sweep
    monkeypatch.setattr(fv, "SWEEP_MIN_IN", 1 << 30)
    assert not fv.serving_plan(dims("dna2rna", 65_536), 37, SMS).in_sweep
    monkeypatch.setattr(fv, "SWEEP_MIN_OUT", 1211)
    assert fv.serving_plan(dims("rna2dna", 1211), 37, SMS).out_sweep


@pytest.mark.parametrize("model_type", ["rna2dna", "dna2rna"])
def test_the_batches_of_a_bucket_share_one_plan(model_type, monkeypatch):
    """A wrapper builds one call plan a power-of-two bucket of batch sizes
    (on the card, its piece tables and their copy to the device), so a
    ragged last batch or a server's varying request sizes reuse it."""
    model_cls, fused_cls = ((RNA2DNAVAE, fv.FusedRNA2DNA) if model_type == "rna2dna"
                            else (DNA2RNAVAE, fv.FusedDNA2RNA))
    torch.manual_seed(0)
    model = model_cls(40, 56, 5, 8, 16).eval()
    fused = fused_cls(*jax_from_state_dict(model.state_dict(), model_type))
    built = []
    fused._sms, fused._calls = SMS, {}
    monkeypatch.setattr(fused, "_build_call", lambda plan: built.append(plan) or plan)
    assert fused.plan(129) is fused.plan(256) is fused.plan(200)
    assert built == [fv.serving_plan(fused._dims(), 256, SMS)]
    for batch in (257, 512, 1, 2, 3, 4):
        fused.plan(batch)
    assert [p.batch for p in built] == [256, 512, 1, 2, 4]
    assert sorted(fused._calls) == [1, 2, 4, 256, 512]


def test_plan_refuses_what_cannot_launch():
    with pytest.raises(ValueError):
        fv.serving_plan(dims("rna2dna", 1211), 0, SMS)
    with pytest.raises(ValueError):
        fv.serving_plan(dims("rna2dna", 1211), 205, 0)
    # a hidden layer too wide for any tile's shared memory
    with pytest.raises(ValueError):
        fv.serving_plan((1177, 128, 0, 20, 24, 32, 256, 60_000, 1211), 205, SMS)


def test_slab_major_puts_each_ranks_columns_together():
    w = torch.arange(12 * 40, dtype=torch.float32).reshape(12, 40)
    flat = fv._slab_major(w)
    pieces = fv.trunk_columns(40)
    off = 0
    for rank in pieces:
        (a, b), = rank
        block = flat[off: off + 12 * (b - a)].reshape(12, b - a)
        assert torch.equal(block, w[:, a:b])
        off += 12 * (b - a)
    assert off == w.numel()


# Random123's known-answer vectors of Philox4x32-10 (kat_vectors): counter, key, output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_reference_matches_the_known_answers(ctr, key, want):
    got = fv.philox4x32_10_reference(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert [int(g) for g in got] == list(want)


def test_philox_normal_reference_is_keyed_by_seed_row_and_index():
    a = fv.philox_normal_reference(2**40 + 9, 64, 20)
    assert a.dtype == torch.float32 and a.shape == (64, 20) and torch.isfinite(a).all()
    # a row's draw does not depend on the batch it is drawn in
    assert torch.equal(fv.philox_normal_reference(2**40 + 9, 10, 20, row0=30), a[30:40])
    assert not torch.equal(fv.philox_normal_reference(2**40 + 10, 64, 20), a)
    # Box-Muller on the top 24 bits of the first two words, in float32
    w = fv.philox4x32_10_reference(torch.tensor([5]), torch.tensor([3]), torch.tensor([0]),
                                   torch.tensor([0]), (2**40 + 9) & 0xFFFFFFFF, (2**40 + 9) >> 32)
    u1 = np.float32((int(w[0]) >> 8) + 1) * np.float32(2**-24)
    u2 = np.float32((int(w[1]) >> 8) + 1) * np.float32(2**-24)
    want = np.sqrt(-2.0 * np.log(np.float64(u1))) * np.cos(2 * np.pi * np.float64(u2))
    assert abs(float(a[5, 3]) - want) < 1e-5
    many = fv.philox_normal_reference(7, 4096, 32)
    assert abs(many.mean().item()) < 0.01 and abs(many.var().item() - 1) < 0.02
