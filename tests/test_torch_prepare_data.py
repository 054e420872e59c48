"""The port's data preparation (``vae_los_angeles_torch/data/prepare_data.py``,
``prepare_dna.py``, ``ingest_manifest.py`` and the native pivot of
``utils/native.py``) against the JAX package's, on seeded synthetic frames
and a parquet pair in a temporary directory. Every stage gives the JAX
stage's values exactly; the port writes its tables as dicts of arrays, so
those are compared as arrays with the JAX frames' columns."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from vae_los_angeles_torch.data import artifacts
from vae_los_angeles_torch.data import ingest_manifest as port_im
from vae_los_angeles_torch.data import prepare_data as port_prep
from vae_los_angeles_torch.data import prepare_dna as port_dna
from vae_los_angeles_torch.utils import native as port_native
from vae_los_angeles_tpu.data import ingest_manifest as jax_im
from vae_los_angeles_tpu.data import prepare_data as jax_prep
from vae_los_angeles_tpu.data import prepare_dna as jax_dna

torch.set_num_threads(1)

DIM_A, DIM_B = 6, 5


def rna_long(seed=0, n_cases=14):
    """Long RNA rows: cases with all DIM_A genes, some with one missing
    (filtered out), duplicated rows, shuffled, a few null sites."""
    rng = np.random.default_rng(seed)
    rows = []
    for c in range(n_cases):
        site = ["Breast", "Lung", "Kidney"][c % 3]
        genes = [f"G{g}" for g in range(DIM_A) if not (c % 5 == 4 and g == 2)]
        for g in genes:
            rows.append((f"TCGA-{c:02d}", g, float(rng.random() * 100),
                         None if (c, g) == (1, "G0") else site))
    df = pd.DataFrame(rows, columns=["case_barcode", "gene_name", "tpm_unstranded",
                                     "primary_site"])
    df = pd.concat([df, df.iloc[[0, 7]]], ignore_index=True)  # duplicates
    return df.sample(frac=1.0, random_state=seed).reset_index(drop=True)


def dna_long(seed=1, n_cases=14, probe_col="probe_id"):
    """Long DNA rows over cases 3.. (so RNA-only and DNA-only cases exist)."""
    rng = np.random.default_rng(seed)
    rows = [(f"TCGA-{c:02d}", f"cg{p:04d}", float(rng.random()))
            for c in range(3, n_cases + 3) for p in range(DIM_B if c % 4 else DIM_B - 1)]
    df = pd.DataFrame(rows, columns=["case_barcode", probe_col, "beta_value"])
    return df.sample(frac=1.0, random_state=seed).reset_index(drop=True)


def as_arrays(frame):
    return {name: np.array(frame[name].tolist()) if len(frame) and np.ndim(frame[name].iloc[0])
            else frame[name].to_numpy() for name in frame.columns}


def assert_table_equal(got, want_frame):
    """A port table (dict of arrays) equals a JAX frame column for column."""
    assert list(got) == list(want_frame.columns)
    for name, want in as_arrays(want_frame).items():
        assert got[name].shape == want.shape, name
        if want.dtype.kind == "f":
            assert got[name].dtype == want.dtype, name
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        else:
            assert [None if pd.isna(v) else v for v in got[name].tolist()] == \
                   [None if pd.isna(v) else v for v in want.tolist()], name


@pytest.mark.parametrize("engine", ["auto", "pandas"])
def test_prepare_rna_and_dna_match_jax(engine):
    rna = rna_long()
    got, got_genes = port_prep.prepare_rna_data(rna, DIM_A, engine=engine)
    want, want_genes = jax_prep.prepare_rna_data(rna, DIM_A, engine=engine)
    pd.testing.assert_frame_equal(got, want)
    assert got_genes == want_genes and len(got) == 12  # cases 4 and 9 lack a gene
    for probe_col in ("probe_id", "probe_id_id"):
        dna = dna_long(probe_col=probe_col)
        got, got_probes = port_prep.prepare_dna_methylation_data(dna, DIM_B, engine=engine)
        want, want_probes = jax_prep.prepare_dna_methylation_data(dna, DIM_B, engine=engine)
        pd.testing.assert_frame_equal(got, want)
        assert got_probes == want_probes


def test_merge_and_normalize_match_jax(tmp_path):
    rna, _ = jax_prep.prepare_rna_data(rna_long(), DIM_A)
    dna, _ = jax_prep.prepare_dna_methylation_data(dna_long(), DIM_B)
    got, got_le = port_prep.merge_and_normalize_data(rna, dna, top_n_sites=2,
                                                     data_dir=str(tmp_path / "port"))
    want, want_le = jax_prep.merge_and_normalize_data(rna, dna, top_n_sites=2,
                                                      data_dir=str(tmp_path / "jax"))
    assert_table_equal(got, want)
    assert got["tpm_unstranded"].dtype == np.float64 and len(got["case_barcode"]) > 3
    np.testing.assert_array_equal(got_le.classes_, want_le.classes_)
    for name in ("rna_only_unmatched.pkl", "dna_only_unmatched.pkl"):
        table = artifacts.read_table(str(tmp_path / "port" / name))
        assert isinstance(table, dict)
        assert_table_equal(table, pd.read_pickle(tmp_path / "jax" / name))


def pivot_rows(seed):
    """Pure-schema rows: duplicates (a first NaN shadowing a later value),
    unobserved cells, NaN betas, a patient with no finite value."""
    rng = np.random.default_rng(seed)
    n_pat, n_probe = int(rng.integers(3, 12)), int(rng.integers(3, 20))
    n_rows = int(rng.integers(n_pat * n_probe // 2, n_pat * n_probe + 20))
    df = pd.DataFrame({
        "case_barcode": rng.choice([f"P{i}" for i in range(n_pat)], size=n_rows),
        "probe_id": rng.choice([f"pr{i}" for i in range(n_probe)], size=n_rows),
        "beta_value": rng.random(n_rows),
    })
    df.loc[rng.random(n_rows) < 0.25, "beta_value"] = np.nan
    df.loc[df.case_barcode == "P0", "beta_value"] = np.nan
    return df


@pytest.mark.parametrize("seed", range(4))
def test_build_imputed_matrix_matches_jax_both_engines(seed, capsys):
    df = pivot_rows(seed)
    for engine in ("native", "pandas"):
        got = port_dna.build_imputed_matrix(df, engine=engine)
        want = jax_dna.build_imputed_matrix(df, engine=engine)
        pd.testing.assert_frame_equal(got, want)  # exact
    capsys.readouterr()
    auto = port_dna.build_imputed_matrix(df)
    assert "native engine" in capsys.readouterr().out
    pd.testing.assert_frame_equal(auto, port_dna.build_imputed_matrix(df, engine="native"))


def test_build_imputed_matrix_declined_inputs_take_pandas(capsys):
    extra = pd.DataFrame({"case_barcode": ["P1", "P2", "P1"], "probe_id": ["a", "a", "b"],
                          "beta_value": [0.2, 0.4, 0.1], "platform": ["450k"] * 3})
    null_keys = pd.DataFrame({"case_barcode": ["P1", None, "P2"], "probe_id": ["a", "a", None],
                              "beta_value": [0.2, 0.4, 0.6]})
    for df in (extra, null_keys):
        got = port_dna.build_imputed_matrix(df)
        assert "pandas engine" in capsys.readouterr().out
        pd.testing.assert_frame_equal(got, jax_dna.build_imputed_matrix(df, engine="pandas"))
        with pytest.raises(ValueError, match="engine='pandas'"):
            port_dna.build_imputed_matrix(df, engine="native")
    with pytest.raises(ValueError, match="unknown engine"):
        port_dna.build_imputed_matrix(null_keys, engine="fast")


def test_native_pivot_matches_a_numpy_version():
    """The C++ pivot against the transform written in numpy: first
    occurrence wins, the patient's mean summed in probe order."""
    rng = np.random.default_rng(3)
    n_pat, n_probe, n = 7, 40, 400
    pat, probe = rng.integers(0, n_pat, n), rng.integers(0, n_probe, n)
    beta = np.where(rng.random(n) < 0.2, np.nan, rng.random(n))
    want = np.full((n_pat, n_probe), np.nan)
    cells, first = np.unique(pat * n_probe + probe, return_index=True)
    want.ravel()[cells] = beta[first]
    for row in want:
        seen = ~np.isnan(row)
        if seen.any():
            row[~seen] = np.cumsum(np.where(seen, row, 0.0))[-1] / seen.sum()
    got = port_native.pivot_impute(pat, probe, beta, n_pat, n_probe)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        port_native.pivot_impute([n_pat], [0], [0.5], n_pat, n_probe)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    broken = tmp_path / "pivot_impute.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(port_native, "SOURCE", broken)
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_native, "_LOADED", {})
    with pytest.raises(RuntimeError, match="engine='pandas'"):
        port_dna.build_imputed_matrix(pivot_rows(0))
    assert not list((tmp_path / "build").glob("*.so"))


def manifest_frames():
    rna, dna = rna_long(), dna_long()
    bad_rna = rna.drop(columns=["gene_name"])
    bad_dna = dna.assign(beta_value=dna["beta_value"] * 3, case_barcode=None)
    wrong_kind = rna.assign(tpm_unstranded=rna["tpm_unstranded"].astype(str))
    return {"good": ({"rna_expression": rna, "dna_methylation": dna,
                      "dna_prep_shards": dna}),
            "bad": ({"rna_expression": bad_rna, "dna_methylation": bad_dna,
                     "dna_prep_shards": wrong_kind.iloc[:0], "unknown_table": rna})}


@pytest.mark.parametrize("case", ["good", "bad"])
def test_ingest_manifest_matches_jax(case, capsys):
    frames = manifest_frames()[case]
    for table, df in frames.items():
        assert port_im.verify_table(df, table) == jax_im.verify_table(df, table)
    assert port_im.verify_frames(frames) == jax_im.verify_frames(frames)
    capsys.readouterr()
    got = port_im.report(frames)
    got_out = capsys.readouterr().out
    want = jax_im.report(frames)
    assert (got, got_out) == (want, capsys.readouterr().out)
    assert got == (case == "good")
    assert port_im.record_manifest(frames) == jax_im.record_manifest(frames)
    assert port_im.EXPECTED == jax_im.EXPECTED


def test_prepare_data_main_on_a_parquet_pair_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("INPUT_DIM_A", str(DIM_A))
    monkeypatch.setenv("INPUT_DIM_B", str(DIM_B))
    rna_file, dna_file = tmp_path / "expression.parquet", tmp_path / "methylation.parquet"
    rna_long().to_parquet(rna_file)
    dna_long().to_parquet(dna_file)
    argv = ["--rna-parquet", str(rna_file), "--dna-parquet", str(dna_file)]
    for module in (port_prep, jax_prep):
        with pytest.raises(SystemExit) as verdict:
            module.main(argv + ["--verify-ingest"])
        assert verdict.value.code == 0
    port_prep.main(argv + ["--data_dir", str(tmp_path / "port")])
    jax_prep.main(argv + ["--data_dir", str(tmp_path / "jax")])
    for name in ("processed_data.pkl", "rna_only_unmatched.pkl", "dna_only_unmatched.pkl"):
        assert_table_equal(artifacts.read_table(str(tmp_path / "port" / name)),
                           pd.read_pickle(tmp_path / "jax" / name))
    for name in ("label_encoder.pkl", "feature_names.pkl"):
        got = artifacts.read_pickle(str(tmp_path / "port" / name))
        want = artifacts.read_pickle(str(tmp_path / "jax" / name))
        if name == "feature_names.pkl":
            assert got == want
        else:
            np.testing.assert_array_equal(got.classes_, want.classes_)
    with pytest.raises(SystemExit, match="together"):
        port_prep.main(["--rna-parquet", str(rna_file)])


def test_prepare_data_synthetic_and_prepare_dna_main_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("INPUT_DIM_A", str(DIM_A))
    monkeypatch.setenv("INPUT_DIM_B", str(DIM_B))
    for module, out in ((port_prep, "port"), (jax_prep, "jax")):
        module.main(["--synthetic", "--n_samples", "40", "--data_dir", str(tmp_path / out)])
    assert_table_equal(artifacts.read_table(str(tmp_path / "port" / "processed_data.pkl")),
                       pd.read_pickle(tmp_path / "jax" / "processed_data.pkl"))

    shards = tmp_path / "shards" / "part"
    shards.mkdir(parents=True)
    df = pivot_rows(7)
    df.iloc[: len(df) // 2].to_parquet(shards / "a.parquet")
    df.iloc[len(df) // 2:].to_parquet(shards / "b.parquet")
    df.to_parquet(shards / "filtered_data.parquet")  # skipped, as the reference skips it
    for module, out in ((port_dna, "port.parquet"), (jax_dna, "jax.parquet")):
        module.main(["--input-dir", str(tmp_path / "shards"), "--output", str(tmp_path / out)])
    pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / "port.parquet"),
                                  pd.read_parquet(tmp_path / "jax.parquet"))
    assert os.path.getsize(tmp_path / "port.parquet") > 0
