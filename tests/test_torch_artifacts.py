"""The port's pandas-free artifacts (``vae_los_angeles_torch/data/artifacts.py``,
``data/synthetic.py``'s writers, ``data/splits.LabelCodes``) against the JAX
package's pickled DataFrames and sklearn encoder: the five files equal
column for column, the ``--synthetic`` bootstrap overwrites nothing, and
every reader of the port reads both forms (the JAX package's where pandas
is installed, the port's without pandas or sklearn)."""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.preprocessing import LabelEncoder

from vae_los_angeles_torch.config import Config
from vae_los_angeles_torch.data import artifacts
from vae_los_angeles_torch.data import synthetic as port_synthetic
from vae_los_angeles_torch.data.dataset import MultiModalDataset
from vae_los_angeles_torch.data.splits import LabelCodes
from vae_los_angeles_torch.evaluation import (create_boxplots, cross_modality_cv, evaluate,
                                              reconstruct_unmatched, tables)
from vae_los_angeles_torch.evaluation.clustering import (cluster_imputation_methods,
                                                         cluster_reconstructed)
from vae_los_angeles_torch.training import cli
from vae_los_angeles_tpu.data import synthetic as jax_synthetic

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SIZES = dict(n_samples=96, dim_a=16, dim_b=24, n_sites=24, n_unmatched=8)
TABLES = ("processed_data.pkl", "rna_only_unmatched.pkl", "dna_only_unmatched.pkl")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX package's artifact dir, the port's), written from one seed."""
    root = tmp_path_factory.mktemp("artifacts")
    jax_synthetic.write_synthetic_artifacts(str(root / "jax"), seed=3, **SIZES)
    port_synthetic.write_synthetic_artifacts(str(root / "port"), seed=3, **SIZES)
    return root / "jax", root / "port"


def same_table(got, want):
    names = list(want.columns) if tables.is_frame(want) else list(want)
    assert (list(got.columns) if tables.is_frame(got) else list(got)) == names
    for name in names:
        g, w = tables.column(got, name), tables.column(want, name)
        assert g.shape == w.shape, name
        if w.dtype.kind == "f":
            assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", TABLES)
def test_synthetic_tables_equal_jax(both, name):
    jax_dir, port_dir = both
    got = artifacts.read_table(str(port_dir / name))
    assert isinstance(got, dict)
    assert all(isinstance(v, np.ndarray) and v.dtype != object for v in got.values())
    same_table(got, pd.read_pickle(jax_dir / name))


def test_synthetic_encoder_and_feature_names_equal_jax(both):
    jax_dir, port_dir = both
    got = artifacts.read_pickle(str(port_dir / "label_encoder.pkl"))
    want = artifacts.read_pickle(str(jax_dir / "label_encoder.pkl"))
    assert isinstance(got, LabelCodes) and isinstance(want, LabelEncoder)
    np.testing.assert_array_equal(got.classes_, want.classes_)
    names = pd.read_pickle(jax_dir / "rna_only_unmatched.pkl")["primary_site"]
    np.testing.assert_array_equal(got.transform(names), want.transform(names))
    with open(port_dir / "feature_names.pkl", "rb") as f, open(jax_dir / "feature_names.pkl",
                                                               "rb") as g:
        assert pickle.load(f) == pickle.load(g)
    matched, le = port_synthetic.write_synthetic_artifacts(
        str(port_dir.parent / "again"), seed=3, **SIZES)
    same_table(matched, artifacts.read_table(str(port_dir / "processed_data.pkl")))
    np.testing.assert_array_equal(le.classes_, got.classes_)


def test_label_codes_match_sklearn():
    y = np.array(["Lung", "Breast", "Kidney", "Breast", "Lung", "Brain"], dtype=object)
    got, want = LabelCodes(), LabelEncoder()
    np.testing.assert_array_equal(got.fit_transform(y), want.fit_transform(y))
    np.testing.assert_array_equal(got.classes_, want.classes_)
    assert got.fit(y[:4]) is got and want.fit(y[:4]) is want
    for codes_of in (["Kidney", "Breast"], y[:3], []):
        np.testing.assert_array_equal(got.transform(codes_of), want.transform(codes_of))
    np.testing.assert_array_equal(got.inverse_transform([2, 0, 1]),
                                  want.inverse_transform([2, 0, 1]))
    for unseen in (["Atlantis"], ["Lung", "Brain"]):  # Brain is not in y[:4]
        with pytest.raises(ValueError, match="unseen"):
            want.transform(unseen)
        with pytest.raises(ValueError, match="unseen"):
            got.transform(unseen)
    with pytest.raises(ValueError):
        got.inverse_transform([3])
    with pytest.raises(ValueError, match="not fitted"):
        LabelCodes().transform(["Lung"])
    ints = np.array([7, 3, 7, 1])
    np.testing.assert_array_equal(LabelCodes().fit_transform(ints),
                                  LabelEncoder().fit_transform(ints))


def test_ensure_synthetic_artifacts_does_not_overwrite(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    (data / "label_encoder.pkl").write_bytes(b"a real encoder")
    custom = data / "custom.pkl"
    assert port_synthetic.ensure_synthetic_artifacts(str(data), target_pkl=str(custom),
                                                     dim_a=16, dim_b=24)
    assert (data / "label_encoder.pkl").read_bytes() == b"a real encoder"
    # the requested pickle takes the staged processed_data.pkl's place
    assert sorted(os.listdir(data)) == sorted(
        ["custom.pkl", "label_encoder.pkl", "rna_only_unmatched.pkl", "dna_only_unmatched.pkl",
         "feature_names.pkl"])
    table = artifacts.read_table(str(custom))
    assert table["tpm_unstranded"].shape == (1024, 16)
    assert not port_synthetic.ensure_synthetic_artifacts(str(data), target_pkl=str(custom))
    before = {name: (data / name).read_bytes() for name in os.listdir(data)}
    assert port_synthetic.ensure_synthetic_artifacts(str(data), dim_a=16, dim_b=24)
    after = {name: (data / name).read_bytes() for name in os.listdir(data)}
    assert after.pop("processed_data.pkl") and after == before  # nothing else rewritten
    assert not port_synthetic.ensure_synthetic_artifacts(str(data))


def _recon(directory, frame):
    """A reconstruction pickle beside the cohorts (the JAX form as a frame)."""
    rna = artifacts.read_table(str(directory / "rna_only_unmatched.pkl"))
    rec = tables.with_columns(rna, reconstructed_beta_value=np.full(
        (tables.n_rows(rna), SIZES["dim_b"]), 0.5, np.float32))
    artifacts.write_pickle(str(directory / "rna_with_reconstructed_dna_20240101_000000.pkl"),
                           pd.DataFrame(rec) if frame else rec)


def test_every_reader_reads_both_forms(both):
    readers = {}
    for directory in both:
        cfg = Config(data_dir=str(directory))
        processed = str(directory / "processed_data.pkl")
        dataset, n_sites = cli.load_data(cfg)
        val_split = evaluate.load_val_split(cfg)
        _recon(directory, frame=directory == both[0])
        le, rec = cluster_reconstructed._cohort_tables(cfg, None)
        readers[directory] = {
            "dataset": (dataset.tpm_data, dataset.beta_data, dataset.primary_site, n_sites),
            "from_pickle": vars(MultiModalDataset.from_pickle(processed)),
            "val_split": (val_split[0].tpm_data, val_split[1].classes_, *val_split[2:]),
            "cv": cross_modality_cv.load_data(processed, subset=0.5),
            "boxplots": create_boxplots._inputs(cfg, None),
            "reconstruct": reconstruct_unmatched._cohorts(cfg, None),
            "cluster_reconstructed": (le, *rec),
            "cluster_imputation": cluster_imputation_methods._tables(cfg, None),
        }
    jax, port = readers[both[0]], readers[both[1]]
    assert jax.keys() == port.keys()
    for key in jax:
        for want, got in zip(jax[key] if not isinstance(jax[key], dict) else jax[key].values(),
                             port[key] if not isinstance(port[key], dict) else
                             port[key].values()):
            if got is None or isinstance(got, (int, list)):
                assert got == want, key
            elif hasattr(got, "classes_"):
                np.testing.assert_array_equal(got.classes_, want.classes_)
            elif isinstance(got, dict) or tables.is_frame(want):
                assert isinstance(got, dict) and tables.is_frame(want), key
                same_table(got, want)
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)


def test_port_artifacts_read_without_pandas_or_sklearn(both):
    """In a process where pandas and sklearn cannot be imported (the card's
    machine), the port's artifacts load and the JAX package's frame raises
    an ImportError that names the port's form."""
    jax_dir, port_dir = both
    code = "\n".join([
        "import sys",
        "for name in ('pandas', 'sklearn', 'jax', 'vae_los_angeles_tpu'):",
        "    sys.modules[name] = None",
        "from vae_los_angeles_torch.data import artifacts",
        "from vae_los_angeles_torch.data.dataset import MultiModalDataset",
        f"port = {str(port_dir)!r}",
        "ds = MultiModalDataset.from_pickle(port + '/processed_data.pkl')",
        "le = artifacts.read_pickle(port + '/label_encoder.pkl')",
        "rna = artifacts.read_table(port + '/rna_only_unmatched.pkl')",
        "print(len(ds), len(le.classes_), le.transform(rna['primary_site'][:3]).tolist())",
        "try:",
        f"    artifacts.read_table({str(jax_dir / 'processed_data.pkl')!r})",
        "except ImportError as e:",
        "    print('refused:', e)",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    want_codes = LabelCodes().fit(port_synthetic.site_names(24)).transform(
        artifacts.read_table(str(port_dir / "rna_only_unmatched.pkl"))["primary_site"][:3])
    assert proc.stdout.splitlines()[0] == f"96 24 {want_codes.tolist()}"
    assert "refused:" in proc.stdout and "pandas-free" in proc.stdout
