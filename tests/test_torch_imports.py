"""The port, ``chip_smoke.py`` and the card's tests run on a machine without
jax, sklearn, pandas, matplotlib or optuna; they import nothing of the JAX package
either (not even its jax-free modules). ``chip_smoke.py`` fails loudly
without a card or without the repository beside it."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "vae_los_angeles_torch"
CARD_TESTS = REPO / "tests" / "test_torch_kernels_cuda.py"
BLOCKED = ("jax", "jaxlib", "sklearn", "pandas", "matplotlib", "plotly", "optuna",
           "vae_los_angeles_tpu")
SLICE_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def run(args, cwd, env_extra=None, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


CLUSTERING_MODULES = ("ops.cluster_metrics", "evaluation.tables", "evaluation.plotting",
                      "evaluation.reconstruct_unmatched", "evaluation.create_boxplots",
                      "evaluation.clustering", "evaluation.clustering.metrics_utils",
                      "evaluation.clustering.common", "evaluation.clustering.cluster_reconstructed",
                      "evaluation.clustering.cluster_imputation_methods")


def test_slice_modules_listed():
    assert "vae_los_angeles_torch.ops.kernels.fused_vae" in SLICE_MODULES
    assert "vae_los_angeles_torch.evaluation.compare_directional_imputation" in SLICE_MODULES
    assert "vae_los_angeles_torch.evaluation.evaluate" in SLICE_MODULES
    assert "vae_los_angeles_torch.train" in SLICE_MODULES
    assert "vae_los_angeles_torch.ops.kernels.fused_wide" in SLICE_MODULES
    for name in ("ops.knn", "ops.pca", "ops.tsne", "models.conditioned_knn",
                 "evaluation.knn_comparison", "parallel", "parallel.vmap_meta",
                 "evaluation.cross_modality_cv", "evaluation.hpo", "optimize_hyperparameters",
                 "evaluation.mlp_classifier", "evaluation.downstream",
                 "evaluation.downstream_directional", *CLUSTERING_MODULES):
        assert f"vae_los_angeles_torch.{name}" in SLICE_MODULES
    assert len(SLICE_MODULES) >= 41


def test_port_and_chip_smoke_import_without_jax_sklearn_pandas_matplotlib():
    code = "\n".join([
        "import importlib, sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None  # any import of it raises ImportError",
        f"for mod in {SLICE_MODULES + ['chip_smoke', 'chip_probes']!r}:",
        "    importlib.import_module(mod)",
        "import importlib.util  # the card's tests run there too",
        f"spec = importlib.util.spec_from_file_location('card_tests', {str(CARD_TESTS)!r})",
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        f"loaded = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
        " and sys.modules[m] is not None]",
        "assert not loaded, loaded",
        "print('imported', len(sys.modules))",
    ])
    proc = run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py", "chip_probes.py"])
def test_no_jax_import_in_port_source(path):
    text = (REPO / path).read_text()
    for line in text.splitlines():
        stripped = line.strip()
        assert not stripped.startswith(("import jax", "from jax", "import vae_los_angeles_tpu",
                                        "from vae_los_angeles_tpu")), f"{path}: {line}"


DOWNSTREAM_SOURCES = ("data/splits.py", "ops/metrics.py", "evaluation/mlp_classifier.py",
                      "evaluation/downstream.py", "evaluation/downstream_directional.py")


@pytest.mark.parametrize("path", DOWNSTREAM_SOURCES)
def test_downstream_sources_import_no_sklearn_pandas_or_matplotlib(path):
    """The downstream flow's numpy stand-ins for sklearn import none of the
    blocked packages; the one exception is matplotlib imported inside a
    plotting function (indented), which prints a line when it is missing."""
    for line in (PORT / path).read_text().splitlines():
        stripped = line.strip()
        words = stripped.split()
        if len(words) < 2 or words[0] not in ("import", "from"):
            continue
        root = words[1].split(".")[0]
        if root not in BLOCKED:
            continue
        assert root == "matplotlib" and line.startswith("    "), f"{path}: {line}"


def test_chip_smoke_fails_without_cuda():
    proc = run(["chip_smoke.py"], REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "vae_los_angeles_torch" in proc.stderr


CLUSTERING_SOURCES = ("data/synthetic.py", "data/splits.py", "ops/pca.py", "ops/tsne.py",
                      "evaluation/evaluate.py", "evaluation/compare_directional_imputation.py",
                      "training/cli.py") + tuple(
    name.replace(".", "/") + ("/__init__.py" if name == "evaluation.clustering" else ".py")
    for name in CLUSTERING_MODULES)
LAZY = ("pandas", "matplotlib", "plotly")  # read a pickle, draw a plot


@pytest.mark.parametrize("path", CLUSTERING_SOURCES)
def test_clustering_sources_import_blocked_packages_only_lazily(path):
    """The reconstruction, clustering and plotting modules import none of
    the blocked packages at module level; pandas (where a pickle is read)
    and matplotlib or plotly (where a plot is drawn) only inside a function
    (indented), which prints a line when a plotting package is missing."""
    for line in (PORT / path).read_text().splitlines():
        words = line.strip().split()
        if len(words) < 2 or words[0] not in ("import", "from"):
            continue
        root = words[1].split(".")[0]
        if root in BLOCKED:
            assert root in LAZY and line.startswith("    "), f"{path}: {line}"
