"""Console-script shims for the port's ``vla-torch-*`` entry points
(counterpart of ``vae_los_angeles_tpu/console.py``).

Setuptools' command wrappers run ``sys.exit(entry_point())``, and the mains
return their results, which ``sys.exit`` would turn into exit status 1. Each
shim calls its main and returns None (status 0); an exception still exits
non-zero with its traceback. The imports wait until the shim runs, so one
command's ``--help`` does not import every other.
"""

from __future__ import annotations

from importlib import import_module


def _run(module: str, attr: str = "main") -> None:
    getattr(import_module(f"vae_los_angeles_torch.{module}"), attr)()


def train_rna2dna() -> None:
    _run("training.cli", "main_rna2dna")


def train_dna2rna() -> None:
    _run("training.cli", "main_dna2rna")


def train_multimodal() -> None:
    _run("training.cli", "main_multimodal")


def evaluate() -> None:
    _run("evaluation.evaluate")


def import_checkpoint() -> None:
    _run("utils.torch_import", "import_main")


def export_checkpoint() -> None:
    _run("utils.torch_import", "export_main")


def prepare_data() -> None:
    _run("data.prepare_data")


def prepare_dna() -> None:
    _run("data.prepare_dna")


def hpo() -> None:
    _run("evaluation.hpo")


def cross_modality_cv() -> None:
    _run("evaluation.cross_modality_cv")


def compare_imputation() -> None:
    _run("evaluation.compare_directional_imputation")


def knn_comparison() -> None:
    _run("evaluation.knn_comparison")


def downstream() -> None:
    _run("evaluation.downstream")


def downstream_directional() -> None:
    _run("evaluation.downstream_directional")


def reconstruct_unmatched() -> None:
    _run("evaluation.reconstruct_unmatched")


def cluster_reconstructed() -> None:
    _run("evaluation.clustering.cluster_reconstructed")


def cluster_imputation() -> None:
    _run("evaluation.clustering.cluster_imputation_methods")


def boxplots() -> None:
    _run("evaluation.create_boxplots")
