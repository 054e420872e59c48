"""The data preparation's artifacts in a pandas-free form, and one reader for
them and for the JAX package's.

The JAX package's writers (its ``data/synthetic.py`` and
``data/prepare_data.py``) pickle pandas DataFrames and an sklearn
``LabelEncoder``; neither unpickles on a machine without pandas and
sklearn, as the card's is. The port writes the same five files in one
form that numpy alone reads:

  * ``processed_data.pkl``, ``rna_only_unmatched.pkl`` and
    ``dna_only_unmatched.pkl``: a dict of numpy arrays under the
    reference's column names (a list-valued feature column stacked into an
    (n, width) array), the second kind of table ``evaluation.tables`` reads;
  * ``label_encoder.pkl``: a ``data.splits.LabelCodes``;
  * ``feature_names.pkl``: ``{"gene_names": [...], "probe_ids": [...]}``,
    as the JAX writers' dict.

`read_table` and `read_pickle` read either package's files: the port's
anywhere, the JAX package's DataFrames where pandas is installed (unpickling
a frame imports pandas, and only then). Unpickling runs code, so read only
files this project's data preparation wrote.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from vae_los_angeles_torch.evaluation import tables
from vae_los_angeles_torch.parallel import comm

ARTIFACTS = ("processed_data.pkl", "label_encoder.pkl", "rna_only_unmatched.pkl",
             "dna_only_unmatched.pkl", "feature_names.pkl")


def read_pickle(path):
    """The object pickled at ``path``; a pandas object without pandas raises
    an ImportError that names the port's pandas-free form."""
    with open(path, "rb") as f:
        try:
            return pickle.load(f)
        except ModuleNotFoundError as e:
            if e.name not in ("pandas", "sklearn"):
                raise
            raise ImportError(
                f"{path} was written by the JAX package's data preparation (a {e.name} "
                f"object) and {e.name} is not installed here; write the port's pandas-free "
                "artifacts instead (vae_los_angeles_torch.data.prepare_data, or "
                "--synthetic)") from e


def read_table(path):
    """A cohort table: the port's dict of numpy arrays, or the JAX package's
    DataFrame as it is (list-valued columns; ``evaluation.tables`` reads
    both)."""
    table = read_pickle(path)
    if isinstance(table, dict):
        return {name: np.asarray(values) for name, values in table.items()}
    if tables.is_frame(table):
        return table
    raise TypeError(f"{path} holds a {type(table).__name__}, not a cohort table")


def table_from_frame(frame) -> dict:
    """A DataFrame as the port's table: each column a numpy array, a
    list-valued column stacked into (n, width), a missing entry of a string
    column None (pandas' NA would need pandas to unpickle)."""
    out = {}
    for name in frame.columns:
        values = np.asarray(tables.column(frame, name))
        if values.dtype == object and values.ndim == 1:
            missing = frame[name].isna().to_numpy()
            if missing.any():
                values = values.copy()
                values[missing] = None
        out[name] = values
    return out


@comm.writes_files
def write_pickle(path, obj):
    """Pickle ``obj`` (a table as it is: the port's dict, or a DataFrame read
    from the JAX package's files) at ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def write_artifacts(data_dir, processed, label_encoder, feature_names, rna_only=None,
                    dna_only=None):
    """Write the artifact set into ``data_dir`` (a DataFrame table converted
    to the port's form first); an unmatched cohort that is None is not
    written. Returns the paths written."""
    written = []
    for name, obj in (("processed_data.pkl", processed), ("label_encoder.pkl", label_encoder),
                      ("rna_only_unmatched.pkl", rna_only),
                      ("dna_only_unmatched.pkl", dna_only),
                      ("feature_names.pkl", feature_names)):
        if obj is None:
            continue
        if tables.is_frame(obj):
            obj = table_from_frame(obj)
        path = os.path.join(data_dir, name)
        write_pickle(path, obj)
        written.append(path)
    return written
