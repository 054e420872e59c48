"""The DNA-methylation pre-preparation (counterpart of
``vae_los_angeles_tpu/data/prepare_dna.py``, the reference's
``scripts/prepare_dna.py``):

    python -m vae_los_angeles_torch.data.prepare_dna [--input-dir DIR]
        [--output data/dna_methylation_imputed.parquet] [--verify-ingest [MANIFEST.json]]

Concatenates the parquet shards of a third Kaggle dataset, dedups on
(case_barcode, probe_id), builds the complete patient × probe matrix,
mean-imputes each patient's missing β-values and writes the parquet the
main preparation reads. It runs on the machine that prepares the data:
pandas, pyarrow (through ``read_parquet``) and kagglehub are imported only
inside the functions that need them. `build_imputed_matrix` is a pure
function of a frame: the pandas engine is the reference's formulation, the
native one the port's C++ pivot (``utils.native``), which raises when it
cannot be built instead of falling back.
"""

from __future__ import annotations

import argparse
import os
import sys

from vae_los_angeles_torch.data import ingest_manifest

DNA_PREP_DATASET = "martininf1n1ty/dna-metylation-onkodb"


def load_parquet_shards(dataset_path: str):
    import pandas as pd

    frames = []
    for root, _dirs, files in os.walk(dataset_path):
        for file in files:
            if file == "filtered_data.parquet" or not file.endswith(".parquet"):
                continue
            try:
                frames.append(pd.read_parquet(os.path.join(root, file)))
                print(f"Loaded {file} successfully.")
            except Exception as e:
                print(f"Error loading {file}: {e}")
    if not frames:
        # a typo'd --input-dir walks nothing (os.walk on a missing path is
        # silent) and pd.concat([]) raises an opaque ValueError
        raise SystemExit(f"no parquet shards found under {dataset_path!r}")
    return pd.concat(frames, ignore_index=True)


def _native_declines(combined_df):
    """Why the native pivot would not reproduce the pandas engine on these
    rows (the inputs the JAX package's native path also declines), or None."""
    if list(combined_df.columns) != ["case_barcode", "probe_id", "beta_value"]:
        # extra columns ride through the pandas merge; the dense matrix drops them
        return f"columns {list(combined_df.columns)} beyond (case_barcode, probe_id, beta_value)"
    if combined_df["case_barcode"].isna().any() or combined_df["probe_id"].isna().any():
        return "null keys, which pandas groups and the native codes cannot"
    return None


def build_imputed_matrix(combined_df, engine: str = "auto"):
    """Dedup → complete patient × probe grid → per-patient mean imputation
    (the reference's :33-65), rows in first-occurrence order of patients,
    then of probes.

    ``engine``: "pandas" is the reference's formulation; "native" the C++
    pivot (``utils.native.pivot_impute``), which raises for the inputs it
    cannot reproduce and when it cannot be built; "auto" takes the pandas
    engine only for those inputs (extra columns or null keys) and the
    native one otherwise, and prints which it took."""
    if engine not in ("auto", "native", "pandas"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine != "pandas":
        declined = _native_declines(combined_df)
        if declined is None:
            if engine == "auto":
                print("build_imputed_matrix: native engine")
            return _build_imputed_matrix_native(combined_df)
        if engine == "native":
            raise ValueError(f"the native pivot cannot take these rows ({declined}); "
                             "use engine='pandas'")
        print(f"build_imputed_matrix: pandas engine ({declined})")
    from itertools import product

    import pandas as pd

    combined_df = combined_df.drop_duplicates(
        subset=["case_barcode", "probe_id"], keep="first"
    )
    unique_patients = combined_df["case_barcode"].unique()
    unique_probes = combined_df["probe_id"].unique()
    complete_index = pd.DataFrame(
        list(product(unique_patients, unique_probes)),
        columns=["case_barcode", "probe_id"],
    )
    combined_df = complete_index.merge(
        combined_df, on=["case_barcode", "probe_id"], how="left"
    )
    combined_df["beta_value"] = combined_df.groupby("case_barcode")[
        "beta_value"
    ].transform(lambda x: x.fillna(x.mean()))
    return combined_df


def _build_imputed_matrix_native(combined_df):
    """The native engine of `build_imputed_matrix`: the pandas engine's
    rows, columns and dtypes (the input's key dtypes kept, so the written
    parquet's schema does not depend on the engine)."""
    import numpy as np
    import pandas as pd

    from vae_los_angeles_torch.utils import native

    pat_codes, patients = pd.factorize(combined_df["case_barcode"])
    probe_codes, probes = pd.factorize(combined_df["probe_id"])
    beta_dtype = combined_df["beta_value"].to_numpy().dtype
    P, K = len(patients), len(probes)
    out = native.pivot_impute(pat_codes, probe_codes, combined_df["beta_value"].to_numpy(),
                              P, K)
    # pre-typed Series skip pandas' per-element inference, which costs tens
    # of seconds on a whole-methylome grid
    return pd.DataFrame(
        {
            "case_barcode": pd.Series(
                np.repeat(np.asarray(patients, dtype=object), K),
                dtype=object, copy=False,
            ).astype(combined_df["case_barcode"].dtype),
            "probe_id": pd.Series(
                np.tile(np.asarray(probes, dtype=object), P),
                dtype=object, copy=False,
            ).astype(combined_df["probe_id"].dtype),
            "beta_value": pd.Series(out.ravel().astype(beta_dtype, copy=False)),
        },
        copy=False,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="Prepare DNA methylation matrix")
    parser.add_argument("--output", default="data/dna_methylation_imputed.parquet")
    parser.add_argument(
        "--input-dir", default=None,
        help="local directory of parquet shards (skips the Kaggle download)",
    )
    parser.add_argument(
        "--verify-ingest", nargs="?", const="builtin", default=None,
        metavar="MANIFEST.json",
        help="validate the concatenated shards against the recorded ingest "
        "manifest (data/ingest_manifest.py) and exit — no processing",
    )
    args = parser.parse_args(argv)
    if args.input_dir:
        dna_path = args.input_dir
    else:
        try:
            import kagglehub

            dna_path = kagglehub.dataset_download(DNA_PREP_DATASET)
        except Exception as e:
            raise SystemExit(
                f"Kaggle download failed ({e}); this step requires network "
                "access (or a local mirror via --input-dir)."
            )
    combined_df = load_parquet_shards(dna_path)
    print(f"Shape before processing: {combined_df.shape}")

    manifest = (
        ingest_manifest.load_manifest(args.verify_ingest)
        if args.verify_ingest and args.verify_ingest != "builtin"
        else None
    )
    ok = ingest_manifest.report({"dna_prep_shards": combined_df}, manifest)
    if args.verify_ingest:
        raise SystemExit(0 if ok else 2)
    if not ok:
        raise SystemExit(
            "shard schema does not match the recorded ingest manifest "
            "(issues above)"
        )
    combined_df = build_imputed_matrix(combined_df)
    print(f"Final shape: {combined_df.shape}")
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    combined_df.to_parquet(args.output)
    print(f"Saved to {args.output}")


if __name__ == "__main__":
    main(sys.argv[1:])
