"""Executable ingest-schema manifests for the raw Kaggle tables
(counterpart of ``vae_los_angeles_tpu/data/ingest_manifest.py``, the same
contract and checks).

The reference ingests three Kaggle tables with implicit schema assumptions
spread through its transforms (its ``scripts/prepare_data.py`` reads
``case_barcode``/``gene_name``/``tpm_unstranded``/``primary_site`` and
``probe_id[_id]``/``beta_value``; its ``scripts/prepare_dna.py`` reads
``case_barcode``/``probe_id``/``beta_value`` from parquet shards). This
module makes them executable: a recorded manifest of each table's contract
(columns, dtype kinds, nullability, value ranges) that ``prepare_data
--verify-ingest`` and ``prepare_dna --verify-ingest`` check against a real
or locally mirrored table before any processing, so schema drift fails at
the door with a column-by-column report.

The built-in ``EXPECTED`` manifest is transcribed from the reference's
access patterns; ``record_manifest``/``save_manifest`` regenerate it from
live tables. The tables are DataFrames (read from parquet on the machine
that prepares the data); nothing here imports pandas.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

# Column contract grammar:
#   kind: "string" | "numeric" | "integer"  (pandas dtype.kind classes)
#   nullable: bool (default False) — may the column contain nulls?
#   min / max: optional numeric bounds checked on the non-null values
#   alternatives: list of other accepted column names (reference reads
#     probe_id_id when present, else probe_id — prepare_data.py:55-66)
EXPECTED: Dict[str, dict] = {
    "rna_expression": {
        "source": "martininf1n1ty/rna-mutations-all-datasets/"
                  "expression_onko_db.parquet",
        "columns": {
            "case_barcode": {"kind": "string"},
            "gene_name": {"kind": "string"},
            "tpm_unstranded": {"kind": "numeric", "min": 0.0},
            # groupby-'first' skips nulls, so null sites are tolerated
            "primary_site": {"kind": "string", "nullable": True},
        },
    },
    "dna_methylation": {
        "source": "martininf1n1ty/dna-methylation-final-adnotated/*.parquet",
        "columns": {
            "case_barcode": {"kind": "string"},
            "probe_id": {"kind": "string", "alternatives": ["probe_id_id"]},
            # β-values are proportions; prepare_dna's imputation upstream may
            # leave nulls in un-imputed mirrors, so nullable here
            "beta_value": {"kind": "numeric", "min": 0.0, "max": 1.0,
                           "nullable": True},
        },
    },
    "dna_prep_shards": {
        "source": "martininf1n1ty/dna-metylation-onkodb/**/*.parquet",
        "columns": {
            "case_barcode": {"kind": "string"},
            "probe_id": {"kind": "string"},
            # raw shards carry the missing values the imputation exists for
            "beta_value": {"kind": "numeric", "min": 0.0, "max": 1.0,
                           "nullable": True},
        },
    },
}

# numpy dtype.kind letters that count as string; 'O'/'U'/'S' plus pandas
# extension string dtypes (parquet readers vary by pandas version)
_STRING_KINDS = set("OUS")


def _column_kind(series) -> str:
    kind = getattr(series.dtype, "kind", "O")
    if kind in _STRING_KINDS or str(series.dtype).startswith(
        ("string", "large_string")
    ):
        return "string"
    if kind == "f":
        return "numeric"
    if kind in "iu":
        return "integer"
    if kind == "b":
        return "boolean"
    return f"other({series.dtype})"


def _kind_ok(found: str, want: str) -> bool:
    if want == "numeric":
        return found in ("numeric", "integer")
    return found == want


def verify_table(df, table: str, manifest: Optional[dict] = None) -> List[str]:
    """Check one DataFrame against its recorded contract.

    Returns a list of human-readable issues; empty means the table satisfies
    every assumption the prep pipeline makes about it.
    """
    manifest = manifest or EXPECTED
    if table not in manifest:
        return [f"{table}: no manifest entry (known: {sorted(manifest)})"]
    spec = manifest[table]["columns"]
    issues: List[str] = []
    if len(df) == 0:
        issues.append(f"{table}: table is empty")
    for name, rules in spec.items():
        actual_name = name
        if name not in df.columns:
            for alt in rules.get("alternatives", []):
                if alt in df.columns:
                    actual_name = alt
                    break
            else:
                issues.append(
                    f"{table}.{name}: column missing (have: "
                    f"{list(df.columns)})"
                )
                continue
        col = df[actual_name]
        found = _column_kind(col)
        if not _kind_ok(found, rules["kind"]):
            issues.append(
                f"{table}.{actual_name}: expected {rules['kind']} dtype, "
                f"found {found}"
            )
            continue
        n_null = int(col.isna().sum())
        if n_null and not rules.get("nullable", False):
            issues.append(
                f"{table}.{actual_name}: {n_null} null value(s) in a "
                "non-nullable key column"
            )
        if rules["kind"] in ("numeric", "integer") and len(col) > n_null:
            vals = col.dropna()
            lo, hi = float(vals.min()), float(vals.max())
            if "min" in rules and lo < rules["min"] - 1e-9:
                issues.append(
                    f"{table}.{actual_name}: min {lo} below expected "
                    f"{rules['min']}"
                )
            if "max" in rules and hi > rules["max"] + 1e-9:
                issues.append(
                    f"{table}.{actual_name}: max {hi} above expected "
                    f"{rules['max']}"
                )
    return issues


def verify_frames(frames: Dict[str, "object"],
                  manifest: Optional[dict] = None) -> List[str]:
    """Verify several (table_name → DataFrame) pairs; concatenated issues."""
    issues: List[str] = []
    for table, df in frames.items():
        issues.extend(verify_table(df, table, manifest))
    return issues


def report(frames: Dict[str, "object"],
           manifest: Optional[dict] = None) -> bool:
    """Print a per-table verdict; True iff every table passes."""
    ok = True
    for table, df in frames.items():
        issues = verify_table(df, table, manifest)
        if issues:
            ok = False
            print(f"INGEST FAIL {table} ({len(df)} rows):")
            for issue in issues:
                print(f"  - {issue}")
        else:
            print(f"ingest ok   {table}: {len(df)} rows, "
                  f"{len(df.columns)} columns match the manifest")
    return ok


def record_manifest(frames: Dict[str, "object"]) -> dict:
    """Record a manifest FROM live tables (for users with Kaggle access):
    captures each column's kind, nullability and numeric range so the
    checked-in contract can be regenerated against dataset updates."""
    out: dict = {}
    for table, df in frames.items():
        cols = {}
        for name in df.columns:
            col = df[name]
            rules: dict = {"kind": _column_kind(col)}
            if bool(col.isna().any()):
                rules["nullable"] = True
            if rules["kind"] in ("numeric", "integer") and len(col):
                vals = col.dropna()
                if len(vals):
                    rules["min"] = float(vals.min())
                    rules["max"] = float(vals.max())
            cols[name] = rules
        out[table] = {"source": EXPECTED.get(table, {}).get("source", ""),
                      "columns": cols}
    return out


def save_manifest(manifest: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)


def load_manifest(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
