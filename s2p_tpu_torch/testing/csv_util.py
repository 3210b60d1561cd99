"""progress.csv regression helpers: the port of ``s2p_tpu/testing/csv_util.py``.

Load a progress.csv as row dicts and compare two runs key by key with a
relative tolerance (rlkit's ``testing/csv_util.py``); seeded runs and the
logger's frozen key set make the comparison meaningful.
"""

from __future__ import annotations

import csv
import math
from typing import Dict, List, Sequence


def get_exp(csv_path: str) -> List[Dict[str, str]]:
    with open(csv_path, newline="") as f:
        return list(csv.DictReader(f))


def _to_float(v: str):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def check_equal(
    reference: Sequence[Dict[str, str]],
    output: Sequence[Dict[str, str]],
    keys: Sequence[str],
    rel_tol: float = 1e-5,
) -> None:
    assert len(reference) == len(output), (
        f"row count mismatch: {len(reference)} vs {len(output)}"
    )
    for i, (ref_row, out_row) in enumerate(zip(reference, output)):
        for key in keys:
            a, b = _to_float(ref_row[key]), _to_float(out_row[key])
            if isinstance(a, float) and isinstance(b, float):
                ok = (
                    math.isclose(a, b, rel_tol=rel_tol, abs_tol=1e-12)
                    or (math.isnan(a) and math.isnan(b))
                )
            else:
                ok = a == b
            assert ok, f"row {i} key {key!r}: {a!r} != {b!r} (rel_tol={rel_tol})"


def check_exactly_equal(
    reference: Sequence[Dict[str, str]],
    output: Sequence[Dict[str, str]],
    keys: Sequence[str],
) -> None:
    check_equal(reference, output, keys, rel_tol=0.0)
