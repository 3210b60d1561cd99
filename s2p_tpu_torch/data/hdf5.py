"""HDF5 reader of the image-RL dataset (the generation CLI's input).

The port of ``load_rl_dataset`` from ``s2p_tpu/data/hdf5.py``: the
per-transition ``observations/actions/rewards/next_observations``, the
single-frame ``image_observations`` (NHWC uint8, kept as stored) and the
``timeouts`` episode delimiters, plus the optional keys when present.
``h5py`` is imported when a file is read, so the rest of the package runs
where it is not installed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

RL_KEYS = (
    "observations",
    "actions",
    "rewards",
    "next_observations",
    "image_observations",
    "timeouts",
)
RL_OPTIONAL = (
    "terminals",
    "image_observations_tm1",
    "image_observations_tm2",
    "image_observations_tp1",
    "qpos_qvel",
)


def load_rl_dataset(path: str, data_num: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Read the required and any optional RL keys (the first ``data_num``
    rows, or all); 2-D ``[N, 1]`` rewards are squeezed to ``[N]``."""
    import h5py

    out: Dict[str, np.ndarray] = {}
    sl = slice(None) if data_num is None else slice(data_num)
    with h5py.File(path, "r") as f:
        for k in RL_KEYS:
            if k not in f:
                raise KeyError(f"{path} missing required dataset {k!r}")
            out[k] = f[k][sl]
        for k in RL_OPTIONAL:
            if k in f:
                out[k] = f[k][sl]
    if out["rewards"].ndim == 2 and out["rewards"].shape[1] == 1:
        out["rewards"] = out["rewards"].squeeze(-1)
    return out
