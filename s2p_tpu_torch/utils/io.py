"""File IO helpers: the port of ``s2p_tpu/utils/io.py``.

Capability contract (reference: rlkit/util/io.py:90-136
``load_local_or_remote_file`` + ``CPU_Unpickler``): load pkl / npy / joblib
artifacts by extension; torch-pickled files are loaded CPU-side. The
reference's S3/doodad remote modes are out of scope (the shipped scripts
run ``mode='here_no_doodad'``)."""

from __future__ import annotations

import pickle
from typing import Any, Optional


def load_local_or_remote_file(filepath: str, file_type: Optional[str] = None) -> Any:
    if file_type is None:
        if filepath.endswith((".npy", ".npz")):
            file_type = "numpy"
        elif filepath.endswith((".joblib",)):
            file_type = "joblib"
        elif filepath.endswith((".pt", ".pth")):
            file_type = "torch"
        else:
            file_type = "pickle"
    if file_type == "numpy":
        import numpy as np

        return np.load(filepath, allow_pickle=True)
    if file_type == "joblib":
        import joblib

        return joblib.load(filepath)
    if file_type == "torch":
        import torch

        return torch.load(filepath, map_location="cpu", weights_only=False)
    with open(filepath, "rb") as f:
        try:
            return pickle.load(f)
        except Exception:
            # torch-pickled content under a .pkl name (reference CPU_Unpickler)
            import torch

            return torch.load(filepath, map_location="cpu", weights_only=False)


def save_pickle(obj: Any, filepath: str) -> str:
    with open(filepath, "wb") as f:
        pickle.dump(obj, f)
    return filepath
