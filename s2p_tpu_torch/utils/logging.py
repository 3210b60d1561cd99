"""Experiment logger: the port of ``s2p_tpu/utils/logging.py``.

- tabular rows → ``progress.csv``, with the key set frozen at the first
  dump (later rows with other keys warn and are filled with blanks);
- a human-readable table on stdout, and every message in ``debug.log``;
- the experiment's config → ``variant.json``;
- per-iteration snapshots (``save_itr_params``) in the modes ``all | last |
  gap | gap_and_last | none``: pickles of trees whose tensors became numpy
  arrays, so that the JAX package reads them too;
- ``logger``, the module-level logger the RL loops default to;
- key prefixes (``push_prefix``/``pop_prefix``), ``TerminalTablePrinter``,
  ``set_print_tabular`` and ``save_extra_data`` (JSON or a pickle in the
  run directory).
"""

from __future__ import annotations

import csv
import datetime
import json
import os
import os.path as osp
import pickle
import sys
from collections import OrderedDict
from typing import Any, Iterable, Mapping, Optional

SNAPSHOT_MODES = ("all", "last", "gap", "gap_and_last", "none")


def _json_default(o: Any) -> Any:
    """numpy scalars and arrays as numbers and lists; anything else as its repr."""
    for attr in ("item", "tolist"):
        fn = getattr(o, attr, None)
        if callable(fn):
            try:
                return fn()
            except (TypeError, ValueError):
                pass
    return repr(o)


def variant_json(variant: Mapping[str, Any]) -> str:
    return json.dumps(variant, indent=2, sort_keys=True, default=_json_default)


def _to_host(tree: Any) -> Any:
    """``tree`` with every tensor as a numpy array (dicts, lists, tuples
    recursed)."""
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    if isinstance(tree, Mapping):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class TerminalTablePrinter:
    @staticmethod
    def format(rows: Iterable[tuple]) -> str:
        rows = [(str(k), str(v)) for k, v in rows]
        if not rows:
            return ""
        kw = max(len(k) for k, _ in rows)
        vw = max(len(v) for _, v in rows)
        sep = "-" * (kw + vw + 7)
        return "\n".join([sep] + [f"| {k.ljust(kw)} | {v.ljust(vw)} |" for k, v in rows]
                         + [sep])


class Logger:
    def __init__(self) -> None:
        self._log_dir: Optional[str] = None
        self._tabular: "OrderedDict[str, Any]" = OrderedDict()
        self._tabular_keys: Optional[list] = None
        self._tabular_prefixes: list = []
        self._csv_file = None
        self._csv_writer = None
        self._text_file = None
        self._snapshot_mode = "gap_and_last"
        self._snapshot_gap = 10
        self._print_tabular = True

    @property
    def log_dir(self) -> Optional[str]:
        return self._log_dir

    def set_log_dir(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        self.close()
        self._log_dir = log_dir
        self._tabular_keys = None
        self._csv_file = open(osp.join(log_dir, "progress.csv"), "a", newline="")
        self._text_file = open(osp.join(log_dir, "debug.log"), "a")

    def set_snapshot_mode(self, mode: str) -> None:
        if mode not in SNAPSHOT_MODES:
            raise ValueError(f"unknown snapshot mode {mode!r}")
        self._snapshot_mode = mode

    def set_snapshot_gap(self, gap: int) -> None:
        if gap < 1:
            raise ValueError(f"snapshot gap {gap} < 1")
        self._snapshot_gap = gap

    def set_print_tabular(self, flag: bool) -> None:
        self._print_tabular = flag

    def log(self, msg: str, with_timestamp: bool = True) -> None:
        if with_timestamp:
            now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")[:-3]
            msg = f"{now} | {msg}"
        print(msg)
        sys.stdout.flush()
        if self._text_file is not None:
            self._text_file.write(msg + "\n")
            self._text_file.flush()

    def log_variant(self, variant: Mapping[str, Any]) -> None:
        if self._log_dir is None:
            raise RuntimeError("log_variant needs a log dir: call set_log_dir first")
        with open(osp.join(self._log_dir, "variant.json"), "w") as f:
            f.write(variant_json(variant))

    def push_prefix(self, prefix: str) -> None:
        """Prepend ``prefix`` (after those pushed before it) to the keys
        recorded until it is popped."""
        self._tabular_prefixes.append(prefix)

    def pop_prefix(self) -> None:
        self._tabular_prefixes.pop()

    def record_tabular(self, key: str, value: Any) -> None:
        self._tabular["".join(self._tabular_prefixes) + key] = value

    def record_dict(self, d: Mapping[str, Any], prefix: Optional[str] = None) -> None:
        for k, v in d.items():
            self.record_tabular(f"{prefix}{k}" if prefix else k, v)

    def dump_tabular(self) -> None:
        if not self._tabular:
            return
        row = dict(self._tabular)
        if self._print_tabular:
            print(TerminalTablePrinter.format(row.items()))
            sys.stdout.flush()
        if self._csv_writer is None and self._csv_file is not None:
            # freeze the csv key set on the first dump so later rows stay aligned
            self._tabular_keys = list(row)
            self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=self._tabular_keys,
                                              extrasaction="ignore")
            self._csv_writer.writeheader()
        if self._csv_writer is not None:
            missing = set(self._tabular_keys) - set(row)
            extra = set(row) - set(self._tabular_keys)
            if missing or extra:
                self.log("WARNING: tabular key mismatch vs frozen header "
                         f"(missing={sorted(missing)}, extra={sorted(extra)})")
            self._csv_writer.writerow({k: row.get(k, "") for k in self._tabular_keys})
            self._csv_file.flush()
        self._tabular.clear()

    def save_itr_params(self, itr: int, params: Any) -> Optional[str]:
        """Snapshot ``params`` as the mode says: ``itr_{itr}.pkl`` (all;
        gap, every ``gap`` iterations), ``params.pkl`` (last), both
        (gap_and_last) or nothing (none, or no log dir). Returns the path
        written last, or None."""
        if self._log_dir is None or self._snapshot_mode == "none":
            return None
        mode, gap = self._snapshot_mode, self._snapshot_gap
        if mode == "all":
            name = f"itr_{itr}.pkl"
        elif mode == "last":
            name = "params.pkl"
        elif mode == "gap":
            if itr % gap != 0:
                return None
            name = f"itr_{itr}.pkl"
        else:  # gap_and_last
            if itr % gap == 0:
                self._write_snapshot(f"itr_{itr}.pkl", params)
            name = "params.pkl"
        return self._write_snapshot(name, params)

    def _write_snapshot(self, name: str, params: Any) -> str:
        path = osp.join(self._log_dir, name)
        with open(path, "wb") as f:
            pickle.dump(_to_host(params), f)
        return path

    def save_extra_data(self, data: Any, file_name: str) -> str:
        """``data`` in the run directory: as JSON (anything else as its
        repr) when ``file_name`` ends in ``.json``, else pickled with its
        tensors as numpy arrays. Returns the path."""
        if self._log_dir is None:
            raise RuntimeError("save_extra_data needs a log dir: call set_log_dir first")
        path = osp.join(self._log_dir, file_name)
        if file_name.endswith(".json"):
            with open(path, "w") as f:
                json.dump(data, f, indent=2, default=repr)
        else:
            with open(path, "wb") as f:
                pickle.dump(_to_host(data), f)
        return path

    def close(self) -> None:
        for f in (self._csv_file, self._text_file):
            if f is not None:
                f.close()
        self._csv_file = self._csv_writer = self._text_file = None


def setup_logger(exp_name: str, variant: Optional[Mapping[str, Any]] = None,
                 base_log_dir: str = "./logs", seed: int = 0,
                 unique_timestamp: bool = True, snapshot_mode: str = "gap_and_last",
                 snapshot_gap: int = 10, log: Optional[Logger] = None) -> tuple[Logger, str]:
    """``log`` (a new logger when None) writing into a new run directory
    ``{base_log_dir}/{exp_name}/{exp_name}_{timestamp}_s{seed}`` (with
    ``variant.json`` when a variant is given), snapshotting as
    ``snapshot_mode``/``snapshot_gap`` say; returns (logger, run dir)."""
    log = log or Logger()
    stamp = (datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
             if unique_timestamp else "run")
    log_dir = osp.join(base_log_dir, exp_name, f"{exp_name}_{stamp}_s{seed}")
    log.set_log_dir(log_dir)
    log.set_snapshot_mode(snapshot_mode)
    log.set_snapshot_gap(snapshot_gap)
    if variant is not None:
        log.log_variant(variant)
        log.log(f"Variant:\n{variant_json(variant)}", with_timestamp=False)
    log.log(f"Logging to {log_dir}")
    return log, log_dir


# the module-level logger the loops default to, as the JAX package's
logger = Logger()
