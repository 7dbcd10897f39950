"""Configuration files of the benchmark: a cell's workload file and its
configuration file, found by name under the benchmark's folder, and a
configuration's nested ``config`` object turned into the dataclasses of
either package (the port's, or the reference's frozen copy)."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

#: the benchmark's folder: ``configs/``, ``workloads/``, ``metrics/``
ROOT = Path(__file__).resolve().parent


def load_workload(name: str, root: Path = ROOT) -> dict:
    """``workloads/<name>.json``, with its configuration file's contents
    under ``"config_file"``."""
    cell = json.loads((Path(root) / "workloads" / f"{name}.json").read_text())
    cell["name"] = name
    cell["config_file"] = json.loads(
        (Path(root) / "configs" / f"{cell['config']}.json").read_text())
    return cell


def build(cls, values: dict):
    """An instance of the dataclass ``cls`` with the defaults replaced by
    ``values``; nested dicts fill nested dataclass fields, lists become
    tuples. Raises on a key ``cls`` does not have."""
    base = cls()
    names = {f.name for f in dataclasses.fields(base)}
    kw = {}
    for key, v in values.items():
        if key not in names:
            raise KeyError(f"{cls.__name__} has no field {key!r}")
        cur = getattr(base, key)
        if isinstance(v, dict):
            kw[key] = build(type(cur), v)
        elif isinstance(v, list):
            kw[key] = tuple(v)
        else:
            kw[key] = v
    return dataclasses.replace(base, **kw)
