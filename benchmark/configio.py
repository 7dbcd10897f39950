"""Configuration files of the benchmark: a cell's workload file and its
configuration file, found by name under the benchmark's folder, the check
plug-ins (``checks/<name>.py``), the per-layer metrics' files
(``metrics/<name>.py``), and a configuration's nested ``config`` object
turned into the dataclasses of either package (the port's, or the
reference's frozen copy)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

#: the benchmark's folder: ``configs/``, ``workloads/``, ``metrics/``,
#: ``checks/``
ROOT = Path(__file__).resolve().parent


def load_module(path: Path, prefix: str):
    """The Python file ``path``, executed as a module of its own."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_plugins(root: Path = ROOT) -> dict:
    """Every check plug-in of ``checks/``, by name: a module with
    ``READINGS``, ``probe``, ``gaps`` and ``control_gaps``. Raises where
    one lacks a name or gives a reading another check gives."""
    from benchmark import check

    out, given = {}, {r: "the built-in check" for r in check.ALL_READINGS}
    for path in sorted((Path(root) / "checks").glob("*.py")):
        mod = load_module(path, "benchmark_check")
        for attr in ("READINGS", "probe", "gaps", "control_gaps"):
            if not hasattr(mod, attr):
                raise ValueError(f"check plug-in {path.name} has no {attr}")
        for r in mod.READINGS:
            if r in given:
                raise ValueError(f"check plug-in {path.name} gives {r!r}, "
                                 f"which {given[r]} gives")
            given[r] = f"check plug-in {path.name}"
        out[path.stem] = mod
    return out


def load_workload(name: str, root: Path = ROOT) -> dict:
    """``workloads/<name>.json``, with its configuration file's contents
    under ``"config_file"`` and, under ``"plugins"``, the check plug-ins
    that give a reading its ``limits`` name. Raises where a limit names a
    reading that neither the built-in check (for the configuration's
    mode) nor a plug-in gives, where the ``"lidar"`` rig is malformed, or
    where a static configuration has one."""
    from benchmark import check

    cell = json.loads((Path(root) / "workloads" / f"{name}.json").read_text())
    cell["name"] = name
    cell["config_file"] = json.loads(
        (Path(root) / "configs" / f"{cell['config']}.json").read_text())
    dynamic = bool(cell["config_file"]["config"].get("dynamic_mode", True))
    rig = cell["config_file"].get("lidar")
    if rig is not None:
        from benchmark import lidar

        lidar.validate(rig)
        if not dynamic:
            raise ValueError(
                f"{cell['config']}: a \"lidar\" rig needs a dynamic "
                f"configuration: the dynamic pipeline drives its evaluation "
                f"itself, while the static pipeline's caller would have to "
                f"submit each frame (builder.attach_evaluation)")
    plugins = check_plugins(root)
    given = set(check.readings(dynamic))
    cell["plugins"] = {}
    for pname, mod in plugins.items():
        if set(mod.READINGS) & set(cell["limits"]):
            cell["plugins"][pname] = mod
            given |= set(mod.READINGS)
    unknown = sorted(set(cell["limits"]) - given)
    if unknown:
        raise ValueError(f"{name}: no check gives the limits {unknown}")
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
