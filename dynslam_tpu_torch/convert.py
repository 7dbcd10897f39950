"""Carry state between the JAX package and the port as numpy arrays.

The learned models' weights map Flax's ``Conv_<i>`` (kernels HWIO) onto a
module's ``convs.<i>`` (weights OIHW) and back
(``flax_to_state_dict``, ``state_dict_to_flax``).

Map and carry names follow the JAX package's fields: ``TsdfState``'s for the map, and
for a fused-pipeline carry the dotted paths of ``FusedCarry`` (or
``FusedDynCarry``) in the order ``jax.tree_util.tree_leaves`` flattens it
(``FUSED_CARRY_KEYS``, ``FUSED_DYN_CARRY_KEYS``), so the ``leaf_<i>``
arrays of ``pipeline/checkpoint.py``'s fused npz map onto them by
position. The dynamic carry's ``inst.*`` arrays are the stacked (S, ...)
object pool.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from dynslam_tpu_torch.ops.features import Features
from dynslam_tpu_torch.ops.tsdf import TsdfConfig, TsdfState
from dynslam_tpu_torch.pipeline.fused import FusedCarry
from dynslam_tpu_torch.pipeline.fused_dynamic import FusedDynCarry

STATE_KEYS = tuple(f.name for f in dataclasses.fields(TsdfState))
_FEATURE_KEYS = Features._fields
FUSED_CARRY_KEYS = (
    *(f"state.{k}" for k in STATE_KEYS),
    "pose_w2c", "held_motion",
    *(f"prev_l.{k}" for k in _FEATURE_KEYS),
    *(f"prev_r.{k}" for k in _FEATURE_KEYS),
    "prev_lg", "prev_rg", "frame_idx", "dropped", "origin", "grid",
    "prev_rc_points", "prev_rc_hit",
)
FUSED_DYN_CARRY_KEYS = (
    *FUSED_CARRY_KEYS,
    *(f"inst.{k}" for k in STATE_KEYS),
    "inst_fidx", "pending_depth", "pending_rgb", "pending_org",
    "prev_pending_depth", "prev_pending_rgb", "prev_pending_org",
)
#: dynamic-carry fields the port keeps as host numpy
_HOST_DYN_KEYS = ("inst_fidx", "pending_org", "prev_pending_org")


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax conv model's variables (``{"params": {"Conv_<i>": {"kernel":
    HWIO, "bias"}}}``, as numpy) as the ``state_dict`` of its module here
    (``convs.<i>.weight`` OIHW, ``convs.<i>.bias``)."""
    out = {}
    for name, p in variables["params"].items():
        i = int(name.split("_")[1])
        kernel = np.asarray(p["kernel"], np.float32)
        out[f"convs.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        out[f"convs.{i}.bias"] = torch.from_numpy(
            np.asarray(p["bias"], np.float32).copy())
    return out


def state_dict_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``flax_to_state_dict``: Flax's variables as numpy,
    convs in order, each ``{"kernel", "bias"}`` (the key order Flax
    creates, so ``utils/msgpack.to_bytes`` writes Flax's bytes)."""
    n = len([k for k in state if k.endswith(".weight")])
    params = {}
    for i in range(n):
        w = state[f"convs.{i}.weight"].detach().float().cpu().numpy()
        params[f"Conv_{i}"] = {
            "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "bias": state[f"convs.{i}.bias"].detach().float().cpu().numpy(),
        }
    return {"params": params}


def tsdf_config_from_jax(cfg) -> TsdfConfig:
    """Copy the fields of the JAX package's ``TsdfConfig``."""
    return TsdfConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(TsdfConfig)})


def tsdf_state_from_numpy(arrays: Mapping[str, np.ndarray],
                          device) -> TsdfState:
    return TsdfState(**{k: torch.tensor(np.asarray(arrays[k]), device=device)
                        for k in STATE_KEYS})


def tsdf_state_to_numpy(state: TsdfState) -> Dict[str, np.ndarray]:
    return {k: getattr(state, k).cpu().numpy() for k in STATE_KEYS}


def _sub(arrays, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix + ".")}


def _features(arrays, device) -> Features:
    # the JAX package keeps a feature's class as int32, the port as int64
    return Features(*(torch.tensor(np.asarray(arrays[k]), device=device,
                                   dtype=torch.int64 if k == "cls" else None)
                      for k in _FEATURE_KEYS))


def fused_carry_from_numpy(arrays: Mapping[str, np.ndarray],
                           device) -> FusedCarry:
    """A port carry from arrays keyed by ``FUSED_CARRY_KEYS``."""
    def t(k):
        return torch.tensor(np.asarray(arrays[k]), device=device)

    return FusedCarry(
        state=tsdf_state_from_numpy(_sub(arrays, "state"), device),
        pose_w2c=t("pose_w2c"), held_motion=t("held_motion"),
        prev_l=_features(_sub(arrays, "prev_l"), device),
        prev_r=_features(_sub(arrays, "prev_r"), device),
        prev_lg=t("prev_lg"), prev_rg=t("prev_rg"),
        frame_idx=int(arrays["frame_idx"]), dropped=t("dropped"),
        origin=t("origin"), grid=t("grid"),
        prev_rc_points=t("prev_rc_points"), prev_rc_hit=t("prev_rc_hit"),
    )


def fused_carry_to_numpy(carry: FusedCarry) -> Dict[str, np.ndarray]:
    out = {f"state.{k}": v
           for k, v in tsdf_state_to_numpy(carry.state).items()}
    for name in ("prev_l", "prev_r"):
        for k, v in zip(_FEATURE_KEYS, getattr(carry, name)):
            a = v.cpu().numpy()
            out[f"{name}.{k}"] = a.astype(np.int32) if k == "cls" else a
    for k in FUSED_CARRY_KEYS:
        if "." not in k:
            v = getattr(carry, k)
            out[k] = v.cpu().numpy() if torch.is_tensor(v) \
                else np.int32(v)
    return out


def fused_dyn_carry_from_numpy(arrays: Mapping[str, np.ndarray],
                               device) -> FusedDynCarry:
    """A port dynamic carry from arrays keyed by ``FUSED_DYN_CARRY_KEYS``."""
    static = fused_carry_from_numpy(arrays, device)
    rest = {k: (np.array(arrays[k], np.int32) if k in _HOST_DYN_KEYS
                else torch.tensor(np.asarray(arrays[k]), device=device))
            for k in FUSED_DYN_CARRY_KEYS
            if "." not in k and k not in FUSED_CARRY_KEYS}
    return FusedDynCarry(
        **static._asdict(),
        inst=tsdf_state_from_numpy(_sub(arrays, "inst"), device), **rest)


def fused_dyn_carry_to_numpy(carry: FusedDynCarry) -> Dict[str, np.ndarray]:
    out = fused_carry_to_numpy(FusedCarry(
        **{k: getattr(carry, k) for k in FusedCarry._fields}))
    out.update({f"inst.{k}": v
                for k, v in tsdf_state_to_numpy(carry.inst).items()})
    for k in FUSED_DYN_CARRY_KEYS:
        if "." not in k and k not in out:
            v = getattr(carry, k)
            out[k] = v.cpu().numpy() if torch.is_tensor(v) \
                else np.array(v, np.int32)
    return out
