"""Checkpoint/resume for long batch jobs: the port's counterpart of
micro_quad_slam_tpu/utils/checkpoint.py, in its pickle layout.

A checkpoint directory holds `step_N.pkl` files, each one pickle of host
numpy arrays in plain dicts and tuples (the JAX package's format where
orbax is absent, `utils/checkpoint.py:53-56` there), so either package
reads the other's files:

- restore_checkpoint reads the port's files and the JAX package's.  A
  JAX pickle names the JAX package's NamedTuple classes (MappingState,
  SimState, FcSim, BehaviorState, EkfState); the port's unpickler maps
  each to a factory of a field dict, from the port's own copy of the
  field list, and never imports the JAX package.  Every other global but
  numpy's array reconstructors is refused.
- save_checkpoint writes what it is given, as host numpy: the callers
  hand it mapping_state_to_numpy's dict (replay), the JAX CLI's plain
  tuple (grid, origin_x, origin_y) (slam) and sim_state_to_numpy's dict
  with the generator's state (sim).

Orbax directories (`step_N/`, what the JAX package writes where orbax is
installed) are found by latest_checkpoint but not read: the port does not
depend on orbax.
"""

from __future__ import annotations

import importlib
import os
import pickle
from typing import Any, Optional

import numpy as np

# the field order of the JAX package's NamedTuples, by (module, class):
# NEWOBJ hands a class its fields by position
_MAPPING_FIELDS = ("grid", "origin_x", "origin_y", "inited", "filt")
_EKF_FIELDS = ("mean", "cov")
_FC_FIELDS = ("armed", "mode", "motor", "takeoff_active", "takeoff_target",
              "have_ack", "ack_res", "ack_ms", "accept_ms", "batt_v",
              "climb_cmd", "vset_bx", "vset_by", "yaw_rate_cmd", "pos_cmd",
              "pos_cmd_yaw", "pos_hold")
_SIM_FIELDS = ("t_ms", "key", "x", "y", "yaw", "vx", "vy", "alt", "fc",
               "beh", "mapper", "ekf", "tof_min", "scan_count", "cam_prev",
               "cam_valid", "vis_rate_x", "vis_rate_y", "vis_q", "frontier")


def _behavior_fields() -> tuple:
    from micro_quad_slam_tpu_torch.models.behavior import BehaviorState
    return BehaviorState._fields


JAX_RECORDS = {
    ("micro_quad_slam_tpu.replay.mapping", "MappingState"): _MAPPING_FIELDS,
    ("micro_quad_slam_tpu.ops.ekf", "EkfState"): _EKF_FIELDS,
    ("micro_quad_slam_tpu.models.simulator", "FcSim"): _FC_FIELDS,
    ("micro_quad_slam_tpu.models.simulator", "SimState"): _SIM_FIELDS,
    ("micro_quad_slam_tpu.models.behavior", "BehaviorState"): _behavior_fields,
}

# numpy's globals in an array pickle, under numpy 1's and numpy 2's names
_NUMPY_GLOBALS = {
    ("multiarray", "_reconstruct"), ("multiarray", "scalar"),
    ("numeric", "_frombuffer"),
}


def _record(name: str, fields: tuple) -> type:
    """A class that the unpickler can hand NEWOBJ: building it with the
    fields by position gives the dict {field: value}."""
    def __new__(cls, *values):
        if len(values) != len(fields):
            raise pickle.UnpicklingError(
                f"{name}: {len(values)} fields in the checkpoint, "
                f"{len(fields)} expected")
        return dict(zip(fields, values))
    return type(name, (), {"__new__": __new__})


def _numpy_global(module: str, name: str):
    """numpy's array reconstructors under numpy.core.* or numpy._core.*,
    resolved in the installed numpy; None for any other global."""
    head, _, sub = module.partition(".")
    if head != "numpy":
        return None
    if module == "numpy" and name in ("ndarray", "dtype"):
        return getattr(np, name)
    pkg, _, leaf = sub.partition(".")
    if pkg not in ("core", "_core") or (leaf, name) not in _NUMPY_GLOBALS:
        return None
    for base in ("numpy._core", "numpy.core"):
        try:
            return getattr(importlib.import_module(f"{base}.{leaf}"), name)
        except (ImportError, AttributeError):
            continue
    return None


class CheckpointUnpickler(pickle.Unpickler):
    """Reads a checkpoint pickle of either package: the JAX package's
    NamedTuples become field dicts, numpy arrays and scalars are rebuilt,
    and every other global is refused."""

    def find_class(self, module: str, name: str):
        fields = JAX_RECORDS.get((module, name))
        if fields is not None:
            return _record(name, fields() if callable(fields) else fields)
        fn = _numpy_global(module, name)
        if fn is None:
            raise pickle.UnpicklingError(
                f"checkpoint refers to {module}.{name}, which a checkpoint "
                f"of host numpy arrays does not hold")
        return fn


def _to_host(tree):
    """Tensors -> numpy arrays through dicts, lists and tuples."""
    if hasattr(tree, "detach") and hasattr(tree, "cpu"):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_host(v) for v in tree)
    if hasattr(tree, "_fields"):
        raise TypeError(f"save_checkpoint takes dicts, lists, tuples and "
                        f"arrays, not a {type(tree).__name__}: convert it "
                        f"first (mapping_state_to_numpy, sim_state_to_numpy)")
    return tree


def save_checkpoint(path: str, state: Any, step: int = 0) -> str:
    """Write `state` (dicts, lists and tuples of numpy arrays, numbers or
    tensors, which go to the host) as path/step_{step}.pkl; returns the
    written path."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, f"step_{step}.pkl")
    with open(target, "wb") as f:
        pickle.dump(_to_host(state), f)
    return target


def restore_checkpoint(target: str, like: Optional[Any] = None) -> Any:
    """Read a checkpoint file written by either package's save_checkpoint
    (see the module docstring); `like` is accepted for the JAX function's
    signature and not needed."""
    del like
    if not target.endswith(".pkl"):
        raise ValueError(f"{target}: not a pickle checkpoint (step_N.pkl); "
                         f"the port does not read orbax directories")
    with open(target, "rb") as f:
        return CheckpointUnpickler(f).load()


def latest_checkpoint(path: str) -> Optional[str]:
    """The checkpoint of the highest step in directory `path` (on a tie an
    orbax directory before a pickle, as the JAX package picks), or None."""
    if not os.path.isdir(path):
        return None
    best, best_key = None, (-1, -1)
    for name in sorted(os.listdir(path)):
        if name.startswith("step_"):
            try:
                step = int(name.split("_")[1].split(".")[0])
            except (IndexError, ValueError):
                continue
            fmt = 0 if name.endswith(".pkl") else 1
            if (step, fmt) > best_key:
                best, best_key = os.path.join(path, name), (step, fmt)
    return best
