"""The device mesh of a sharded rule (counterpart of
ekuiper_tpu/parallel/mesh.py).

A mesh has two logical axes, as the reference's:

- "rows": data parallelism over a batch's rows; each row shard folds its
  rows into partials of its own, merged across the axis afterwards;
- "keys": the GROUP BY key axis; key shard k owns the contiguous slot
  range [k·c, (k+1)·c) of the state, c = capacity / K.

The port's mesh is a (rows, keys) grid of torch devices, built from the
device list a caller gives the planner (utils/device.py
resolve_devices). That list may name one device R·K times: the port's
counterpart of the reference's virtual CPU mesh, on the CPU in the tests
and on one card on the chip. A list of two different cards is refused
there; a mesh across cards is not ported yet.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import Device, resolve_devices


class Mesh:
    """A (rows, keys) grid of devices: `shape` {"rows": R, "keys": K} and
    `devices` (R, K) as the reference's jax.sharding.Mesh has them. Every
    device of the grid is one device (`device`), where the state lives."""

    def __init__(self, devices: Sequence[torch.device], rows: int,
                 keys: int) -> None:
        devs = list(devices)
        if rows * keys != len(devs):
            raise ValueError(f"mesh {rows}x{keys} != {len(devs)} devices")
        self.devices = np.empty((rows, keys), dtype=object)
        for i, d in enumerate(devs):
            self.devices[i // keys, i % keys] = d
        self.shape = {"rows": int(rows), "keys": int(keys)}
        self.device = devs[0]


def make_mesh(rows: int = 1, keys: Optional[int] = None,
              devices: Device = None) -> Mesh:
    """A mesh with axes ("rows", "keys") over `devices` (every visible card
    when None). Defaults to putting all devices on the keys axis (state
    capacity is usually the scale limit)."""
    devs = resolve_devices(devices)
    return Mesh(devs, rows, len(devs) // rows if keys is None else keys)


def ensure_devices(n: int, devices: Device = None) -> List[torch.device]:
    """The first n devices of `devices` (every visible card when None).
    Raises RuntimeError when the list holds fewer, as the reference does
    when its backend cannot provide them."""
    if n < 1:
        raise ValueError(f"need a positive device count, got {n}")
    devs = resolve_devices(devices)
    if len(devs) >= n:
        return devs[:n]
    raise RuntimeError(
        f"{len(devs)} devices given; cannot place a mesh of {n} — pass a "
        f"device list of {n} (one device may repeat: a virtual mesh)")


def mesh_cfg_from_env() -> Optional[Dict[str, Any]]:
    """Parse the deployment-wide KUIPER_MESH env into a mesh config dict:
    "RxK" (rows x keys), a bare shard count K (keys axis), or "auto"
    (all local devices on the keys axis, resolved at mesh-build time).
    Unset / "0" / "off" / "none" -> None. Parse errors return None with
    nothing raised — a malformed env var must not take rule planning
    down; the planner records the single-chip plan it causes."""
    raw = os.environ.get("KUIPER_MESH", "").strip().lower()
    if not raw or raw in ("0", "off", "none", "1"):
        return None
    if raw == "auto":
        return {"auto": True}
    try:
        if "x" in raw:
            rows_s, keys_s = raw.split("x", 1)
            rows, keys = int(rows_s), int(keys_s)
        else:
            rows, keys = 1, int(raw)
    except ValueError:
        return None
    if rows < 1 or keys < 1 or rows * keys < 2:
        return None
    return {"rows": rows, "keys": keys}


def resolve_auto_cfg(cfg: Dict[str, Any],
                     devices: Device = None) -> Optional[Dict[str, Any]]:
    """Turn an {"auto": True} config into a concrete {"rows", "keys"}
    from the devices given (every visible card when None). None when
    there are fewer than 2 — auto sharding on a single device is just the
    single-chip kernel."""
    if not cfg.get("auto"):
        return cfg
    n = len(resolve_devices(devices))
    if n < 2:
        return None
    return {"rows": 1, "keys": n}


def mesh_from_options(mesh_cfg: dict, devices: Device = None) -> Mesh:
    """A mesh from a rule's planOptimizeStrategy.mesh option, e.g.
    {"rows": 2, "keys": 4}, over the first rows·keys of `devices`."""
    rows = int(mesh_cfg.get("rows", 1))
    keys = int(mesh_cfg.get("keys", 1))
    if rows < 1 or keys < 1:
        raise ValueError(f"mesh axes must be positive, got {rows}x{keys}")
    return make_mesh(rows=rows, keys=keys,
                     devices=ensure_devices(rows * keys, devices))
