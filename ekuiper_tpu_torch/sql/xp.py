"""The array namespaces the expression IR binds its closures to.

`sql/expr_ir.py` lowers an expression once and builds its closures against
an array namespace `xp`. Where the reference binds `jax.numpy` (its device
mode) or `numpy` (its host mode), the port binds `TORCH` or `NUMPY`.

`TORCH` (tensors, on whatever device the columns live) mirrors the jnp
calls the IR makes, with jnp's treatment of Python scalars:

- a scalar operand becomes a 0-dim CPU tensor, which torch passes to a
  kernel on any device by value (no host-to-device copy per evaluation),
  and a call whose operands are all scalars is computed by numpy, as jnp
  would fold a constant;
- logical AND/OR against a Python bool reduce to the tensor itself or a
  constant mask, since torch's logical ops take tensors only.

It adds `astype(v, np_dtype)` and `const_like(values, like)`: torch
tensors have no `.astype`, and a constant vector must be placed on the
device of the column it is compared with.

`NUMPY` is numpy itself with those two helpers: the host twins that the
window tail's shadow fold evaluates over host columns
(ops/prefinalize.py HostShadow).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

_TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def _is_t(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def _scalar(x: Any) -> Any:
    """numpy scalars become Python scalars (torch takes those by value)."""
    return x.item() if isinstance(x, np.generic) else x


def _op(torch_fn, np_fn):
    """Elementwise call: torch when any operand is a tensor, else numpy."""

    def f(*args):
        dev = next((a for a in args if _is_t(a)), None)
        if dev is None:
            return np_fn(*args)
        # some torch ops take no Python scalar operand: a scalar becomes a
        # 0-dim CPU tensor, which combines with a tensor on any device as
        # a by-value scalar (no copy to the device)
        return torch_fn(*[a if _is_t(a) else torch.as_tensor(_scalar(a))
                          for a in args])

    return f


def _logical(torch_fn, np_fn, is_and: bool):
    def f(a, b):
        if not _is_t(a) and not _is_t(b):
            return np_fn(a, b)
        if not _is_t(a):
            a, b = b, a  # both ops commute
        if not _is_t(b):
            if bool(b) == is_and:  # x AND True / x OR False
                return a.bool()
            return (torch.zeros_like(a, dtype=torch.bool) if is_and
                    else torch.ones_like(a, dtype=torch.bool))
        return torch_fn(a, b)

    return f


class _TorchNS:
    """jnp-shaped namespace over torch (see module docstring)."""

    float32 = torch.float32

    isnan = staticmethod(_op(torch.isnan, np.isnan))
    logical_not = staticmethod(_op(torch.logical_not, np.logical_not))
    logical_and = staticmethod(_logical(torch.logical_and, np.logical_and,
                                        True))
    logical_or = staticmethod(_logical(torch.logical_or, np.logical_or,
                                       False))
    equal = staticmethod(_op(torch.eq, np.equal))
    not_equal = staticmethod(_op(torch.ne, np.not_equal))
    less = staticmethod(_op(torch.lt, np.less))
    less_equal = staticmethod(_op(torch.le, np.less_equal))
    greater = staticmethod(_op(torch.gt, np.greater))
    greater_equal = staticmethod(_op(torch.ge, np.greater_equal))
    mod = staticmethod(_op(torch.remainder, np.mod))  # floor-mod, as jnp
    bitwise_and = staticmethod(_op(torch.bitwise_and, np.bitwise_and))
    bitwise_or = staticmethod(_op(torch.bitwise_or, np.bitwise_or))
    bitwise_xor = staticmethod(_op(torch.bitwise_xor, np.bitwise_xor))
    invert = staticmethod(_op(torch.bitwise_not, np.invert))
    abs = staticmethod(_op(torch.abs, np.abs))
    arccos = staticmethod(_op(torch.arccos, np.arccos))
    arcsin = staticmethod(_op(torch.arcsin, np.arcsin))
    arctan = staticmethod(_op(torch.arctan, np.arctan))
    arctan2 = staticmethod(_op(torch.arctan2, np.arctan2))
    cos = staticmethod(_op(torch.cos, np.cos))
    cosh = staticmethod(_op(torch.cosh, np.cosh))
    sin = staticmethod(_op(torch.sin, np.sin))
    sinh = staticmethod(_op(torch.sinh, np.sinh))
    tan = staticmethod(_op(torch.tan, np.tan))
    tanh = staticmethod(_op(torch.tanh, np.tanh))
    exp = staticmethod(_op(torch.exp, np.exp))
    log = staticmethod(_op(torch.log, np.log))
    log10 = staticmethod(_op(torch.log10, np.log10))
    sqrt = staticmethod(_op(torch.sqrt, np.sqrt))
    ceil = staticmethod(_op(torch.ceil, np.ceil))
    floor = staticmethod(_op(torch.floor, np.floor))
    round = staticmethod(_op(torch.round, np.round))  # half to even, as jnp
    trunc = staticmethod(_op(torch.trunc, np.trunc))
    sign = staticmethod(_op(torch.sign, np.sign))
    radians = staticmethod(_op(torch.deg2rad, np.radians))
    degrees = staticmethod(_op(torch.rad2deg, np.degrees))
    power = staticmethod(_op(torch.pow, np.power))

    @staticmethod
    def where(cond, x, y):
        if not _is_t(cond):
            return x if cond else y
        return torch.where(cond, _scalar(x), _scalar(y))

    @staticmethod
    def any(x, axis):
        return torch.any(x, dim=axis) if _is_t(x) else np.any(x, axis)

    @staticmethod
    def expand_dims(x, axis):
        return x.unsqueeze(axis) if _is_t(x) else np.expand_dims(x, axis)

    @staticmethod
    def astype(v, dtype):
        if _is_t(v):
            return v.to(_TORCH_DTYPE[np.dtype(dtype)])
        return np.asarray(v).astype(dtype)

    @staticmethod
    def const_like(values: np.ndarray, like):
        if _is_t(like):
            return torch.as_tensor(values, device=like.device)
        return values


TORCH = _TorchNS()


class _NumpyNS:
    """numpy, plus the two helpers the IR calls beside the array API."""

    def __getattr__(self, name: str) -> Any:
        return getattr(np, name)

    @staticmethod
    def astype(v, dtype):
        return np.asarray(v).astype(dtype)

    @staticmethod
    def const_like(values: np.ndarray, like):
        return values


NUMPY = _NumpyNS()
