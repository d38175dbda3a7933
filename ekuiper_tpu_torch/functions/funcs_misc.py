"""Scalar functions with a row path (subset of
ekuiper_tpu/functions/funcs_misc.py): `isnull`, the engine's IS NULL test,
which the host row evaluator (sql/eval.py) runs."""
from __future__ import annotations

from .registry import SCALAR, register


@register("isnull", SCALAR)
def f_isnull(args, ctx):
    return args[0] is None
