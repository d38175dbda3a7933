"""Parity of the port's expression IR (ekuiper_tpu_torch/sql/expr_ir.py,
device mode: closures over torch tensors) against the JAX package's
device closures (jax.numpy), and of its host twins (mode "host", numpy)
against the JAX package's host twins, over the operator classes a rule's WHERE,
FILTER and aggregate arguments compile to in the port: numeric/logic with
three-valued NULL logic, BETWEEN, IN (literal and dynamic), CASE, bitwise
operators and math functions. The reference's string-dictionary and
event-time classes are not ported yet: the port must refuse exactly those
expressions (NotVectorizable, reason "not-ported") and never lower them
as numbers.

Both packages get the same numpy columns. Boolean results (WHERE /
FILTER masks) must be equal; numeric results (aggregate arguments) must be
equal to float32 rounding: rtol 1e-6, NaN (NULL) in the same places —
both evaluate the same float32 operations in the same order, and only the
transcendental functions' last bit may differ between XLA and torch.
The host twins of both packages evaluate the same numpy calls, so their
results must be bit-equal, NaN in the same places.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekuiper_tpu.data.batch import from_messages
from ekuiper_tpu.sql import expr_ir as jax_ir
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu_torch.sql import expr_ir
from ekuiper_tpu_torch.sql.parser import parse_select

ANCHOR = (1754265600000 // 86_400_000) * 86_400_000  # UTC midnight

MSGS = [
    {"a": 10, "f": 1.5, "dev": "d1", "status": "ok",
     "ts": ANCHOR + 3_600_000},
    {"a": 20, "f": 2.5, "dev": "d2", "status": "warn",
     "ts": ANCHOR + 5_400_000},
    {"a": None, "f": 3.5, "dev": None, "status": "err",
     "ts": ANCHOR + 86_400_000 + 123_456},
    {"a": 30, "f": None, "dev": "d1", "status": "zzz", "ts": None},
    {"a": -5, "f": 0.0, "dev": "d3", "status": None,
     "ts": ANCHOR - 7_200_000},
    {"a": 7, "f": -2.25, "dev": "d2", "status": "ok",
     "ts": ANCHOR + 45_296_000},
]

BOOL_EXPRS = [
    "a > 15", "a >= 20 AND f < 3.0", "a > 15 OR f > 3.0",
    "NOT (a > 15)", "NOT (a > 15) OR f > 3.0",
    "a + f > 12", "a * 2 - f > 30", "a % 3 = 1", "a / 4 > 2",
    "a = a", "a != 10", "15 < a",
    "a BETWEEN 5 AND 25", "a NOT BETWEEN 5 AND 25",
    "a IN (10, 30)", "a NOT IN (10, 30)", "a IN (10, 'ok')",
    "a IN (f, 30)", "TRUE", "1 = 1", "'x' = 'x'",
    "CASE WHEN a > 15 THEN 1 ELSE 0 END > 0",
    "CASE WHEN a > 15 THEN 1 WHEN f > 3.0 THEN 2 END = 2",
    "sqrt(f * f) > 2.0", "abs(0 - a) >= 20", "floor(f) = 2",
    "bitand(a, 6) = 2", "a & 3 = 2",
]

NUMBER_EXPRS = [
    "a", "f", "a * 2 + f", "-f", "a / 4", "a % 7", "f / 0.5",
    "CASE WHEN a > 15 THEN f ELSE 0.0 END",
    "a > 15", "sqrt(f * f)", "abs(a)", "round(f)", "ceil(f)", "sign(f)",
    "power(f, 2)", "mod(a, 4)", "exp(f)", "ln(a)", "log(a)", "sin(f)",
    "atan2(f, 2.0)", "trunc(f, 1)", "bitxor(a, 5)",
]

#: string-dictionary and event-time expressions: the reference lowers them
#: through host-derived int32 columns, which the port does not have yet
NOT_PORTED_EXPRS = [
    "dev = 'd1'", "dev != 'd1'", "'d1' = dev",
    "status IN ('ok', 'warn')", "status NOT IN ('ok', 'warn')",
    "dev = 'd1' AND status != 'err'", "dev = 'nope'", "a = 'x'",
    "CASE status WHEN 'ok' THEN 1 WHEN 'warn' THEN 2 ELSE 0 END >= 2",
    "CASE WHEN status = 'ok' THEN 1 WHEN f > 3.0 THEN 2 END = 2",
    "hour(ts) >= 1", "minute(ts) = 30", "second(ts) = 0",
    "year(ts) = 2025", "month(ts) = 8", "day(ts) = 4",
    "day_of_week(ts) > 3", "day_of_month(ts) IN (3, 4, 5)",
    f"ts > {ANCHOR + 4_000_000}",
    f"ts BETWEEN {ANCHOR} AND {ANCHOR + 5_400_000}",
    f"ts - {ANCHOR} > 4000000",
    "dev = 'd1' AND hour(ts) > 0",
]
NOT_PORTED_NUMBER_EXPRS = [
    "CASE status WHEN 'ok' THEN 1 WHEN 'warn' THEN 2 ELSE 0 END",
    "hour(ts)", "day_of_week(ts)", "year(ts)",
]


@pytest.fixture(scope="module")
def batch():
    b, _ = from_messages(MSGS, [0] * len(MSGS), emitter="t")
    return b


def _cols(batch):
    cols = {k: np.asarray(v).astype(np.float32)
            for k, v in batch.columns.items() if v.dtype != np.object_}
    for name, vm in batch.valid.items():
        cols["__valid_" + name] = np.asarray(vm)
    return cols


def _where(sql: str, parse):
    return parse(f"SELECT * FROM t WHERE {sql}").condition


def _both(sql: str, want: str, batch):
    jce = jax_ir.compile_expr_ir(_where(sql, jax_parse), mode="device",
                                 want=want, anchor_ms=ANCHOR)
    tce = expr_ir.compile_expr_ir(_where(sql, parse_select), want=want)
    assert tce.ir_key == jce.ir_key
    assert tce.columns == jce.columns
    assert set(jce.col_dtypes.values()) <= {"float32"} and not jce.derived
    cols = _cols(batch)
    ref = jce({k: jnp.asarray(v) for k, v in cols.items()})
    got = tce({k: torch.from_numpy(v) for k, v in cols.items()})
    n = batch.n
    ref = np.broadcast_to(np.asarray(ref), (n,))
    if isinstance(got, torch.Tensor):
        assert got.device.type == "cpu"
        got = got.numpy()
    return np.broadcast_to(np.asarray(got), (n,)), ref


@pytest.mark.parametrize("sql", BOOL_EXPRS)
def test_bool_closures_match_reference(sql, batch):
    got, ref = _both(sql, "bool", batch)
    assert got.tolist() == ref.astype(bool).tolist(), sql


@pytest.mark.parametrize("sql", NUMBER_EXPRS)
def test_number_closures_match_reference(sql, batch):
    got, ref = _both(sql, "number", batch)
    assert got.dtype == np.float32, sql
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, equal_nan=True,
                               err_msg=sql)


@pytest.mark.parametrize(
    "sql,want",
    [(x, "bool") for x in BOOL_EXPRS] + [(x, "number") for x in NUMBER_EXPRS])
def test_host_twins_match_reference(sql, want, batch):
    """The numpy binding the window tail's shadow folds with."""
    jce = jax_ir.compile_expr_ir(_where(sql, jax_parse), mode="host",
                                 want=want, anchor_ms=ANCHOR)
    tce = expr_ir.compile_expr_ir(_where(sql, parse_select), mode="host",
                                  want=want)
    assert tce.ir_key == jce.ir_key and tce.columns == jce.columns
    cols = _cols(batch)
    with np.errstate(divide="ignore", invalid="ignore"):
        ref = np.broadcast_to(np.asarray(jce(dict(cols))), (batch.n,))
        got = tce(dict(cols))
    assert isinstance(got, (np.ndarray, np.generic, bool)), sql  # no torch
    got = np.broadcast_to(np.asarray(got), (batch.n,))
    assert got.dtype == ref.dtype, sql
    np.testing.assert_array_equal(got, ref, err_msg=sql)


@pytest.mark.parametrize(
    "sql,want",
    [(x, "bool") for x in NOT_PORTED_EXPRS]
    + [(x, "number") for x in NOT_PORTED_NUMBER_EXPRS])
def test_string_and_event_time_classes_are_refused(sql, want):
    """The reference lowers these (through derived dictionary / ts32
    columns); the port refuses them rather than lowering them as numbers."""
    jce = jax_ir.compile_expr_ir(_where(sql, jax_parse), mode="device",
                                 want=want, anchor_ms=ANCHOR)
    assert jce.derived, sql
    with pytest.raises(expr_ir.NotVectorizable) as got:
        expr_ir.compile_expr_ir(_where(sql, parse_select), want=want)
    assert got.value.reason == "not-ported", sql


@pytest.mark.parametrize("sql", [
    "dev LIKE 'd%'", "dev > 'a'", "concat(dev, 'x') = 'y'",
    "a IN (" + ", ".join(map(str, range(300))) + ")",
])
def test_refusals_match_reference(sql):
    with pytest.raises(jax_ir.NotVectorizable) as ref:
        jax_ir.compile_expr_ir(_where(sql, jax_parse), mode="device",
                               want="bool", anchor_ms=ANCHOR)
    with pytest.raises(expr_ir.NotVectorizable) as got:
        expr_ir.compile_expr_ir(_where(sql, parse_select), want="bool")
    assert got.value.reason == ref.value.reason
