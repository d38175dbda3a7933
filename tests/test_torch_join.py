"""Parity of the port's interval joins (ekuiper_tpu_torch/planner/relational.py
`lower_join`, ops/joinring.py JoinRing with the `join_match` kernel's plain
PyTorch version on the CPU, runtime/nodes_relational.py DeviceJoinNode and
runtime/nodes_join.py JoinNode) against the JAX package's.

Every SQL of tests/test_joinring.py and tests/test_join_e2e.py lowers to the
same fields and reason slugs in both packages. The masks are compared
bit for bit: the port's `match` against the JAX `match` and `match_host`
and its own `match_host`, on randomized windows (keys "a", "b", "" and
NULL, NULL event times, NULL residual operands, both band edges) and on
each case of tests/test_joinring.py, each fallback reason included. The
join steps of tests/test_join_e2e.py:166-246 (INNER / LEFT / RIGHT / FULL /
CROSS, window-only bounds, a residual, late rows, a fallback window) run
through both packages' DeviceJoinNode and JoinNode and must emit equal
messages in equal order. Tolerance: none; every comparison is exact.
"""
import gc
import random

import numpy as np
import pytest

from ekuiper_tpu.data.rows import JoinTuple as JJoinTuple
from ekuiper_tpu.data.rows import Tuple as JTuple
from ekuiper_tpu.ops.joinring import JoinWindowFallback as JFallback
from ekuiper_tpu.ops.joinring import SideBatch as JSide
from ekuiper_tpu.planner import relational as jrel
from ekuiper_tpu.runtime.nodes_join import JoinNode as JJoinNode
from ekuiper_tpu.runtime.nodes_relational import DeviceJoinNode as JDevJoin
from ekuiper_tpu.sql.expr_ir import NotVectorizable as JNotVectorizable
from ekuiper_tpu.sql.parser import parse_select as jparse
from ekuiper_tpu_torch.data.rows import JoinTuple, Tuple
from ekuiper_tpu_torch.ops.joinring import (JOIN_PAD_FLOOR, TS_RANGE_CAP,
                                            JoinWindowFallback, SideBatch)
from ekuiper_tpu_torch.planner import relational
from ekuiper_tpu_torch.runtime.nodes_join import JoinNode
from ekuiper_tpu_torch.runtime.nodes_relational import DeviceJoinNode
from ekuiper_tpu_torch.sql.expr_ir import NotVectorizable
from ekuiper_tpu_torch.sql.parser import parse_select

JOIN_SQL = ("SELECT l.v, r.w FROM l INNER JOIN r ON l.k = r.k "
            "AND l.ts - r.ts >= -5 AND l.ts - r.ts <= 5 AND l.v > r.w "
            "GROUP BY TUMBLINGWINDOW(ss, 1)")
KEY_ONLY = ("SELECT l.v, r.w FROM l INNER JOIN r ON l.k = r.k "
            "GROUP BY TUMBLINGWINDOW(ss, 1)")
BAND2 = ("SELECT l.v FROM l INNER JOIN r ON l.k = r.k "
         "AND l.ts - r.ts >= -2 AND l.ts - r.ts <= 2 "
         "GROUP BY TUMBLINGWINDOW(ss, 1)")
#: every statement of tests/test_joinring.py and tests/test_join_e2e.py
LOWER_SQLS = [
    JOIN_SQL, KEY_ONLY, BAND2,
    "SELECT l.v FROM l INNER JOIN r ON l.k = r.k "
    "GROUP BY TUMBLINGWINDOW(ss, 1)",
    "SELECT a.v FROM a INNER JOIN b ON a.k = b.k "
    "INNER JOIN c ON a.k = c.k GROUP BY TUMBLINGWINDOW(ss, 1)",
    "SELECT l.v FROM l INNER JOIN r ON l.v > r.w "
    "GROUP BY TUMBLINGWINDOW(ss, 1)",
    "SELECT l.v FROM l INNER JOIN r ON l.s LIKE r.p "
    "GROUP BY TUMBLINGWINDOW(ss, 1)",
    "SELECT l.v, r.w FROM l CROSS JOIN r GROUP BY TUMBLINGWINDOW(ss, 1)",
    "SELECT ls.id, ls.v, rs.w FROM ls INNER JOIN rs ON ls.id = rs.id "
    "GROUP BY TUMBLINGWINDOW(ss, 10)",
    "SELECT ls.id FROM ls INNER JOIN rs ON ls.id = rs.id",
    "SELECT ls.id, rs.w, meta.site FROM ls INNER JOIN rs ON ls.id = rs.id "
    "INNER JOIN meta ON ls.id = meta.id GROUP BY TUMBLINGWINDOW(ss, 10)",
    "SELECT ev.dev, ev.val, meta.site FROM ev "
    "INNER JOIN meta ON ev.dev = meta.dev",
    "SELECT ls.id, ls.v, rs.w FROM ls LEFT JOIN rs ON ls.id = rs.id "
    "GROUP BY TUMBLINGWINDOW(ss, 10)",
    "SELECT ls.id FROM ls LEFT JOIN rs ON ls.id = rs.id "
    "GROUP BY TUMBLINGWINDOW(ss, 10)",
] + [f"SELECT l.v, r.w FROM l {jt} JOIN r ON l.k = r.k "
     "AND l.ts - r.ts >= -5 AND l.ts - r.ts <= 5 "
     "GROUP BY TUMBLINGWINDOW(ss, 1)"
     for jt in ("INNER", "LEFT", "RIGHT", "FULL")] + [
    f"SELECT l.v, r.w FROM l {jt} JOIN r ON l.k = r.k "
    "GROUP BY TUMBLINGWINDOW(ss, 1)"
    for jt in ("INNER", "LEFT", "RIGHT", "FULL")] + [
    "SELECT l.v, r.w FROM l FULL JOIN r ON l.k = r.k "
    "AND l.ts - r.ts >= -5 AND l.ts - r.ts <= 5 AND l.v > r.w "
    "GROUP BY TUMBLINGWINDOW(ss, 1)",
    "SELECT l.v, r.w FROM l LEFT JOIN r ON l.k = r.k "
    "AND l.ts - r.ts >= -5 AND l.ts - r.ts <= 5 "
    "GROUP BY TUMBLINGWINDOW(ss, 1)",
]


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """As in test_torch_event.py: the JAX package's devwatch registry
    deadlocks when a cyclic collection lands inside its weakref prune, so
    this module runs with the cyclic collector off and collects at end."""
    enabled = gc.isenabled()
    gc.disable()
    yield
    if enabled:
        gc.enable()
    gc.collect()


def _lowered(parse, rel, sql):
    stmt = parse(sql)
    return rel.lower_join(stmt, stmt.joins)


def _rings(sql, capacity=64, bucket_ms=1000):
    """The port's ring (on the CPU) and the JAX ring of one statement (the
    JAX ring's capacity only sizes its compile ladder)."""
    return (_lowered(parse_select, relational, sql).build_ring(
                bucket_ms=bucket_ms, device="cpu"),
            _lowered(jparse, jrel, sql).build_ring(
                capacity=capacity, bucket_ms=bucket_ms))


def _sides(keys, ts=None, **cols):
    """The same side as a port SideBatch and a JAX one."""
    out = []
    for cls in (SideBatch, JSide):
        b = cls(n=len(keys))
        b.key_cols.append(list(keys))
        if ts is not None:
            b.band = list(ts)
        for name, vals in cols.items():
            b.cols[name] = list(vals)
        out.append(b)
    return out


def _match_all(rings, left, right):
    """The port's match, its match_host, and the JAX match and match_host
    of one window: all four must be equal; returns the port's."""
    port, jax = rings
    got = port.match(left[0], right[0])
    assert got.dtype == bool and got.shape == (left[0].n, right[0].n)
    for other in (port.match_host(left[0], right[0]),
                  np.asarray(jax.match(left[1], right[1])),
                  jax.match_host(left[1], right[1])):
        np.testing.assert_array_equal(got, other)
    return got


# ------------------------------------------------------------ lowering
def _lower_facts(parse, rel, sql):
    stmt = parse(sql)
    try:
        low = rel.lower_join(stmt, stmt.joins)
    except (NotVectorizable, JNotVectorizable) as exc:
        return ("refused", exc.reason)
    return (low.join_type.value, low.left, low.right, low.key_l, low.key_r,
            low.band_l, low.band_r, low.lo, low.hi, low.raw_l, low.raw_r,
            low.residual_dev is None)


@pytest.mark.parametrize("sql", LOWER_SQLS)
def test_lower_join_same_fields_and_reasons(sql):
    stmt = parse_select(sql)
    if not stmt.joins:
        pytest.fail("every statement here joins")
    assert _lower_facts(parse_select, relational, sql) == \
        _lower_facts(jparse, jrel, sql)


@pytest.mark.parametrize("sql", LOWER_SQLS)
def test_explain_relational_same_pieces(sql):
    got = relational.explain_relational(parse_select(sql))
    want = jrel.explain_relational(jparse(sql))
    strip = [{k: v for k, v in p.items() if k != "detail"} for p in got]
    assert strip == [{k: v for k, v in p.items() if k != "detail"}
                     for p in want]


def test_string_residual_refused_as_join_on_residual():
    """The one difference of path: the port's IR has no string class, so a
    residual against a string literal is refused (the reference lowers it);
    the rule then runs the nested loop, whose rows equal the reference's
    (tests/test_torch_relational.py holds the whole rule)."""
    sql = ("SELECT l.v FROM l INNER JOIN r ON l.k = r.k AND l.name = 'x' "
           "GROUP BY TUMBLINGWINDOW(ss, 1)")
    assert _lower_facts(parse_select, relational, sql) == (
        "refused", "join_on_residual")
    assert _lower_facts(jparse, jrel, sql)[0] == "INNER"


# --------------------------------------------------------------- masks
def test_randomized_masks_bit_equal():
    """tests/test_joinring.py::test_randomized_device_equals_host, held to
    the JAX package too, with more windows and both band edges."""
    rings = _rings(JOIN_SQL)
    rng = random.Random(11)
    for _ in range(24):
        nl, nr = rng.randint(0, 40), rng.randint(0, 40)
        left = _sides(
            [rng.choice(["a", "b", None, ""]) for _ in range(nl)],
            ts=[rng.choice([rng.randint(0, 30), None]) for _ in range(nl)],
            __jl_v=[rng.choice([1.0, 5.0, None]) for _ in range(nl)])
        right = _sides(
            [rng.choice(["a", "b", None, ""]) for _ in range(nr)],
            ts=[rng.choice([rng.randint(0, 30), None]) for _ in range(nr)],
            __jr_w=[rng.choice([0.0, 3.0, None]) for _ in range(nr)])
        _match_all(rings, left, right)
    port, jax = rings
    assert port.rows_total == jax.rows_total
    assert port.matches_total == jax.matches_total


def test_null_keys_pair_with_each_other_not_empty_string():
    rings = _rings(KEY_ONLY, capacity=16)
    mask = _match_all(rings, _sides([None, "", "a"]),
                      _sides([None, "", "a"]))
    np.testing.assert_array_equal(mask, np.eye(3, dtype=bool))


def test_band_bounds_inclusive():
    rings = _rings(BAND2, capacity=16)
    mask = _match_all(rings, _sides(["a"], ts=[10]),
                      _sides(["a"] * 5, ts=[7, 8, 10, 12, 13]))
    assert mask.tolist() == [[False, True, True, True, False]]


def test_residual_null_is_not_a_match():
    rings = _rings(JOIN_SQL, capacity=16)
    mask = _match_all(rings, _sides(["a", "a"], ts=[0, 0],
                                    __jl_v=[5.0, None]),
                      _sides(["a"], ts=[0], __jr_w=[1.0]))
    assert mask.tolist() == [[True], [False]]


@pytest.mark.parametrize("case", ["ts_type", "ts_range", "float_ts"])
def test_fallback_reasons(case):
    port, jax = _rings(JOIN_SQL, capacity=16)
    if case == "ts_type":
        left = _sides(["a"], ts=["not-a-ts"], __jl_v=[1.0])
        right = _sides(["a"], ts=[0], __jr_w=[0.0])
        reason = "join_ts_type"
    elif case == "ts_range":
        left = _sides(["a", "a"], ts=[0, TS_RANGE_CAP + 10],
                      __jl_v=[1.0, 1.0])
        right = _sides(["a"], ts=[0], __jr_w=[0.0])
        reason = "join_ts_range"
    else:
        left = _sides(["a"], ts=[0.5], __jl_v=[1.0])
        right = _sides(["a"], ts=[1], __jr_w=[0.0])
        reason = "join_ts_type"
    with pytest.raises(JoinWindowFallback) as got:
        port.match(left[0], right[0])
    with pytest.raises(JFallback) as want:
        jax.match(left[1], right[1])
    assert got.value.reason == want.value.reason == reason


def test_many_keys_past_the_capacity():
    """tests/test_joinring.py::test_capacity_doubles_under_key_pressure:
    64 distinct keys against a ring built for 4 (the port's key table and
    pads grow on their own)."""
    rings = _rings("SELECT l.v FROM l INNER JOIN r ON l.k = r.k "
                   "GROUP BY TUMBLINGWINDOW(ss, 1)", capacity=4)
    keys = [f"k{i}" for i in range(64)]
    mask = _match_all(rings, _sides(keys), _sides(keys))
    np.testing.assert_array_equal(mask, np.eye(64, dtype=bool))


def test_pads_power_of_two():
    rings = _rings(JOIN_SQL, capacity=16)
    n = JOIN_PAD_FLOOR + 1
    mask = _match_all(rings, _sides(["a"] * 3, ts=[0] * 3,
                                    __jl_v=[1.0] * 3),
                      _sides(["a"] * n, ts=[0] * n, __jr_w=[0.0] * n))
    assert mask.shape == (3, n) and mask.all()


def test_one_sided_band_and_cross_mask():
    """A half-open band (no equi key) and a CROSS join's all-pairs mask."""
    rings = _rings("SELECT l.v FROM l INNER JOIN r ON l.v > r.w "
                   "GROUP BY TUMBLINGWINDOW(ss, 1)")
    port, jax = rings
    for s in (port, jax):
        assert s.n_key_cols == 0 and s.band
    # the band lane reads l.v / r.w as the integral "event time"
    left = [SideBatch(n=3, band=[1, 5, None]), JSide(n=3, band=[1, 5, None])]
    right = [SideBatch(n=2, band=[0, 4]), JSide(n=2, band=[0, 4])]
    _match_all(rings, left, right)
    cross = _rings("SELECT l.v, r.w FROM l CROSS JOIN r "
                   "GROUP BY TUMBLINGWINDOW(ss, 1)")
    mask = _match_all(cross, [SideBatch(n=2), JSide(n=2)],
                      [SideBatch(n=3), JSide(n=3)])
    assert mask.all()


def test_ring_append_window_evict():
    port, jax = _rings(JOIN_SQL, capacity=16, bucket_ms=10)
    for t in range(0, 50, 5):
        for ring, side in zip((port, jax),
                              _sides(["a"], ts=[t], __jl_v=[1.0])):
            ring.append("l", side)
    assert port.ring_rows("l") == jax.ring_rows("l") == 10
    pw, jw = port.window("l", 10, 29), jax.window("l", 10, 29)
    assert (pw.n, pw.band, pw.key_cols, pw.cols) == \
        (jw.n, jw.band, jw.key_cols, jw.cols)
    assert port.evict(before_ts=20) == jax.evict(before_ts=20) > 0
    assert port.ring_rows("l") == jax.ring_rows("l")
    port.reset_ring()
    assert port.ring_rows("l") == 0


# ---------------------------------------------------------- join steps
def _rows(rng, side, n, late):
    out = []
    for _ in range(n):
        ts = rng.randint(0, 25)
        if late:  # stragglers far outside the band
            ts = rng.choice([ts, ts + 10_000])
        msg = {"k": rng.choice(["a", "b", None]), "ts": ts}
        if side == "l":
            msg["v"] = rng.choice([1.0, 5.0, None])
        else:
            msg["w"] = rng.choice([0.0, 3.0, None])
        out.append((msg, ts))
    return out


def _step_pair(sql):
    """Both packages' host and device join nodes of one statement."""
    stmt, jstmt = parse_select(sql), jparse(sql)
    left = stmt.sources[0].ref_name
    return (JoinNode("join", stmt.joins, left_name=left),
            DeviceJoinNode("join", stmt.joins, left_name=left,
                           lowering=relational.lower_join(stmt, stmt.joins),
                           device="cpu"),
            JJoinNode("join", jstmt.joins, left_name=left),
            JDevJoin("join", jstmt.joins, left_name=left,
                     lowering=jrel.lower_join(jstmt, jstmt.joins)),
            stmt.joins[0], jstmt.joins[0])


def _messages(joined):
    return [[t.message for t in j.tuples] for j in joined]


def _parity_case(sql, trials=8, seed=0, late=False):
    """tests/test_join_e2e.py's _parity_case through both packages: the
    four nodes' emissions (messages AND order) must be equal."""
    host, dev, jhost, jdev, join, jjoin = _step_pair(sql)
    rng = random.Random(seed)
    for _ in range(trials):
        lrows = _rows(rng, "l", rng.randint(0, 12), late)
        rrows = _rows(rng, "r", rng.randint(0, 12), late)
        left = [JoinTuple(tuples=[Tuple(emitter="l", message=dict(m),
                                        timestamp=t)]) for m, t in lrows]
        right = [Tuple(emitter="r", message=dict(m), timestamp=t)
                 for m, t in rrows]
        jleft = [JJoinTuple(tuples=[JTuple(emitter="l", message=dict(m),
                                           timestamp=t)])
                 for m, t in lrows]
        jright = [JTuple(emitter="r", message=dict(m), timestamp=t)
                  for m, t in rrows]
        want = _messages(jdev._join_step(jleft, jright, jjoin))
        assert want == _messages(jhost._join_step(jleft, jright, jjoin))
        assert _messages(dev._join_step(left, right, join)) == want
        assert _messages(host._join_step(left, right, join)) == want
    assert dev.ring.fallback_windows_total == \
        jdev.ring.fallback_windows_total == 0
    assert dev.ring.matches_total == jdev.ring.matches_total


@pytest.mark.parametrize("jt", ["INNER", "LEFT", "RIGHT", "FULL"])
def test_interval_join_types(jt):
    _parity_case(f"SELECT l.v, r.w FROM l {jt} JOIN r ON l.k = r.k "
                 "AND l.ts - r.ts >= -5 AND l.ts - r.ts <= 5 "
                 "GROUP BY TUMBLINGWINDOW(ss, 1)", seed=len(jt))


@pytest.mark.parametrize("jt", ["INNER", "LEFT", "RIGHT", "FULL"])
def test_window_bounds_join_types(jt):
    _parity_case(f"SELECT l.v, r.w FROM l {jt} JOIN r ON l.k = r.k "
                 "GROUP BY TUMBLINGWINDOW(ss, 1)", seed=31 + len(jt))


def test_cross_join():
    _parity_case("SELECT l.v, r.w FROM l CROSS JOIN r "
                 "GROUP BY TUMBLINGWINDOW(ss, 1)", seed=7)


def test_interval_join_with_residual():
    _parity_case("SELECT l.v, r.w FROM l FULL JOIN r ON l.k = r.k "
                 "AND l.ts - r.ts >= -5 AND l.ts - r.ts <= 5 AND l.v > r.w "
                 "GROUP BY TUMBLINGWINDOW(ss, 1)", seed=13)


def test_late_rows():
    _parity_case("SELECT l.v, r.w FROM l LEFT JOIN r ON l.k = r.k "
                 "AND l.ts - r.ts >= -5 AND l.ts - r.ts <= 5 "
                 "GROUP BY TUMBLINGWINDOW(ss, 1)", seed=17, late=True)


def test_fallback_window_runs_host_loop():
    """A non-integer event time in one window: both packages run the
    nested loop for that window only, count it, and emit alike."""
    host, dev, jhost, jdev, join, jjoin = _step_pair(
        "SELECT l.v, r.w FROM l INNER JOIN r ON l.k = r.k "
        "AND l.ts - r.ts >= -5 AND l.ts - r.ts <= 5 "
        "GROUP BY TUMBLINGWINDOW(ss, 1)")
    lmsg, rmsg = {"k": "a", "ts": 0.5, "v": 1.0}, {"k": "a", "ts": 1,
                                                    "w": 2.0}
    got = _messages(dev._join_step(
        [JoinTuple(tuples=[Tuple(emitter="l", message=lmsg)])],
        [Tuple(emitter="r", message=rmsg, timestamp=1)], join))
    want = _messages(jdev._join_step(
        [JJoinTuple(tuples=[JTuple(emitter="l", message=lmsg)])],
        [JTuple(emitter="r", message=rmsg, timestamp=1)], jjoin))
    assert got == want == [[lmsg, rmsg]]
    assert dev.ring.fallback_windows_total == \
        jdev.ring.fallback_windows_total == 1
