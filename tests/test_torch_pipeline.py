"""The port's whole rule path (SQL → plan → fused node → kernels' plain
versions → direct-emit tail) on the CPU against the JAX package's
FusedWindowAggNode, built as the JAX package's benchmark builds it: the
flagship tumbling rule and a hopping rule with stddev, every emitted row
compared, plus a checkpoint written by the JAX node restored into the port.

Tolerances, each against the JAX node's output: keys, counts, min and max
exact; avg rtol 1e-5 (float32 scatter-add order); stddev rtol 1e-4 plus
the cancellation floor 4·sqrt(ε32)·|mean| for keys whose variance is ~0.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest

from ekuiper_tpu.data.batch import ColumnBatch as JaxBatch
from ekuiper_tpu.ops.aggspec import extract_kernel_plan as jax_plan_of
from ekuiper_tpu.ops.emit import build_direct_emit as jax_direct_emit
from ekuiper_tpu.runtime.events import Trigger as JaxTrigger
from ekuiper_tpu.runtime.nodes_fused import FusedWindowAggNode as JaxNode
from ekuiper_tpu.sql.parser import parse_select as jax_parse
from ekuiper_tpu_torch.data.batch import ColumnBatch
from ekuiper_tpu_torch.data.rows import GroupedTuplesSet
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
from ekuiper_tpu_torch.ops.emit import build_direct_emit
from ekuiper_tpu_torch.planner.fused import plan_fused_rule
from ekuiper_tpu_torch.runtime.events import Trigger
from ekuiper_tpu_torch.runtime.node import Node
from ekuiper_tpu_torch.runtime.nodes_fused import FusedWindowAggNode
from ekuiper_tpu_torch.sql.parser import parse_select

TUMBLING = (
    "SELECT deviceId, avg(temperature) AS avg_t, count(*) AS cnt, "
    "min(temperature) AS min_t, max(temperature) AS max_t "
    "FROM demo GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)"
)
HOPPING = (
    "SELECT deviceId, avg(temperature) AS avg_t, count(*) AS cnt, "
    "min(temperature) AS min_t, max(temperature) AS max_t, "
    "stddev(temperature) AS sd_t "
    "FROM demo GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)"
)
N_DEV, ROWS, SLOTS, MB = 150, 400, 256, 256


@pytest.fixture(scope="module", autouse=True)
def _no_cyclic_gc_inside_jax_locks():
    """The JAX package's devwatch registry prunes its weakrefs under a lock
    that a dying watch's __del__ also takes, so a cyclic collection that
    lands inside the prune deadlocks the process. This module builds many
    JAX group-bys: it runs with the cyclic collector off and collects once
    at its end, outside any lock."""
    enabled = gc.isenabled()
    gc.disable()
    yield
    if enabled:
        gc.enable()
    gc.collect()


def _jax_node(sql, columnar=True, direct=True):
    stmt = jax_parse(sql)
    plan = jax_plan_of(stmt)
    node = JaxNode(
        "ref", stmt.window, plan, dims=[d.expr for d in stmt.dimensions],
        capacity=SLOTS, micro_batch=MB,
        direct_emit=(jax_direct_emit(stmt, plan, ["deviceId"])
                     if direct else None),
        emit_columnar=columnar, prefinalize_backstop=False)
    node.state = node.gb.init_state()
    got = []
    node.broadcast = got.append
    return node, got


def _port_node(sql, columnar=True, direct=True):
    """The port's node on the synchronous boundary (prefinalizeLeadMs 0):
    every window finalizes on the device route, as the JAX node's boundary
    without a pre-issue does (tests/test_torch_prefinalize.py drives the
    pre-issued route)."""
    if columnar and direct:
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=MB,
                               device="cpu",
                               options={"prefinalizeLeadMs": 0})
    else:
        stmt = parse_select(sql)
        plan = extract_kernel_plan(stmt)
        node = FusedWindowAggNode(
            "port", stmt.window, plan, [d.expr for d in stmt.dimensions],
            capacity=SLOTS, micro_batch=MB,
            direct_emit=(build_direct_emit(stmt, plan, ["deviceId"])
                         if direct else None),
            emit_columnar=columnar, device="cpu", prefinalize_lead_ms=0)
    got = []
    node.broadcast = got.append
    return node, got


def _batches(seed, n_batches):
    rng = np.random.default_rng(seed)
    ids = np.array([f"dev_{i}" for i in range(N_DEV)], dtype=np.object_)
    out = []
    for _ in range(n_batches):
        idx = rng.integers(0, N_DEV, ROWS)
        temp = rng.normal(20, 5, ROWS).astype(np.float32)
        out.append({"deviceId": ids[idx], "temperature": temp})
    return out


def _drive(jnode, tnode, batches, per_window, t0=0):
    """Each batch is a column dict, or (column dict, validity dict)."""
    interval = jnode._tick_interval()
    for w in range(len(batches) // per_window):
        for cols in batches[w * per_window:(w + 1) * per_window]:
            cols, valid = cols if isinstance(cols, tuple) else (cols, {})
            n = len(next(iter(cols.values())))
            jnode.process(JaxBatch(n=n, columns=dict(cols),
                                   valid=dict(valid), emitter="demo"))
            tnode.process(ColumnBatch(n=n, columns=dict(cols),
                                      valid=dict(valid), emitter="demo"))
        ts = t0 + (w + 1) * interval
        jnode.on_trigger(JaxTrigger(ts=ts))
        jnode._drain_async_emits()
        tnode.on_trigger(Trigger(ts=ts))


def _rows(item):
    """Emitted window → list of row dicts (any of the three emit shapes)."""
    if isinstance(item, list):
        return item
    if hasattr(item, "groups"):
        return [{**g.content[0].message, **g.agg_values} for g in item.groups]
    names = list(item.columns)
    return [dict(zip(names, vals))
            for vals in zip(*(item.columns[k].tolist() for k in names))]


def _assert_same_windows(got, ref):
    assert len(got) == len(ref) > 0
    for g_item, r_item in zip(got, ref):
        g_rows, r_rows = _rows(g_item), _rows(r_item)
        assert len(g_rows) == len(r_rows) > 0
        for g, r in zip(g_rows, r_rows):
            assert g.keys() == r.keys()
            for k, rv in r.items():
                gv = g[k]
                if rv is None or isinstance(rv, str):
                    assert gv == rv, k
                elif k.startswith(("avg", "avg(")):
                    assert gv == pytest.approx(rv, rel=1e-5), k
                elif k.startswith(("sd", "stddev")):
                    floor = 4 * np.sqrt(np.finfo(np.float32).eps) * abs(
                        r.get("avg_t", 20.0))
                    assert abs(gv - rv) <= 1e-4 * abs(rv) + floor, k
                elif k.startswith("p9"):  # percentile: the same bin centre
                    assert gv == pytest.approx(rv, rel=4 * 2.0 ** -23), k
                elif k.startswith("u_"):  # hll estimate
                    assert abs(gv - rv) <= 1, k
                else:
                    assert gv == rv, k


@pytest.mark.parametrize("sql,per_window", [(TUMBLING, 3), (HOPPING, 2)],
                         ids=["tumbling", "hopping"])
def test_rule_matches_reference(sql, per_window):
    jnode, ref = _jax_node(sql)
    tnode, got = _port_node(sql)
    assert tnode.n_panes == jnode.n_panes
    _drive(jnode, tnode, _batches(1, 4 * per_window), per_window)
    assert tnode.cur_pane == jnode.cur_pane
    _assert_same_windows(got, ref)


@pytest.mark.parametrize("columnar,direct", [(False, True), (False, False)],
                         ids=["messages", "grouped"])
def test_emit_shapes_match_reference(columnar, direct):
    jnode, ref = _jax_node(HOPPING, columnar, direct)
    tnode, got = _port_node(HOPPING, columnar, direct)
    _drive(jnode, tnode, _batches(2, 4), 2)
    if not direct:
        assert all(isinstance(x, GroupedTuplesSet) for x in got)
    _assert_same_windows(got, ref)


@pytest.mark.parametrize("sql", [TUMBLING, HOPPING],
                         ids=["tumbling", "hopping"])
def test_reference_checkpoint_restores_into_port(sql):
    """A snapshot the JAX node writes mid-window restores into the port;
    both then finish the same windows with the same output, and the
    port's own snapshot has the reference's format and content."""
    jnode, ref = _jax_node(sql)
    batches = _batches(3, 6)
    for cols in batches[:2]:
        jnode.process(JaxBatch(n=ROWS, columns=dict(cols), emitter="demo"))
    jnode.on_trigger(JaxTrigger(ts=jnode._tick_interval()))
    jnode._drain_async_emits()
    jnode.process(JaxBatch(n=ROWS, columns=dict(batches[2]),
                           emitter="demo"))
    snap = jnode.snapshot_state()
    ref.clear()
    tnode, got = _port_node(sql)
    tnode.restore_state(snap)
    mine = tnode.snapshot_state()
    assert mine.keys() == {"keys", "partials", "cur_pane", "rows_in_window"}
    assert mine["keys"] == snap["keys"]
    assert mine["cur_pane"] == snap["cur_pane"]
    assert mine["partials"] == {k: v for k, v in snap["partials"].items()
                                if k != "touch"}
    _drive(jnode, tnode, batches[3:], 3, t0=jnode._tick_interval())
    _assert_same_windows(got, ref)


def test_port_rejects_shapes_it_does_not_run():
    # an overlapping count window runs on the reference's host path (a
    # plain COUNTWINDOW plans: tests/test_torch_windows.py)
    with pytest.raises(NotImplementedError):
        plan_fused_rule("SELECT d, hll(v) AS h FROM s "
                        "GROUP BY d, COUNTWINDOW(100, 50)", device="cpu")
    with pytest.raises(NotImplementedError):
        plan_fused_rule("SELECT d, avg(v) AS a FROM s "
                        "GROUP BY d, SLIDINGWINDOW(ss, 10)", device="cpu")
    with pytest.raises(NotImplementedError):
        plan_fused_rule("SELECT d, median(v) AS m FROM s "
                        "GROUP BY d, TUMBLINGWINDOW(ss, 10)", device="cpu")


class _Sink(Node):
    def __init__(self):
        super().__init__("sink")
        self.got = []

    def process(self, item):
        self.got.append(item)


def test_connected_node_emits_each_window_downstream():
    tnode = plan_fused_rule(TUMBLING, key_slots=SLOTS, micro_batch=MB,
                            device="cpu")
    sink = tnode.connect(_Sink())
    kernels.reset_launches()
    for cols in _batches(4, 2):
        tnode.process(ColumnBatch(n=ROWS, columns=dict(cols)))
    tnode.on_trigger(Trigger(ts=10_000))
    assert len(sink.got) == 1 and sink.got[0].n == N_DEV
    assert int(sink.got[0].columns["cnt"].sum()) == 2 * ROWS
    assert kernels.LAUNCHES["groupby_fold"] == 0  # CPU: plain only


@pytest.mark.parametrize("stage", ["fold_scalar_plain",
                                   "finalize_scalar_plain"])
def test_kernel_failure_reaches_the_caller(stage, monkeypatch):
    """A kernel that fails raises out of process / on_trigger: the batch
    is not dropped quietly and no window is emitted without it."""
    tnode, got = _port_node(TUMBLING)
    batch = _batches(5, 1)[0]

    def fail(*args, **kwargs):
        raise RuntimeError(f"{stage} failed")

    monkeypatch.setattr(kernels, stage, fail)
    with pytest.raises(RuntimeError, match="failed"):
        tnode.process(ColumnBatch(n=ROWS, columns=dict(batch)))
        tnode.on_trigger(Trigger(ts=10_000))
    assert got == []


# ------------------------------------------------------------ sketch rules
# BASELINE config #2 (bench.py bench_hopping_heavy_hitters), and the other
# three sketch aggregates of bench.py's 256-rule mix (bench.py:1623,
# 1626) in one hopping rule. Tolerances beyond the ones above:
# heavy-hitter lists equal; the percentile in the same bin within 4 ulp
# (torch.exp against XLA's exp on the bin centre); hll estimates within
# ±1 (a 256-term float32 sum in another order). The hll inputs here hit no
# value where jnp.log2 misses floor(log2) (the register-level exception,
# tests/test_torch_sketches.py), which _hll_misses checks.
HH_RULE = ("SELECT deviceId, heavy_hitters(code, 3) AS top, count(*) AS c "
           "FROM demo GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)")
WIDE_RULE = ("SELECT deviceId, stddev(temperature) AS sd, percentile_approx"
             "(temperature, 0.9) AS p90, hll(humidity) AS u_h, "
             "distinct_count_approx(code) AS u_c FROM demo "
             "GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)")


def _sketch_batches(seed, n_batches, codes="int"):
    """bench.py's skewed codes (7 at 35 %, 13 at 20 %, 99 at 15 %, a
    2,000-value tail), N(20, 5) temperatures, humidity on the 1,000
    one-decimal values; dev_empty's codes are all NULL."""
    rng = np.random.default_rng(seed)
    ids = np.array([f"dev_{i}" for i in range(N_DEV)] + ["dev_empty"],
                   dtype=np.object_)
    out = []
    for _ in range(n_batches):
        idx = rng.integers(0, N_DEV + 1, ROWS)
        p = rng.random(ROWS)
        code = np.where(p < 0.35, 7, np.where(p < 0.55, 13, np.where(
            p < 0.70, 99, rng.integers(100, 2100, ROWS)))).astype(np.int64)
        null = (rng.random(ROWS) < 0.05) | (idx == N_DEV)
        cols = {"deviceId": ids[idx],
                "temperature": rng.normal(20, 5, ROWS).astype(np.float32),
                "humidity": (rng.integers(0, 1000, ROWS) / 10).astype(
                    np.float32)}
        if codes == "str":
            col = np.array([f"c{c}" for c in code], dtype=np.object_)
            col[null] = None
            cols["code"] = col
            out.append(cols)
        else:
            cols["code"] = code
            out.append((cols, {"code": ~null}))
    return out


def _hll_misses(batches):
    from ekuiper_tpu.ops import sketches as jsk
    from ekuiper_tpu_torch.ops.aggspec import encode_hll_column

    vals = np.unique(np.concatenate([
        encode_hll_column(b[0]["humidity"] if isinstance(b, tuple)
                          else b["humidity"], ROWS) for b in batches]))
    hv = np.maximum(np.asarray(jsk.hash_f32(vals, 1)), 1).astype(np.float32)
    exact = np.floor(np.log2(hv.astype(np.float64)))
    return int((np.asarray(jnp.floor(jnp.log2(jnp.asarray(hv)))) != exact)
               .sum())


@pytest.mark.parametrize("sql,codes,per_window", [
    (HH_RULE, "str", 2), (WIDE_RULE, "int", 2)],
    ids=["heavy_hitters-str", "percentile-hll"])
def test_sketch_rule_matches_reference(sql, codes, per_window):
    jnode, ref = _jax_node(sql)
    tnode, got = _port_node(sql)
    batches = _sketch_batches(21, 3 * per_window, codes)
    assert _hll_misses(batches) == 0
    _drive(jnode, tnode, batches, per_window)
    _assert_same_windows(got, ref)
    for cb in got:
        rows = {r["deviceId"]: r for r in _rows(cb)}
        if "top" in rows["dev_0"]:
            assert rows["dev_empty"]["top"] == []  # NULL codes only
            lead = [r["top"][0]["value"] for r in rows.values() if r["top"]]
            assert lead.count("c7") > len(lead) / 2  # 35 % of the rows


def test_heavy_hitters_checkpoint_restores_across_packages():
    """A JAX checkpoint with its value dictionaries restores into the port
    and the port's into the JAX package; integer codes decode to ints."""
    jnode, ref = _jax_node(HH_RULE)
    batches = _sketch_batches(23, 6, "int")
    for cols, valid in batches[:2]:
        jnode.process(JaxBatch(n=ROWS, columns=dict(cols),
                               valid=dict(valid), emitter="demo"))
    jnode.on_trigger(JaxTrigger(ts=jnode._tick_interval()))
    jnode._drain_async_emits()
    cols, valid = batches[2]
    jnode.process(JaxBatch(n=ROWS, columns=dict(cols), valid=dict(valid),
                           emitter="demo"))
    snap = jnode.snapshot_state()
    assert snap["hh_dicts"]["code"][:3] == [7, 13, 99]
    ref.clear()
    tnode, got = _port_node(HH_RULE)
    tnode.restore_state(snap)
    mine = tnode.snapshot_state()
    assert mine["hh_dicts"] == snap["hh_dicts"]
    assert mine["partials"] == {k: v for k, v in snap["partials"].items()
                                if k != "touch"}
    back, _ = _jax_node(HH_RULE)
    back.restore_state(mine)
    assert back.snapshot_state()["partials"] == snap["partials"]
    _drive(jnode, tnode, batches[3:], 3, t0=jnode._tick_interval())
    _assert_same_windows(got, ref)
    top = {r["deviceId"]: r["top"] for r in _rows(got[-1])}
    assert top["dev_empty"] == []
    assert all(type(e["value"]) is int for t in top.values() for e in t)


@pytest.mark.parametrize("stage", ["fold_wide_plain", "finalize_wide_plain",
                                   "hh_finalize_plain"])
def test_sketch_kernel_failure_reaches_the_caller(stage, monkeypatch):
    """As test_kernel_failure_reaches_the_caller, for the sketch kernels."""
    sql = ("SELECT deviceId, heavy_hitters(code, 3) AS top, "
           "hll(humidity) AS u FROM demo "
           "GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)")
    tnode, got = _port_node(sql)
    cols, valid = _sketch_batches(5, 1)[0]

    def fail(*args, **kwargs):
        raise RuntimeError(f"{stage} failed")

    monkeypatch.setattr(kernels, stage, fail)
    with pytest.raises(RuntimeError, match="failed"):
        tnode.process(ColumnBatch(n=ROWS, columns=dict(cols),
                                  valid=dict(valid)))
        tnode.on_trigger(Trigger(ts=10_000))
    assert got == []
