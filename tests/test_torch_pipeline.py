"""The port's whole rule path (SQL → plan → fused node → kernels' plain
versions → direct-emit tail) on the CPU against the JAX package's
FusedWindowAggNode, built as the JAX package's benchmark builds it: the
flagship tumbling rule and a hopping rule with stddev, every emitted row
compared, plus a checkpoint written by the JAX node restored into the port.

Tolerances, each against the JAX node's output: keys, counts, min and max
exact; avg rtol 1e-5 (float32 scatter-add order); stddev rtol 1e-4 plus
the cancellation floor 4·sqrt(ε32)·|mean| for keys whose variance is ~0.
"""
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
    if columnar and direct:
        node = plan_fused_rule(sql, key_slots=SLOTS, micro_batch=MB,
                               device="cpu")
    else:
        stmt = parse_select(sql)
        plan = extract_kernel_plan(stmt)
        node = FusedWindowAggNode(
            "port", stmt.window, plan, [d.expr for d in stmt.dimensions],
            capacity=SLOTS, micro_batch=MB,
            direct_emit=(build_direct_emit(stmt, plan, ["deviceId"])
                         if direct else None),
            emit_columnar=columnar, device="cpu")
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
    interval = jnode._tick_interval()
    for w in range(len(batches) // per_window):
        for cols in batches[w * per_window:(w + 1) * per_window]:
            jnode.process(JaxBatch(n=ROWS, columns=dict(cols),
                                   emitter="demo"))
            tnode.process(ColumnBatch(n=ROWS, columns=dict(cols),
                                      emitter="demo"))
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
    with pytest.raises(NotImplementedError):
        plan_fused_rule("SELECT d, hll(v) AS h FROM s "
                        "GROUP BY d, TUMBLINGWINDOW(ss, 10)", device="cpu")
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
    assert kernels.LAUNCHES["groupby_fold_scalar"] == 0  # CPU: plain only


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
