"""The port stands alone: no module of ekuiper_tpu_torch, and none of
its harnesses (chip_smoke.py, ab_tumbling.py, fold_routes.py), imports jax
or anything of the JAX package; importing the whole port leaves both out of sys.modules; its
entry point needs a card unless the caller asks for the CPU; and a CUDA
tensor handed to a kernel wrapper launches the kernel or raises, never
taking the plain version.
"""
import ast
import pkgutil
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import ekuiper_tpu_torch
from ekuiper_tpu_torch.ops import kernels
from ekuiper_tpu_torch.planner import fused

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ekuiper_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ekuiper_tpu")
SQL = ("SELECT deviceId, avg(temperature) AS avg_t FROM demo "
       "GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "ab_tumbling.py",
                                          ROOT / "fold_routes.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_reference():
    mods = [m.name for m in pkgutil.walk_packages(
        ekuiper_tpu_torch.__path__, "ekuiper_tpu_torch.")]
    assert "ekuiper_tpu_torch.planner.fused" in mods
    assert {"ekuiper_tpu_torch.parallel.multirule",
            "ekuiper_tpu_torch.runtime.nodes_multirule",
            "ekuiper_tpu_torch.planner.rulegroup"} <= set(mods)
    # event time's modules
    assert {"ekuiper_tpu_torch.runtime.nodes_window",
            "ekuiper_tpu_torch.utils.cron"} <= set(mods)
    # the sliding refold path's modules
    assert {"ekuiper_tpu_torch.runtime.nodes_fused",
            "ekuiper_tpu_torch.ops.groupby", "ekuiper_tpu_torch.ops.kernels",
            "ekuiper_tpu_torch.ops.slidingring"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_point_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused.plan_fused_rule(SQL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused.plan_fused_rule(SQL, device="cuda")
    node = fused.plan_fused_rule(SQL, key_slots=64, micro_batch=64,
                                 device="cpu")
    assert node.gb.device.type == "cpu"


@pytest.mark.parametrize("cls", ["TorchGroupBy", "FusedWindowAggNode"])
def test_state_classes_need_cuda_unless_cpu_is_asked(cls, monkeypatch):
    """Built directly, as a later slice builds them, neither class puts
    its state on the CPU unless the caller names the CPU."""
    from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
    from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
    from ekuiper_tpu_torch.runtime.nodes_fused import FusedWindowAggNode
    from ekuiper_tpu_torch.sql.parser import parse_select

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stmt = parse_select(SQL)
    plan = extract_kernel_plan(stmt)
    dims = [d.expr for d in stmt.dimensions]

    def build(**kw):
        if cls == "TorchGroupBy":
            return TorchGroupBy(plan, capacity=64, micro_batch=64, **kw)
        return FusedWindowAggNode("w", stmt.window, plan, dims,
                                  capacity=64, micro_batch=64, **kw).gb

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build(device="cuda")
    assert build(device="cpu").device.type == "cpu"


HH_SQL = ("SELECT deviceId, heavy_hitters(code, 3) AS top, hll(h) AS u, "
          "percentile_approx(t, 0.9) AS p FROM demo "
          "GROUP BY deviceId, HOPPINGWINDOW(ss, 10, 5)")


@pytest.mark.parametrize("entry", ["plan_fused_rule", "TorchGroupBy"])
def test_sketch_paths_need_cuda_unless_cpu_is_asked(entry, monkeypatch):
    """The sketch aggregates' paths (wide state, the hh node's smaller
    starting capacity) are as strict about the device as the scalar one."""
    from ekuiper_tpu_torch.ops.aggspec import extract_kernel_plan
    from ekuiper_tpu_torch.ops.groupby import TorchGroupBy
    from ekuiper_tpu_torch.sql.parser import parse_select

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = extract_kernel_plan(parse_select(HH_SQL))

    def build(**kw):
        if entry == "TorchGroupBy":
            return TorchGroupBy(plan, capacity=64, n_panes=2, **kw)
        return fused.plan_fused_rule(HH_SQL, micro_batch=64, **kw).gb

    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(**kw)
    gb = build(device="cpu")
    st = gb.init_state()
    assert gb.device.type == "cpu" and st["hh"].device.type == "cpu"
    assert st["hh"].shape[-1] == kernels.WIDE_W["hh"]


def _fake_cuda_inputs(bad: str = ""):
    """State and fold inputs as fake CUDA tensors (no card needed); `bad`
    spoils one of them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        state = {"n": torch.zeros((1, 8, 1), device="cuda"),
                 "act": torch.zeros((1, 8), device="cuda")}
        x = {"base": torch.ones(4, dtype=torch.bool, device="cuda"),
             "V": torch.ones((1, 4), device="cuda"),
             "M": torch.ones((1, 4), dtype=torch.bool, device="cuda"),
             "slots": torch.zeros(4, dtype=torch.int32, device="cuda"),
             "pane": 0,
             "mask": torch.ones(1, dtype=torch.bool, device="cuda")}
        if bad == "dtype":
            x["slots"] = torch.zeros(4, dtype=torch.int64, device="cuda")
        elif bad == "shape":
            x["V"] = torch.ones((1, 2), device="cuda")
        elif bad == "contiguity":
            x["V"] = torch.empty_strided((1, 4), (8, 2), device="cuda")
    if bad == "device":
        x["M"] = torch.ones((1, 4), dtype=torch.bool)
    elif bad == "pane":
        x["pane"] = 1
    return state, x


#: the widemap of a rule without sketch columns
NO_WIDE = np.zeros((0, 3), dtype=np.int32)


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card: fake CUDA tensors "
                    "would reach a real launch")


def test_cuda_tensors_never_take_the_plain_versions(monkeypatch):
    _needs_no_card()
    taken = []
    for name in ("fold_scalar_plain", "finalize_scalar_plain",
                 "reset_pane_plain"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    kernels.reset_launches()
    state, x = _fake_cuda_inputs()
    colmap = kernels.column_map({"n": [0]})
    spectab = kernels.spec_table(["count"], {"n": [0]})
    calls = [
        lambda: kernels.groupby_fold(state, x["base"], x["V"], x["M"],
                                     x["slots"], 0, colmap, NO_WIDE),
        lambda: kernels.groupby_finalize_scalar(state, x["mask"], spectab),
        lambda: kernels.groupby_reset_pane(state, 0),
    ]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr()
        for call in calls:
            # no card, no nvcc: the launch path fails, loudly
            with pytest.raises((RuntimeError, AssertionError)):
                call()
    assert taken == []
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device",
                                 "pane"])
def test_wrapper_checks_inputs(bad):
    """The wrapper refuses what the kernel does not take, before any
    build or launch."""
    _needs_no_card()
    state, x = _fake_cuda_inputs(bad)
    with pytest.raises((TypeError, ValueError)):
        kernels.groupby_fold(state, x["base"], x["V"], x["M"],
                             x["slots"], x["pane"],
                             kernels.column_map({"n": [0]}), NO_WIDE)
    assert kernels._lib is None


def test_sketch_wrappers_never_take_the_plain_versions(monkeypatch):
    """The three sketch kernels' wrappers, and the pane reset over wide
    state, given CUDA tensors: the launch path fails loudly without a
    card or nvcc, and no plain version runs."""
    _needs_no_card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    taken = []
    for name in ("fold_wide_plain", "finalize_wide_plain",
                 "hh_finalize_plain", "reset_pane_plain"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    kernels.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = {comp: torch.zeros((1, 8, 1, w), device="cuda")
                 for comp, w in kernels.WIDE_W.items()}
        state["act"] = torch.zeros((1, 8), device="cuda")
        V = torch.ones((3, 4), device="cuda")
        M = torch.ones((3, 4), dtype=torch.bool, device="cuda")
        base = torch.ones(4, dtype=torch.bool, device="cuda")
        slots = torch.zeros(4, dtype=torch.int32, device="cuda")
        mask = torch.ones(1, dtype=torch.bool, device="cuda")
        out = torch.zeros((9, 8), device="cuda")
    widemap = np.array([[0, 0, 0], [1, 0, 1], [2, 0, 2]], dtype=np.int32)
    calls = [
        lambda: kernels.groupby_fold(state, base, V, M, slots, 0,
                                     kernels.column_map({}), widemap),
        lambda: kernels.groupby_finalize_wide(
            state, mask, np.array([[0, 0, 0], [1, 0, 1]]),
            np.array([0.0, 0.5]), out),
        lambda: kernels.groupby_hh_finalize(state, mask,
                                            np.array([[0, 3, 2]]), out),
        lambda: kernels.groupby_reset_pane(state, 0),
    ]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr()
        for call in calls:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
    assert taken == []
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_prefinalize_wrappers_never_take_the_plain_versions(monkeypatch):
    """The components and absorb wrappers, given CUDA tensors: the launch
    path fails loudly without a card or nvcc, and no plain version runs;
    a shadow larger than the state is refused before any launch."""
    _needs_no_card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    taken = []
    for name in ("components_plain", "absorb_plain"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    kernels.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = {"n": torch.zeros((2, 8, 1), device="cuda"),
                 "hll": torch.zeros((2, 8, 1, kernels.WIDE_W["hll"]),
                                    device="cuda"),
                 "act": torch.zeros((2, 8), device="cuda")}
        mask = torch.ones(2, dtype=torch.bool, device="cuda")
        shadow = {"n": torch.zeros((8, 1), device="cuda"),
                  "act": torch.zeros(8, device="cuda")}
        wide = {"n": torch.zeros((16, 1), device="cuda"),
                "act": torch.zeros(16, device="cuda")}
    calls = [
        lambda: kernels.groupby_components(state, mask, ["hll", "n", "act"]),
        lambda: kernels.groupby_absorb(state, shadow, 1),
    ]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr()
        for call in calls:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
        with pytest.raises(ValueError):
            kernels.groupby_absorb(state, wide, 0)
        with pytest.raises(ValueError):
            kernels.groupby_absorb(state, shadow, 2)
    assert taken == []
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


SLIDING_SQL = ("SELECT deviceId, percentile_approx(t, 0.99) AS p99, "
               "min(t) AS mn, count(*) AS c FROM demo GROUP BY deviceId, "
               "SLIDINGWINDOW(ss, 10) OVER (WHEN t > 44.5)")


def test_sliding_rule_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """The sliding path (its ring state included) is as strict about the
    device as the others."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fused.plan_fused_rule(SLIDING_SQL, key_slots=64, **kw)
    node = fused.plan_fused_rule(SLIDING_SQL, key_slots=64, micro_batch=64,
                                 device="cpu")
    assert node.sliding_impl == "daba"
    ring = node._ring_state_now()
    assert {t.device.type for t in ring.values()} == {"cpu"}


def test_ring_wrappers_never_take_the_plain_versions(monkeypatch):
    """The three ring kernels' wrappers and the folds with a per-row pane
    vector, given CUDA tensors: the launch path fails loudly without a
    card or nvcc, and no plain version runs."""
    _needs_no_card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    taken = []
    for name in ("ring_advance_plain", "ring_flip_plain", "ring_query_plain",
                 "fold_scalar_plain", "fold_wide_plain"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    kernels.reset_launches()
    R, P, C = 3, 4, 8
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = {"n": torch.zeros((P, C, 1), device="cuda"),
                 "mn": torch.zeros((P, C, 1), device="cuda"),
                 "hist": torch.zeros((P, C, 1, kernels.WIDE_W["hist"]),
                                     device="cuda"),
                 "act": torch.zeros((P, C), device="cuda")}
        ring = {"tot_n": torch.zeros((C, 1), device="cuda"),
                "tot_hist": torch.zeros((C, 1, kernels.WIDE_W["hist"]),
                                        device="cuda"),
                "tot_act": torch.zeros(C, device="cuda"),
                "back_mn": torch.zeros((C, 1), device="cuda"),
                "front_mn": torch.zeros((R, C, 1), device="cuda")}
        V = torch.ones((1, 4), device="cuda")
        M = torch.ones((1, 4), dtype=torch.bool, device="cuda")
        base = torch.ones(4, dtype=torch.bool, device="cuda")
        slots = torch.zeros(4, dtype=torch.int32, device="cuda")
        pane_vec = torch.zeros(4, dtype=torch.uint8, device="cuda")
    comps = ["act", "hist", "n", "mn"]
    adj = (np.zeros(4, dtype=np.int32), np.zeros(4, dtype=np.float32),
           np.zeros(4, dtype=bool))
    calls = [
        lambda: kernels.ring_advance(ring, state, comps, 1, True, 2, True),
        lambda: kernels.ring_flip(ring, state, comps, np.arange(R),
                                  np.ones(R, dtype=bool)),
        lambda: kernels.ring_query(ring, state, ["hist", "mn", "n", "act"],
                                   True, True, 0, *adj),
        lambda: kernels.groupby_fold(
            state, base, V, M, slots, 0, kernels.column_map({"n": [0]}),
            kernels.wide_column_map({"hist": [0]}), pane_vec),
    ]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr()
        for call in calls:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
        # refused before any build: a pane outside the state, a front slot
        # outside the ring, a pane vector of another dtype
        with pytest.raises(ValueError):
            kernels.ring_advance(ring, state, comps, P, True, 0, False)
        with pytest.raises(ValueError):
            kernels.ring_query(ring, state, ["hist", "mn", "n", "act"],
                               True, True, R, *adj)
        with pytest.raises(TypeError):
            kernels.groupby_fold(
                state, base, V, M, slots, 0, kernels.column_map({"n": [0]}),
                NO_WIDE, pane_vec.to(torch.int32))
    assert taken == []
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


GROUP_SQL = ("SELECT deviceId, avg(t) AS a, min(t) AS mn FROM demo "
             "WHERE t > {x} GROUP BY deviceId, TUMBLINGWINDOW(ss, 10)")


def test_rule_group_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """plan_rule_group, and its group-by built directly, are as strict
    about the device as the single-rule entry point."""
    from ekuiper_tpu_torch.parallel.multirule import (BatchedGroupBy,
                                                      build_rule_batch)
    from ekuiper_tpu_torch.planner.rulegroup import plan_rule_group
    from ekuiper_tpu_torch.sql.parser import parse_select

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sqls = [GROUP_SQL.format(x=x) for x in (1, 2, 3)]
    ids = ["a", "b", "c"]
    spec = build_rule_batch(ids, [parse_select(q) for q in sqls])
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            plan_rule_group(ids, sqls, key_slots=64, **kw)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BatchedGroupBy(spec, capacity=64, **kw)
    node = plan_rule_group(ids, sqls, key_slots=64, micro_batch=64,
                           device="cpu")
    assert node.gb.device.type == "cpu"
    assert {t.device.type for t in node.gb.init_state().values()} == {"cpu"}


def test_group_wrappers_never_take_the_plain_versions(monkeypatch):
    """The rule group's three kernel wrappers, given CUDA tensors: the
    launch path fails loudly without a card or nvcc, and no plain version
    runs; a pane outside the state and a row mask of another shape are
    refused before any build."""
    _needs_no_card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    taken = []
    for name in ("multirule_fold_plain", "multirule_finalize_plain",
                 "multirule_reset_pane_plain"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    kernels.reset_launches()
    NR, P, C = 3, 2, 8
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = {"n": torch.zeros((NR, P, C, 1), device="cuda"),
                 "mn": torch.zeros((NR, P, C, 1), device="cuda"),
                 "act": torch.zeros((NR, P, C), device="cuda")}
        base = torch.ones((NR, 4), dtype=torch.bool, device="cuda")
        short = torch.ones((NR - 1, 4), dtype=torch.bool, device="cuda")
        V = torch.ones((1, 4), device="cuda")
        M = torch.ones((1, 4), dtype=torch.bool, device="cuda")
        slots = torch.zeros(4, dtype=torch.int32, device="cuda")
        mask = torch.ones(P, dtype=torch.bool, device="cuda")
    colmap = kernels.column_map({"n": [0], "mn": [0]})
    spectab = kernels.spec_table(["min"], {"n": [0], "mn": [0]})
    calls = [
        lambda: kernels.multirule_fold(state, base, V, M, slots, 1, colmap),
        lambda: kernels.multirule_finalize(state, mask, spectab, C),
        lambda: kernels.multirule_reset_pane(state, 1),
    ]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr()
        for call in calls:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
        with pytest.raises(ValueError):
            kernels.multirule_fold(state, base, V, M, slots, P, colmap)
        with pytest.raises(ValueError):
            kernels.multirule_fold(state, short, V, M, slots, 0, colmap)
        with pytest.raises(ValueError):
            kernels.multirule_finalize(state, mask, spectab, C + 1)
        with pytest.raises(ValueError):
            kernels.multirule_reset_pane(state, P)
    assert taken == []
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_event_time_rule_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """An event-time rule (its watermark node and fused node), and an
    event-time group built at the node, are as strict about the device as
    the processing-time entry points."""
    from ekuiper_tpu_torch.parallel.multirule import build_rule_batch
    from ekuiper_tpu_torch.runtime.nodes_multirule import MultiRuleFusedNode
    from ekuiper_tpu_torch.sql.parser import parse_select

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = {"isEventTime": True, "lateTolerance": "1s"}
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fused.plan_fused_rule(SQL, options=opts, **kw)
    node = fused.plan_fused_rule(SQL, key_slots=64, micro_batch=64,
                                 device="cpu", options=opts)
    assert node.gb.device.type == "cpu" and node.watermark.outputs == [node]
    sqls = [GROUP_SQL.format(x=x) for x in (1, 2, 3)]
    spec = build_rule_batch(["a", "b", "c"], [parse_select(q) for q in sqls])
    stmt = parse_select(sqls[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiRuleFusedNode("g", stmt.window, spec,
                           [d.expr for d in stmt.dimensions], capacity=64,
                           is_event_time=True)


def test_group_pane_vector_wrappers_never_take_the_plain_versions(
        monkeypatch):
    """The group folds given a per-row pane vector on CUDA tensors: no
    plain version runs and nothing is launched (the vector's range check
    reads it back from the card, which fails without one); a vector of
    another type or length is refused first."""
    _needs_no_card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    taken = []
    for name in ("multirule_fold_plain", "multirule_fold_wide_plain"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    kernels.reset_launches()
    NR, P, C = 3, 4, 8
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = {"n": torch.zeros((NR, P, C, 1), device="cuda"),
                 "hll": torch.zeros((NR, P, C, 1, 256), device="cuda"),
                 "act": torch.zeros((NR, P, C), device="cuda")}
        base = torch.ones((NR, 4), dtype=torch.bool, device="cuda")
        V = torch.ones((1, 4), device="cuda")
        M = torch.ones((1, 4), dtype=torch.bool, device="cuda")
        slots = torch.zeros(4, dtype=torch.int32, device="cuda")
        pv = torch.zeros(4, dtype=torch.uint8, device="cuda")
        pv_i32 = torch.zeros(4, dtype=torch.int32, device="cuda")
        pv_short = torch.zeros(3, dtype=torch.uint8, device="cuda")
    colmap = kernels.column_map({"n": [0]})
    widemap = kernels.wide_column_map({"hll": [0]})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr()
        for fn, cmap in ((kernels.multirule_fold, colmap),
                         (kernels.multirule_fold_wide, widemap)):
            with pytest.raises(RuntimeError):
                fn(state, base, V, M, slots, 0, cmap, pv)
            with pytest.raises(TypeError):
                fn(state, base, V, M, slots, 0, cmap, pv_i32)
            with pytest.raises(ValueError):
                fn(state, base, V, M, slots, 0, cmap, pv_short)
    assert taken == []
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
    assert kernels.ROW_PANE_LAUNCHES == dict.fromkeys(
        kernels.ROW_PANE_LAUNCHES, 0)


def test_group_wide_wrappers_never_take_the_plain_versions(monkeypatch):
    """The sketch group's wide fold and finalize wrappers, given CUDA
    tensors: the launch path fails loudly without a card or nvcc, and no
    plain version runs; a heavy-hitters column, a pane outside the state,
    a row mask of another shape and a result of another rule count are
    refused before any build."""
    _needs_no_card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    taken = []
    for name in ("multirule_fold_wide_plain",
                 "multirule_finalize_wide_plain"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    kernels.reset_launches()
    NR, P, C = 3, 2, 8
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = {"hll": torch.zeros((NR, P, C, 1, 256), device="cuda"),
                 "hist": torch.zeros((NR, P, C, 1, 1024), device="cuda"),
                 "act": torch.zeros((NR, P, C), device="cuda")}
        base = torch.ones((NR, 4), dtype=torch.bool, device="cuda")
        short = torch.ones((NR - 1, 4), dtype=torch.bool, device="cuda")
        V = torch.ones((2, 4), device="cuda")
        M = torch.ones((2, 4), dtype=torch.bool, device="cuda")
        slots = torch.zeros(4, dtype=torch.int32, device="cuda")
        mask = torch.ones(P, dtype=torch.bool, device="cuda")
        out = torch.zeros((NR, 3, C), device="cuda")
        out_short = torch.zeros((NR - 1, 3, C), device="cuda")
    widemap = kernels.wide_column_map({"hll": [0], "hist": [1]})
    widetab = np.array([[kernels.WIDE_KIND_IDS["hll"], 0, 0],
                        [kernels.WIDE_KIND_IDS["percentile_approx"], 0, 1]],
                       dtype=np.int32)
    fracs = np.array([0.0, 0.5], dtype=np.float32)
    calls = [
        lambda: kernels.multirule_fold_wide(state, base, V, M, slots, 1,
                                            widemap),
        lambda: kernels.multirule_finalize_wide(state, mask, widetab, fracs,
                                                out),
    ]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr()
        for call in calls:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
        with pytest.raises(ValueError):
            kernels.multirule_fold_wide(
                state, base, V, M, slots, 0,
                kernels.wide_column_map({"hh": [0]}))
        with pytest.raises(ValueError):
            kernels.multirule_fold_wide(state, base, V, M, slots, P, widemap)
        with pytest.raises(ValueError):
            kernels.multirule_fold_wide(state, short, V, M, slots, 0,
                                        widemap)
        with pytest.raises(ValueError):
            kernels.multirule_finalize_wide(state, mask, widetab, fracs,
                                            out_short)
    assert taken == []
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


REFOLD_SQL = ("SELECT deviceId, heavy_hitters(code, 3) AS top, count(*) AS c "
              "FROM demo GROUP BY deviceId, SLIDINGWINDOW(ss, 10) "
              "OVER (WHEN t > 44.5)")


@pytest.mark.parametrize("options", [{}, {"slidingImpl": "refold"},
                                     {"slidingDevRingMb": 0}],
                         ids=["heavy_hitters", "requested", "budget"])
def test_refold_rule_needs_cuda_unless_cpu_is_asked(options, monkeypatch):
    """The sliding refold path (its device batch cache included) is as
    strict about the device as the others, whichever case plans it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sql = REFOLD_SQL if not options else SLIDING_SQL
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fused.plan_fused_rule(sql, key_slots=64, options=options, **kw)
    node = fused.plan_fused_rule(sql, key_slots=64, micro_batch=64,
                                 device="cpu", options=options)
    assert node.sliding_impl == "refold"
    cols = {name: np.zeros(64, dtype=np.float32) for name in node.plan.columns}
    dev = node._upload_sliding_inputs(cols, {}, np.zeros(64, np.int32))
    assert {t.device.type for t in dev[3].values() if t is not None} \
        == {"cpu"}
    assert dev[2].dtype == torch.uint16 and dev[2].device.type == "cpu"


@pytest.mark.parametrize("slot_dtype", [torch.uint16, torch.int32])
def test_masked_fold_wrappers_never_take_the_plain_versions(slot_dtype,
                                                            monkeypatch):
    """The masked fold's wrapper (#2) and the fold (#1) on uint16 slots,
    given CUDA tensors: the launch path fails loudly without a card or
    nvcc, and no plain version runs; slots of another dtype, a row mask of
    another shape or dtype and a pane outside the state are refused before
    any build."""
    _needs_no_card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    taken = []
    for name in ("fold_plain", "fold_scalar_plain", "fold_wide_plain"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    kernels.reset_launches()
    P, C = 3, 8
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = {"n": torch.zeros((P, C, 1), device="cuda"),
                 "hh": torch.zeros((P, C, 1, kernels.WIDE_W["hh"]),
                                   device="cuda"),
                 "act": torch.zeros((P, C), device="cuda")}
        mask = torch.ones(4, dtype=torch.bool, device="cuda")
        V = torch.ones((1, 4), device="cuda")
        M = torch.ones((1, 4), dtype=torch.bool, device="cuda")
        slots = torch.zeros(4, dtype=slot_dtype, device="cuda")
        wrong = {"slots": torch.zeros(4, dtype=torch.int64, device="cuda"),
                 "mask": torch.ones(3, dtype=torch.bool, device="cuda"),
                 "mask_dtype": torch.ones(4, dtype=torch.uint8,
                                          device="cuda")}
    colmap = kernels.column_map({"n": [0]})
    widemap = kernels.wide_column_map({"hh": [0]})
    calls = [
        lambda: kernels.groupby_fold_masked(state, mask, V, M, slots, P - 1,
                                            colmap, widemap),
        lambda: kernels.groupby_fold_masked(state, mask, V, M, slots, P - 1,
                                            colmap, NO_WIDE),
        lambda: kernels.groupby_fold(state, mask, V, M, slots, 0, colmap,
                                     widemap),
        lambda: kernels.groupby_fold(state, mask, V, M, slots, P - 1,
                                     colmap, widemap),
    ]
    fn = kernels.groupby_fold_masked
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr()
        for call in calls:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
        for cmap, wmap in ((colmap, NO_WIDE), (NO_WIDE, widemap)):
            with pytest.raises(TypeError):
                fn(state, mask, V, M, wrong["slots"], 0, cmap, wmap)
            with pytest.raises(ValueError):
                fn(state, wrong["mask"], V, M, slots, 0, cmap, wmap)
            with pytest.raises(TypeError):
                fn(state, wrong["mask_dtype"], V, M, slots, 0, cmap, wmap)
            with pytest.raises(ValueError):
                fn(state, mask, V, M, slots, P, cmap, wmap)
    assert taken == []
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_tiered_rule_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """The tiered key state (its touch column, demote and promote) is as
    strict about the device as the other paths."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = {"tierHotMb": 1, "tierStore": "on"}
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fused.plan_fused_rule(SQL, key_slots=65536, options=opts, **kw)
    node = fused.plan_fused_rule(SQL, key_slots=65536, device="cpu",
                                 options=opts)
    assert node.tier is not None
    state = node.gb.init_state()
    assert state["touch"].device.type == "cpu"


def test_tier_wrappers_never_take_the_plain_versions(monkeypatch):
    """tier_demote and tier_promote (and the fold with a touch column)
    given CUDA tensors: the launch path fails loudly without a card or
    nvcc, and no plain version runs; slots of another dtype, a packed
    block of another width or with fewer rows than the real count, a touch
    column of another dtype and a real row count past the block are
    refused before any build."""
    _needs_no_card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    taken = []
    for name in ("tier_demote_plain", "tier_promote_plain",
                 "fold_scalar_plain", "fold_plain"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    kernels.reset_launches()
    P, C, D = 2, 8, 4
    comps = ["n", "act"]
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = {"n": torch.zeros((P, C, 1), device="cuda"),
                 "act": torch.zeros((P, C), device="cuda"),
                 "touch": torch.zeros(C, dtype=torch.uint32, device="cuda")}
        slots = torch.zeros(D, dtype=torch.int32, device="cuda")
        packed = torch.zeros((D, 2 * P), device="cuda")
        V = torch.ones((1, D), device="cuda")
        M = torch.ones((1, D), dtype=torch.bool, device="cuda")
        base = torch.ones(D, dtype=torch.bool, device="cuda")
        wrong = {"slots": torch.zeros(D, dtype=torch.int64, device="cuda"),
                 "packed": torch.zeros((D, 3), device="cuda"),
                 "short": torch.zeros((1, 2 * P), device="cuda"),
                 "touch": torch.zeros(C, dtype=torch.int32, device="cuda")}
    colmap = kernels.column_map({"n": [0]})
    calls = [
        lambda: kernels.tier_demote(state, slots, 2, comps),
        lambda: kernels.tier_promote(state, packed, slots, 2, D, comps),
        lambda: kernels.groupby_fold(state, base, V, M, slots, 0, colmap,
                                     NO_WIDE),
        lambda: kernels.groupby_fold_masked(state, base, V, M, slots, 1,
                                            colmap, NO_WIDE),
    ]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr()
        for call in calls:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
        with pytest.raises(TypeError):
            kernels.groupby_fold_masked(
                {**state, "touch": wrong["touch"]}, base, V, M, slots, 0,
                colmap, NO_WIDE)
        with pytest.raises(TypeError):
            kernels.tier_demote(state, wrong["slots"], 2, comps)
        with pytest.raises(ValueError):
            kernels.tier_demote(state, slots, D + 1, comps)
        with pytest.raises(ValueError):
            kernels.tier_promote(state, wrong["packed"], slots, 2, D, comps)
        with pytest.raises(ValueError):
            kernels.tier_promote(state, packed, slots, D + 1, D, comps)
        with pytest.raises(ValueError):
            kernels.tier_promote(state, wrong["short"], slots, 2, D, comps)
        with pytest.raises(TypeError):
            kernels.tier_promote(state, packed, wrong["slots"], 2, D, comps)
        with pytest.raises(TypeError):
            kernels.tier_demote({**state, "touch": wrong["touch"]}, slots,
                                2, comps)
        with pytest.raises(TypeError):
            kernels.groupby_fold({**state, "touch": wrong["touch"]}, base, V,
                                 M, slots, 0, colmap, NO_WIDE)
    assert taken == []
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
    assert kernels._lib is None


def test_count_min_sketch_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from ekuiper_tpu_torch.ops.sketches import CountMinSketch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CountMinSketch(**kw)
    assert CountMinSketch(device="cpu").counts.device.type == "cpu"


def test_countmin_wrappers_never_take_the_plain_versions(monkeypatch):
    """cms_update and cms_query given CUDA tensors: the launch path fails
    loudly without a card or nvcc, and no plain version runs; values of
    another dtype or shape, counts of another rank and a side on another
    device are refused before any build."""
    _needs_no_card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    taken = []
    for name in ("cms_update_plain", "cms_query_plain"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    kernels.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=True):
        counts = torch.zeros((4, 1000), device="cuda")
        values = torch.zeros(16, device="cuda")
        wrong = {"dtype": torch.zeros(16, dtype=torch.float64,
                                      device="cuda"),
                 "shape": torch.zeros((4, 4), device="cuda"),
                 "rank": torch.zeros(4000, device="cuda")}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr()
        for fn in (kernels.cms_update, kernels.cms_query):
            with pytest.raises((RuntimeError, AssertionError)):
                fn(counts, values)
            with pytest.raises(TypeError):
                fn(counts, wrong["dtype"])
            with pytest.raises(ValueError):
                fn(counts, wrong["shape"])
            with pytest.raises(ValueError):
                fn(wrong["rank"], values)
            with pytest.raises(ValueError):
                fn(counts, torch.zeros(16))
    assert taken == []
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


JOIN_SQL = ("SELECT l.v, r.w FROM l INNER JOIN r ON l.k = r.k "
            "AND l.ts - r.ts >= -5 AND l.ts - r.ts <= 5 AND l.v > r.w "
            "GROUP BY TUMBLINGWINDOW(ss, 10)")
LAG_SQL = ("SELECT deviceId, lag(t) OVER (PARTITION BY deviceId) AS p "
           "FROM demo")
RANK_SQL = ("SELECT deviceId, rank(t) OVER (PARTITION BY deviceId) AS rk "
            "FROM demo GROUP BY TUMBLINGWINDOW(ss, 10)")


@pytest.mark.parametrize("sql", [JOIN_SQL, LAG_SQL, RANK_SQL])
def test_host_rule_needs_cuda_unless_cpu_is_asked(sql, monkeypatch):
    """plan_host_rule, and the join ring and segscan built directly, are as
    strict about the device as the other entry points; on the CPU the
    relational nodes take the device classes with CPU tensors."""
    from ekuiper_tpu_torch.ops.joinring import JoinRing
    from ekuiper_tpu_torch.ops.segscan import SegScan
    from ekuiper_tpu_torch.planner.planner import plan_host_rule

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            plan_host_rule(sql, **kw)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            JoinRing(**kw)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SegScan(**kw)
    rule = plan_host_rule(sql, device="cpu")
    names = {type(n).__name__ for n in rule.nodes.values()}
    assert names & {"DeviceJoinNode", "DeviceAnalyticNode",
                    "VectorWindowFuncNode"}
    join = rule.nodes.get("join")
    if join is not None:
        assert join.ring.device.type == "cpu"
    assert SegScan(device="cpu")._carry[0].device.type == "cpu"


def test_relational_wrappers_never_take_the_plain_versions(monkeypatch):
    """join_match, segscan_shift and segscan_sort given CUDA tensors: the
    launch path fails loudly without a card or nvcc, and no plain version
    runs; a length that is not a power of two, a side or a carry of
    another dtype and a residual that does not broadcast are refused
    before any build."""
    _needs_no_card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    taken = []
    for name in ("join_match_plain", "segscan_shift_plain",
                 "segscan_sort_plain"):
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    kernels.reset_launches()
    PL, PR, B, C = 8, 4, 8, 16
    with FakeTensorMode(allow_non_fake_inputs=True):
        def side(n):
            return (torch.zeros(n, dtype=torch.int32, device="cuda"),
                    torch.zeros(n, dtype=torch.int32, device="cuda"),
                    torch.ones(n, dtype=torch.bool, device="cuda"))

        left, right = side(PL), side(PR)
        resid = torch.ones((PL, 1), dtype=torch.bool, device="cuda")
        bad_resid = torch.ones((PL, 3), dtype=torch.bool, device="cuda")
        carry = (torch.zeros(C, dtype=torch.int32, device="cuda"),
                 torch.zeros(C, device="cuda"),
                 torch.zeros(C, dtype=torch.bool, device="cuda"),
                 torch.zeros(C, device="cuda"))
        seg = torch.zeros(B, dtype=torch.int32, device="cuda")
        vals = torch.zeros(B, device="cuda")
        valid = torch.ones(B, dtype=torch.bool, device="cuda")
        odd = torch.zeros(6, dtype=torch.int32, device="cuda")
        odd_vals = torch.zeros(6, device="cuda")
        odd_valid = torch.ones(6, dtype=torch.bool, device="cuda")
        seg64 = torch.zeros(B, dtype=torch.int64, device="cuda")
        cnt64 = torch.zeros(C, dtype=torch.int64, device="cuda")
    calls = [
        lambda: kernels.join_match(*left, *right, -5, 5),
        lambda: kernels.join_match(*left, *right, -5, 5, resid),
        lambda: kernels.segscan_shift(carry, seg, vals, valid),
        lambda: kernels.segscan_sort(seg, vals, valid),
    ]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fake data_ptr()
        for call in calls:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
        with pytest.raises(ValueError):
            kernels.join_match(odd, *left[1:], *right, -5, 5)
        with pytest.raises(ValueError):
            kernels.join_match(*left, *right, -5, 5, bad_resid)
        with pytest.raises(ValueError):
            kernels.join_match(*left, *right, -5, 1 << 31)
        with pytest.raises(TypeError):
            kernels.segscan_sort(seg64, vals, valid)
        with pytest.raises(ValueError):
            kernels.segscan_sort(odd, odd_vals, odd_valid)
        with pytest.raises(TypeError):
            kernels.segscan_shift((cnt64, *carry[1:]), seg, vals, valid)
    assert taken == []
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
    assert kernels._lib is None
