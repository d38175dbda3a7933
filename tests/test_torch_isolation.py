"""The port stands alone: no module of ekuiper_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package; importing the
whole port leaves both out of sys.modules; its entry point needs a card
unless the caller asks for the CPU; and a CUDA tensor handed to a kernel
wrapper launches the kernel or raises, never taking the plain version.
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
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
        lambda: kernels.groupby_fold_scalar(state, x["base"], x["V"],
                                            x["M"], x["slots"], 0, colmap),
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
        kernels.groupby_fold_scalar(state, x["base"], x["V"], x["M"],
                                    x["slots"], x["pane"],
                                    kernels.column_map({"n": [0]}))
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
        slots = torch.zeros(4, dtype=torch.int32, device="cuda")
        mask = torch.ones(1, dtype=torch.bool, device="cuda")
        out = torch.zeros((9, 8), device="cuda")
    widemap = np.array([[0, 0, 0], [1, 0, 1], [2, 0, 2]], dtype=np.int32)
    calls = [
        lambda: kernels.groupby_fold_wide(state, V, M, slots, 0, widemap),
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
