"""Batched homogeneous rules: one set of kernel launches serving N rules
(counterpart of ekuiper_tpu/parallel/multirule.py).

The upstream fan-out deployment runs 300 rules over one shared stream,
each rule a pipeline applying its own filter. Rules that differ only in
the numeric literals of their WHERE canonicalize to one kernel plan whose
literals become per-rule parameters, and the group-by state gains a
leading rule axis: {comp: (R, n_panes, capacity, k[, W])}. One key encode,
one upload and ONE fold launch per batch serve every rule
(`kernels.multirule_fold`, and `kernels.multirule_fold_wide` for the
sketch components hll and hist); one finalize launch (two with sketches:
`kernels.multirule_finalize`, `kernels.multirule_finalize_wide`) and one
copy per window boundary; one pane reset (`kernels.multirule_reset_pane`).

Homogeneity contract (`build_rule_batch` validates, as the reference's
does): identical SELECT fields, window, GROUP BY dims, source, HAVING and
ORDER BY; WHERE clauses structurally identical, numeric literals free to
differ per rule.

Only WHERE is canonicalized, so the spec arguments, their validity masks
and their FILTERs are the same for every rule: they are computed once per
chunk, and only the row mask after WHERE is per rule, (R, n), from the
WHERE closure with each `__param_i` bound to an (R, 1) float32 tensor of
the rules' values (the reference binds each rule's scalar under vmap; a
parameter has no validity mask, as the reference's
`c["__valid_" + name] = None`).

heavy_hitters is refused with the reference's message; per-row panes
(event-time groups) are not batched in the port yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..ops.aggspec import KernelPlan, extract_kernel_plan
from ..ops.groupby import TorchGroupBy, apply_int_semantics
from ..ops.prefinalize import PendingFinalize, begin_pending
from ..sql import ast
from ..utils.device import Device

PARAM_PREFIX = "__param_"


# ------------------------------------------------------- canonicalization
def _canonicalize_expr(expr: Optional[ast.Expr],
                       params: List[float]) -> Optional[ast.Expr]:
    """Replace numeric literals with per-rule parameter refs, appending each
    literal's value to `params` in placeholder order."""
    if expr is None:
        return None
    sub = lambda e: _canonicalize_expr(e, params)  # noqa: E731
    if isinstance(expr, (ast.IntegerLiteral, ast.NumberLiteral)):
        idx = len(params)
        params.append(float(expr.val))
        return ast.FieldRef(name=f"{PARAM_PREFIX}{idx}")
    if isinstance(expr, ast.BinaryExpr):
        return ast.BinaryExpr(expr.op, sub(expr.lhs), sub(expr.rhs))
    if isinstance(expr, ast.UnaryExpr):
        return ast.UnaryExpr(expr.op, sub(expr.expr))
    if isinstance(expr, ast.BetweenExpr):
        return ast.BetweenExpr(sub(expr.value), sub(expr.lo), sub(expr.hi),
                               expr.negate)
    if isinstance(expr, ast.CaseExpr):
        return ast.CaseExpr(
            sub(expr.value) if expr.value is not None else None,
            [ast.WhenClause(sub(w.cond), sub(w.result)) for w in expr.whens],
            sub(expr.else_expr) if expr.else_expr is not None else None,
        )
    # anything else (field refs, string/bool literals, calls, IN lists) must
    # match exactly across rules: returned as-is
    return expr


@dataclass
class RuleBatchSpec:
    """Canonical template + per-rule parameters for a homogeneous group."""

    stmt: ast.SelectStatement  # canonical statement (params substituted)
    plan: KernelPlan  # kernel plan compiled from the canonical statement
    param_names: List[str]
    params: np.ndarray  # (R, P) float32
    rule_ids: List[str]


def build_rule_batch(
    rule_ids: List[str], stmts: List[ast.SelectStatement],
) -> RuleBatchSpec:
    """Validate homogeneity and build the canonical parameterized plan.
    Raises ValueError when the statements cannot batch."""
    if not stmts:
        raise ValueError("empty rule group")
    canon_keys = []
    param_rows: List[List[float]] = []
    canon_stmt = None
    for stmt in stmts:
        params: List[float] = []
        cond = _canonicalize_expr(stmt.condition, params)
        key = (
            repr(stmt.fields), repr(stmt.window), repr(stmt.dimensions),
            repr(cond), repr(stmt.having), repr(stmt.sources),
            repr(stmt.sorts),
        )
        canon_keys.append(key)
        param_rows.append(params)
        if canon_stmt is None:
            canon_stmt = ast.SelectStatement(
                fields=stmt.fields, sources=stmt.sources, joins=stmt.joins,
                condition=cond, dimensions=stmt.dimensions,
                window=stmt.window, having=stmt.having, sorts=stmt.sorts,
                limit=stmt.limit,
            )
    if len(set(canon_keys)) != 1:
        raise ValueError(
            "rules are not homogeneous: statements must be identical up to "
            "numeric literals in WHERE")
    if len({len(p) for p in param_rows}) != 1:
        raise ValueError("rules have differing parameter counts")
    plan = extract_kernel_plan(canon_stmt)
    if plan is None:
        raise ValueError("rule group is not device-eligible")
    if any(s.kind == "heavy_hitters" for s in plan.specs):
        # hh finalize is a host-side top-k recovery, not part of the
        # batched device finalize: such rules run as individual fused nodes
        raise ValueError("heavy_hitters rules do not batch")
    n_params = len(param_rows[0])
    param_names = [f"{PARAM_PREFIX}{i}" for i in range(n_params)]
    # params are bound at fold time, not uploaded as batch columns
    plan.columns -= set(param_names)
    return RuleBatchSpec(
        stmt=canon_stmt, plan=plan, param_names=param_names,
        params=np.asarray(param_rows, dtype=np.float32).reshape(
            len(stmts), n_params),
        rule_ids=list(rule_ids),
    )


# ------------------------------------------------------------ batched state
class BatchedGroupBy(TorchGroupBy):
    """TorchGroupBy with a leading rule axis: state
    {comp: (R, n_panes, capacity, k)} (hll and hist (R, n_panes, capacity,
    k, W)), act (R, n_panes, capacity), and one launch per fold, finalize
    and pane reset for all R rules (a second fold and finalize launch for
    the sketch components). The key
    table, the batch upload and the spec closures are shared; only the
    WHERE parameters differ along the axis. The fold and the reset work in
    place, as TorchGroupBy's do; a finalize writes a fresh tensor."""

    #: a group's boundary is one stacked finalize and one copy
    supports_prefinalize = False

    def __init__(self, spec: RuleBatchSpec, capacity: int = 16384,
                 n_panes: int = 1, micro_batch: int = 4096,
                 device: Device = None) -> None:
        self.n_rules = len(spec.rule_ids)
        self.param_names = spec.param_names
        self.rule_ids = spec.rule_ids
        super().__init__(spec.plan, capacity=capacity, n_panes=n_panes,
                         micro_batch=micro_batch, device=device)
        params = torch.as_tensor(spec.params, dtype=torch.float32,
                                 device=self.device)
        #: each WHERE parameter as an (R, 1) column, bound at every fold
        self._param_cols = {name: params[:, i:i + 1].contiguous()
                            for i, name in enumerate(self.param_names)}

    def _lead(self) -> Tuple[int, ...]:
        return (self.n_rules,)

    # ------------------------------------------------------------------- fold
    def rule_inputs(self, cols: Dict[str, torch.Tensor], n: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(base (R, n), V (S, n), M (S, n)) for one chunk: each rule's row
        mask after its WHERE, and the spec values and masks every rule
        shares (computed once)."""
        c = dict(cols)
        c.update(self._param_cols)
        base = self._where(c, (self.n_rules, n))
        V, M = self._spec_values(cols, n)
        return base, V, M

    def _fold_chunk(self, state, cols, n, slots, pane, pane_vec) -> None:
        if pane_vec is not None:
            raise NotImplementedError(
                "per-row panes (sliding or event-time windows) are not "
                "batched in a rule group")
        base, V, M = self.rule_inputs(cols, n)
        kernels.multirule_fold(state, base, V, M, slots, pane, self._colmap)
        if len(self._widemap):
            kernels.multirule_fold_wide(state, base, V, M, slots, pane,
                                        self._widemap)

    # --------------------------------------------------------------- finalize
    def _slice_keys(self, n_keys: int) -> int:
        """Device-side transfer cut: round the live-key count up to a power
        of two (floor 1024) so the (R, S+1, K) result ships K≈n_keys floats
        instead of full capacity, while the shape set stays bounded."""
        if n_keys >= self.capacity:
            return self.capacity
        k = 1024
        while k < n_keys:
            k <<= 1
        return min(k, self.capacity)

    def _finalize_rules(self, state: Dict[str, torch.Tensor], n_keys: int,
                        panes: Optional[List[int]] = None) -> torch.Tensor:
        """Launch the stacked finalize: a fresh (R, S+1, K) tensor on the
        device, K = the rounded key count; the sketch specs' rows by the
        wide finalize, into the same tensor."""
        pm = self._pane_mask(panes)
        out = kernels.multirule_finalize(state, pm, self._spectab,
                                         self._slice_keys(n_keys),
                                         self._rows)
        if len(self._widetab):
            kernels.multirule_finalize_wide(state, pm, self._widetab,
                                            self._fracs, out)
        return out

    def finalize_begin(self, state: Dict[str, torch.Tensor], n_keys: int,
                       panes: Optional[List[int]] = None) -> PendingFinalize:
        """Launch the stacked finalize and start its copy to pinned host
        memory (ops/prefinalize.py's protocol: a side stream after an
        event, so a pane reset launched next cannot reach it); the async boundary hands the
        handle to the emit worker, which reads it with host_tail."""
        return begin_pending(self._finalize_rules(state, n_keys, panes),
                             None, self._fetch_pool())

    def finalize(self, state: Dict[str, torch.Tensor], n_keys: int,
                 panes: Optional[List[int]] = None
                 ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Per-spec value arrays (R, n_keys) + act (R, n_keys): ONE launch
        and ONE copy for the whole rule group."""
        out = self._finalize_rules(state, n_keys, panes)
        return self.host_tail(out.cpu().numpy(), n_keys)

    def host_tail(self, stacked: np.ndarray, n_keys: int
                  ) -> Tuple[List[np.ndarray], np.ndarray]:
        """(outs, act) of a landed (R, S+1, K) result, cut to n_keys."""
        outs = [stacked[:, i, :n_keys] for i in range(len(self.plan.specs))]
        outs = apply_int_semantics(self.plan.specs, outs)
        return outs, stacked[:, -1, :n_keys]

    # ------------------------------------------------------------------ reset
    def reset_pane(self, state: Dict[str, torch.Tensor],
                   pane_idx: int) -> Dict[str, torch.Tensor]:
        kernels.multirule_reset_pane(state, int(pane_idx))
        return state
