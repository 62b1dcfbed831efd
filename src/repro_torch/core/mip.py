"""LP-relaxation bound tier + exact branch-and-bound MIP oracle.

The MIP formulation of operator-level parallel planning (arxiv 2503.09357)
casts strategy selection as an integer program over stage/shard assignment;
its LP relaxation is an *admissible lower bound* on any integral schedule.
This module supplies both halves for the tiered search cascade
(:mod:`repro_torch.core.search`):

  * :func:`simplex_solve` — a dense two-phase primal simplex (numpy only,
    Bland's rule, so degenerate bases terminate) for the small LPs below;
  * :func:`lp_lower_bound` / :class:`LPBoundContext` — the per-candidate
    LP bound, slotted between ``coarse_lower_bound`` and full simulation;
  * :func:`mip_optimum` — an exact best-first branch-and-bound over the
    discrete strategy lattice using the LP relaxation at interior nodes and
    the full simulator at leaves: the certification oracle CI uses to prove
    the cascade never discards the true argmin (AMP, arxiv 2210.07297,
    takes the same bound-then-verify stance).

The LP ("class-capacity packing program")
-----------------------------------------

Fix a candidate ``(dp, tp, pp, M)``.  Any materialization partitions the
``n`` alive devices into ``G = n / tp`` synchronous TP groups (one per
(DP rank, stage) pair); the simulator prices each group's per-layer time at
the roofline of its *slowest member* (by ``peak_flops * perf_factor`` —
:func:`repro_torch.core.simulator._stage_device`), and the group is busy for all
``M`` microbatches of its stage at its rank's batch share, which can never
exceed the rank's 1F1B makespan, hence never the pipeline time.  That gives
a linear program over fractional layer->group assignment ``x``:

  minimize  T
  s.t.      sum_b x[k][b]               == w_k          (every layer placed)
            sum_k t[k][b] * x[k][b]     <= G_b * T      (bucket busy time)
            x >= 0

where layers are merged into kinds ``k`` (count ``w_k``) and group slots
into *buckets* ``b`` of identical admissible class sets: sort devices by
scalar rate; slot ``j``'s real bottleneck rate is at most the
``(j*tp)``-th fastest device's (for ANY grouping — the top-``j`` groups by
bottleneck contain ``j*tp`` devices at least that fast), so slot ``j`` may
optimistically price each layer at the cheapest roofline among classes no
faster than that — including the TP-collective floor (4 activation
all-reduces per layer per microbatch at the fabric-linearized ring cap,
:func:`repro_torch.core.costmodel.collective_floor`).  The slot rows are the
*microbatch pipeline occupancy* constraints: a slot's full-step load
(``M`` microbatches folded into the full-batch pricing) must fit inside
``T``.  Every real plan induces a feasible ``(x, pipe_time)``, so the LP
optimum undershoots the simulator; the gradient-sync ring floor (charged
after the pipeline flush, exactly as the coarse tier does) adds on top,
and the final bound takes ``max`` with the coarse bound — giving the tier
monotonicity ``point <= coarse <= lp <= simulated`` by construction.

On a heterogeneous fleet this is much tighter than the coarse bound's
min-over-classes pricing: half the slots of an 8+8 RTX4090D/V100 cluster
can only be V100-priced (unfused-attention HBM traffic included), which is
exactly the capacity the min-over-classes floor gives away.

The grouped per-variant LP
--------------------------

The packing program relaxes the device *grouping* — but the materializer
is deterministic: ``split_devices`` (speed-sorted on heterogeneous
clusters) fixes every (rank, stage) TP group, ``hetero_batch_shares`` /
the uniform override fix every rank's batch share, and the layer split is
uniform (``L // pp`` per stage minimum) unless the layer B&B runs (which
assigns at least one layer per stage).  So for a concrete ``(point,
refine)`` work item :meth:`LPBoundContext.variant_bound` prices each
(rank, stage) slot at its *actual* bottleneck device and *actual* ring
bandwidth (:func:`repro_torch.core.costmodel._bottleneck_bw` — the very numbers
the simulator will use) and solves, per rank, a small LP over fractional
layer-kind -> stage-class assignment ``z``:

  minimize  T
  s.t.      sum_c z[k][c]                    == count_k    (layers placed)
            sum_k z[k][c]                    >= n_c * fl   (split floor)
            sum_k t[k][c] * z[k][c]          <= n_c/M * T  (class busy)
            Vf * sum_{k,c} t[k][c] * z[k][c] <= T          (1F1B chain)

with ``t[k][c]`` the fwd+bwd kind time at the rank's exact microbatch.
The last row is the geometric pipeline bound: for ANY stage ``s`` of any
schedule, ``makespan >= M * t_s + sum_{s' < s} t_{s'}`` (microbatch 0
must cross every earlier stage before ``s``'s first forward; ``s``
serializes all ``M`` microbatches; the last microbatch's backward still
drains through every earlier stage afterwards — three disjoint windows).
Minimizing the max of those ``pp`` inequalities over all chain splits
gives ``makespan >= chain / (1 - (1 - 1/M)^pp) = Vf * chain``, which
dominates both the round-trip (``chain``) and busy (``M/pp * chain``)
legs.  The rank's bound is the LP optimum; the variant bound is the max
over ranks plus the gradient-sync floor, maxed with the packing bound.

Do not tighten any term toward the simulator without re-running the
admissibility property test in ``tests/test_property_planner.py``.
"""

from __future__ import annotations

import heapq
import math
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..obs import Obs, resolve_obs
from .cluster import ClusterTopology
from .costmodel import collective_floor
from .opgraph import ModelDesc
from .planner import StrategyPoint, point_lower_bound

__all__ = [
    "SimplexResult", "simplex_solve", "LPBoundContext", "lp_bound_context",
    "lp_lower_bound", "MIPResult", "mip_optimum",
]


# ---------------------------------------------------------------------------
# Dense two-phase primal simplex (stdlib + numpy, no new dependencies)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimplexResult:
    """Outcome of :func:`simplex_solve` (a minimization).

    ``status`` is ``"optimal"``, ``"infeasible"``, ``"unbounded"`` or
    ``"iteration_limit"``.  ``objective`` is ``+inf`` when infeasible and
    ``-inf`` when unbounded, so bound code can consume it directly
    (an infeasible relaxation proves the candidate cannot be scheduled —
    price it at ``inf`` and let the cascade discard it)."""

    status: str
    x: tuple[float, ...] | None
    objective: float


def _pivot(T: np.ndarray, basis: list[int], row: int, col: int) -> None:
    T[row] /= T[row, col]
    for i in range(T.shape[0]):
        if i != row and T[i, col] != 0.0:
            T[i] -= T[i, col] * T[row]
    basis[row] = col


def _run_simplex(T: np.ndarray, basis: list[int], cost: np.ndarray, *,
                 allowed: int, max_iter: int, tol: float) -> str:
    """Minimize ``cost @ x`` on the tableau ``T`` = [A | b] in place.

    Bland's smallest-index rule for both the entering and leaving choices:
    slower than Dantzig but provably cycle-free, which is what the
    degenerate-basis unit tests pin down.  ``allowed`` restricts entering
    columns (phase 2 must not re-enter artificials)."""
    m = T.shape[0]
    for _ in range(max_iter):
        # reduced costs for the current basis
        z = cost[:allowed] - cost[basis] @ T[:, :allowed]
        enter = -1
        for j in range(allowed):
            if z[j] < -tol:
                enter = j
                break
        if enter < 0:
            return "optimal"
        leave, best = -1, math.inf
        for i in range(m):
            a = T[i, enter]
            if a > tol:
                ratio = T[i, -1] / a
                if ratio < best - tol or (ratio < best + tol
                                          and (leave < 0
                                               or basis[i] < basis[leave])):
                    leave, best = i, ratio
        if leave < 0:
            return "unbounded"
        _pivot(T, basis, leave, enter)
    return "iteration_limit"


def simplex_solve(c: Sequence[float],
                  A_ub: Sequence[Sequence[float]] | None = None,
                  b_ub: Sequence[float] | None = None,
                  A_eq: Sequence[Sequence[float]] | None = None,
                  b_eq: Sequence[float] | None = None, *,
                  max_iter: int = 5000,
                  tol: float = 1e-9) -> SimplexResult:
    """Minimize ``c @ x`` subject to ``A_ub @ x <= b_ub``,
    ``A_eq @ x == b_eq`` and ``x >= 0`` via a dense two-phase tableau."""
    c = np.asarray(c, dtype=float)
    n = c.size
    rows: list[np.ndarray] = []
    rhs: list[float] = []
    slack_of_row: list[int] = []          # row index -> has a slack
    if A_ub is not None:
        A = np.asarray(A_ub, dtype=float).reshape(-1, n)
        b = np.asarray(b_ub, dtype=float).reshape(-1)
        for i in range(A.shape[0]):
            rows.append(A[i].copy())
            rhs.append(float(b[i]))
            slack_of_row.append(len(rows) - 1)
    if A_eq is not None:
        A = np.asarray(A_eq, dtype=float).reshape(-1, n)
        b = np.asarray(b_eq, dtype=float).reshape(-1)
        for i in range(A.shape[0]):
            rows.append(A[i].copy())
            rhs.append(float(b[i]))
    m = len(rows)
    if m == 0:
        if np.any(c < -tol):
            return SimplexResult("unbounded", None, -math.inf)
        return SimplexResult("optimal", tuple([0.0] * n), 0.0)
    nslack = len(slack_of_row)
    body = np.zeros((m, n + nslack))
    for i, r in enumerate(rows):
        body[i, :n] = r
    for j, r in enumerate(slack_of_row):
        body[r, n + j] = 1.0
    b_col = np.asarray(rhs, dtype=float)
    neg = b_col < 0
    body[neg] *= -1.0
    b_col = np.abs(b_col)
    # initial basis: slack columns that survived the sign flip; everything
    # else gets a phase-1 artificial
    basis = [-1] * m
    for j, r in enumerate(slack_of_row):
        if body[r, n + j] > 0 and basis[r] == -1:
            basis[r] = n + j
    need_art = [i for i in range(m) if basis[i] == -1]
    n_art = len(need_art)
    art = np.zeros((m, n_art))
    for k, i in enumerate(need_art):
        art[i, k] = 1.0
        basis[i] = n + nslack + k
    T = np.hstack([body, art, b_col.reshape(-1, 1)])
    total = n + nslack + n_art
    if n_art:
        cost1 = np.zeros(total)
        cost1[n + nslack:] = 1.0
        status = _run_simplex(T, basis, cost1, allowed=n + nslack,
                              max_iter=max_iter, tol=tol)
        if status == "iteration_limit":
            return SimplexResult("iteration_limit", None, math.nan)
        phase1 = float(cost1[basis] @ T[:, -1])
        if phase1 > math.sqrt(tol):
            return SimplexResult("infeasible", None, math.inf)
        # drive any residual (degenerate) artificial out of the basis
        for i in range(m):
            if basis[i] >= n + nslack:
                for j in range(n + nslack):
                    if abs(T[i, j]) > tol:
                        _pivot(T, basis, i, j)
                        break
        if any(v >= n + nslack for v in basis):
            # redundant row: its artificial stays at zero — harmless, but
            # it must not re-enter phase 2 (cost 0 columns guard below)
            pass
    cost2 = np.zeros(total)
    cost2[:n] = c
    status = _run_simplex(T, basis, cost2, allowed=n + nslack,
                          max_iter=max_iter, tol=tol)
    if status == "unbounded":
        return SimplexResult("unbounded", None, -math.inf)
    if status == "iteration_limit":
        return SimplexResult("iteration_limit", None, math.nan)
    x = np.zeros(total)
    for i, v in enumerate(basis):
        x[v] = T[i, -1]
    return SimplexResult("optimal", tuple(float(v) for v in x[:n]),
                         float(c @ x[:n]))


# ---------------------------------------------------------------------------
# The class-capacity packing LP (tier between coarse and simulation)
# ---------------------------------------------------------------------------


@dataclass
class LPBoundContext:
    """Per-search state for the LP tier: pricing tables shared by every
    candidate plus a per-``tp`` memo (the packing LP depends on the
    candidate only through ``tp`` — the sync floor and the coarse ``max``
    are added per point), and the measured solve wall the cascade's cost
    guard projects from."""

    topo: ClusterTopology
    model: ModelDesc
    global_batch: int
    seq: int
    bctx: object                       # repro_torch.core.search._BoundCtx
    rates: tuple[float, ...]           # alive device scalar rates, desc
    class_rate: tuple[float, ...]      # per bound-class scalar rate
    kinds: tuple[tuple[int, int], ...]  # (layer index exemplar, count)
    _tp_memo: dict[int, float] = field(default_factory=dict)
    _variant_memo: dict[tuple[StrategyPoint, bool], float] = \
        field(default_factory=dict)
    _rank_memo: dict[tuple, float] = field(default_factory=dict)
    _snap: ClusterTopology | None = None
    lp_solves: int = 0
    lp_wall: float = 0.0

    # -- cost-guard probes ---------------------------------------------------

    def would_solve(self, tp: int) -> bool:
        """True iff bounding a candidate with this ``tp`` needs a fresh
        (non-memoized) LP solve."""
        return tp not in self._tp_memo

    def solve_wall_estimate(self) -> float:
        """Measured mean wall per LP solve (a prior before the first)."""
        if self.lp_solves:
            return self.lp_wall / self.lp_solves
        return 2e-3

    # -- pricing -------------------------------------------------------------

    def _kind_time(self, layer: int, spec, perf: float, tp: int,
                   tp_coll: float) -> float:
        """Full-global-batch fwd+bwd time for one layer kind on a ``tp``
        group bottlenecked by device class ``(spec, perf)`` — mirrors the
        simulator's per-layer pricing term by term, at batch fraction 1
        (processing a fraction ``phi`` then costs at least ``phi`` times
        this: the roofline is monotone and positively homogeneous, and the
        parameter-traffic constant is paid per rank, not per fraction)."""
        b = self.bctx
        B = float(self.global_batch)
        fl = b.layer_flops1[layer] * B / tp
        traffic = (4.0 * B * b.act_per_sample
                   + b.layer_params[layer] * b.dtype_bytes) / tp
        if b.layer_is_attn[layer] and not spec.supports_fusion:
            traffic += 4.0 * B * b.n_heads * b.seq * b.seq * b.dtype_bytes \
                / tp
        return 3.0 * spec.roofline_time(fl, traffic, perf_factor=perf) \
            + tp_coll

    def packing_value(self, tp: int) -> float:
        """Admissible lower bound on *pipeline* time for every candidate
        with this ``tp`` (memoized).  See the module docstring for the
        program and its admissibility argument."""
        got = self._tp_memo.get(tp)
        if got is not None:
            return got
        t0 = time.perf_counter()
        value = self._solve_packing(tp)
        self.lp_wall += time.perf_counter() - t0
        self.lp_solves += 1
        self._tp_memo[tp] = value
        return value

    def _solve_packing(self, tp: int) -> float:
        from .search import _ring_bw
        b = self.bctx
        n = len(self.rates)
        if tp <= 0 or n < tp:
            return 0.0
        G = n // tp
        if G <= 0:
            return 0.0
        # per-layer TP-collective floor over the full step: 4 activation
        # all-reduces per layer per microbatch (2 fwd + 2 bwd), M microbatches
        # at share w summing to the full global batch — fabric-linearized
        # ring pricing shared with the coarse tier
        tp_coll = 0.0
        if tp > 1:
            bw = _ring_bw(b, tp)
            if bw > 0:
                act = float(self.global_batch) * b.act_per_sample
                tp_coll = 4.0 * collective_floor("all_reduce", act, tp, bw)
        classes = list(b.classes)
        # slot j's real bottleneck scalar rate <= rates[(j+1)*tp - 1]; the
        # admissible class set for the slot is every class at most that
        # fast.  Buckets = runs of slots with the same class set.
        order = sorted(range(len(classes)), key=lambda i: -self.class_rate[i])
        bucket_count: dict[int, int] = {}
        for j in range(G):
            rho = self.rates[(j + 1) * tp - 1]
            lo = len(order)
            for pos, ci in enumerate(order):
                if self.class_rate[ci] <= rho * (1.0 + 1e-12):
                    lo = pos
                    break
            bucket_count[lo] = bucket_count.get(lo, 0) + 1
        buckets = sorted(bucket_count)
        nb = len(buckets)
        kinds = self.kinds
        nk = len(kinds)
        # t[k][b] = cheapest admissible pricing of kind k on bucket b
        t = np.empty((nk, nb))
        for ki, (layer, _cnt) in enumerate(kinds):
            by_class = [self._kind_time(layer, *classes[ci], tp, tp_coll)
                        for ci in order]
            for bi, lo in enumerate(buckets):
                t[ki, bi] = min(by_class[lo:])
        if not np.isfinite(t).all():
            if np.isinf(t).all(axis=1).any():
                return math.inf      # some layer prices inf everywhere
            t = np.where(np.isfinite(t), t, 1e30)
        # variables: [T, x_{k,b} ...]
        nvar = 1 + nk * nb
        c = np.zeros(nvar)
        c[0] = 1.0
        A_eq = np.zeros((nk, nvar))
        b_eq = np.zeros(nk)
        for ki, (_layer, cnt) in enumerate(kinds):
            for bi in range(nb):
                A_eq[ki, 1 + ki * nb + bi] = 1.0
            b_eq[ki] = float(cnt)
        A_ub = np.zeros((nb, nvar))
        b_ub = np.zeros(nb)
        for bi, lo in enumerate(buckets):
            A_ub[bi, 0] = -float(bucket_count[lo])
            for ki in range(nk):
                A_ub[bi, 1 + ki * nb + bi] = t[ki, bi]
        res = simplex_solve(c, A_ub, b_ub, A_eq, b_eq)
        if res.status == "optimal":
            return max(0.0, res.objective)
        if res.status == "infeasible":
            return math.inf
        return 0.0                   # numerical trouble: fall back, stay sound

    # -- per-point bound -----------------------------------------------------

    def point_bound(self, point: StrategyPoint, lb2: float = 0.0) -> float:
        """The LP-tier bound for one candidate: packing LP + gradient-sync
        ring floor, maxed with the supplied coarse bound so the cascade's
        tier monotonicity ``coarse <= lp`` holds by construction."""
        from .search import _sync_floor
        lp = self.packing_value(point.tp)
        return max(lb2, lp + _sync_floor(point, self.bctx))

    # -- per-(point, refine) grouped bound -----------------------------------

    def variant_bound(self, point: StrategyPoint, refine: bool,
                      lb2: float = 0.0) -> float:
        """The LP-tier bound for one ``(point, refine)`` work item: the
        grouped per-rank LP (exact stage classes / ring bandwidths /
        batch shares — see the module docstring) maxed with
        :meth:`point_bound`, so it can only tighten the packing bound."""
        from .search import _sync_floor
        key = (point, refine)
        got = self._variant_memo.get(key)
        if got is None:
            t0 = time.perf_counter()
            got = self._grouped_value(point, refine)
            self.lp_wall += time.perf_counter() - t0
            self._variant_memo[key] = got
        base = self.point_bound(point, lb2)
        if got <= 0.0:
            return base
        return max(base, got + _sync_floor(point, self.bctx))

    def _snapshot(self) -> ClusterTopology:
        # price against the same t=0 snapshot the simulator scores plans on
        if self._snap is None:
            self._snap = self.topo.snapshot(0.0)
        return self._snap

    def _grouped_value(self, point: StrategyPoint, refine: bool) -> float:
        """Pipeline-time lower bound from the deterministic materialization
        layout (0.0 when the layout cannot be reconstructed — the caller
        falls back to the packing bound)."""
        from .costmodel import _bottleneck_bw
        from .planner import hetero_batch_shares
        from .plans import split_devices
        from .simulator import _stage_device
        dp, tp, pp, M = point.dp, point.tp, point.pp, point.microbatches
        snap = self._snapshot()
        hetero = snap.is_heterogeneous()
        try:
            groups = split_devices(snap, dp, tp, pp, sort_by_speed=hetero)
        except ValueError:
            return 0.0
        if refine and hetero and dp > 1:
            rank_devs = [[g[r * tp] for g in groups] for r in range(dp)]
            shares = hetero_batch_shares(snap, rank_devs)
        else:
            shares = tuple([1.0 / dp] * dp)
        L = self.model.n_layers
        # minimum layers per stage: the uniform split pins L // pp; the
        # layer B&B (refine on heterogeneous deep pipes) guarantees >= 1
        floor = 1 if (pp > 1 and refine and hetero) else L // pp
        Vf = 1.0 / (1.0 - (1.0 - 1.0 / M) ** pp) if M > 1 else 1.0
        worst = 0.0
        for r in range(dp):
            mb = max(self.global_batch * shares[r] / M, 1e-9)
            # stage -> pricing class: exact bottleneck device + exact ring
            classes: dict[tuple, list] = {}
            broken = False
            for s in range(pp):
                grp = tuple(groups[s][r * tp:(r + 1) * tp])
                if len(grp) < tp:
                    broken = True
                    break
                try:
                    dev = _stage_device(snap, grp)
                except ValueError:
                    broken = True
                    break
                bw = math.inf
                if tp > 1:
                    bw, _lat = _bottleneck_bw(snap, grp)
                ckey = (id(dev.spec), dev.perf_factor, bw)
                rec = classes.get(ckey)
                if rec is None:
                    classes[ckey] = [dev, bw, 1]
                else:
                    rec[2] += 1
            if broken:
                continue
            rkey = (mb, M, pp, floor,
                    tuple(sorted((k, rec[2]) for k, rec in classes.items())))
            val = self._rank_memo.get(rkey)
            if val is None:
                val = self._solve_rank(list(classes.values()), mb, tp, M,
                                       Vf, floor)
                self._rank_memo[rkey] = val
            worst = max(worst, val)
        return worst

    def _solve_rank(self, classes: list, mb: float, tp: int, M: int,
                    Vf: float, floor: int) -> float:
        """Min over fractional layer->class splits of the rank's admissible
        makespan legs (class busy, geometric 1F1B chain)."""
        b = self.bctx
        kinds = self.kinds
        nk, nc = len(kinds), len(classes)
        t = np.empty((nk, nc))
        for ci, (dev, bw, _cnt) in enumerate(classes):
            coll = 0.0
            if tp > 1:
                coll = 4.0 * collective_floor(
                    "all_reduce", mb * b.act_per_sample, tp, bw) \
                    if bw > 0 else math.inf
            for ki, (layer, _n) in enumerate(kinds):
                fl = b.layer_flops1[layer] * mb / tp
                traffic = (4.0 * mb * b.act_per_sample
                           + b.layer_params[layer] * b.dtype_bytes) / tp
                if b.layer_is_attn[layer] and not dev.spec.supports_fusion:
                    traffic += 4.0 * mb * b.n_heads * b.seq * b.seq \
                        * b.dtype_bytes / tp
                t[ki, ci] = 3.0 * dev.spec.roofline_time(
                    fl, traffic, perf_factor=dev.perf_factor) + coll
        if not np.isfinite(t).all():
            t = np.where(np.isfinite(t), t, 1e30)
        # variables: [T, z_{k,c} ...]
        nvar = 1 + nk * nc
        c = np.zeros(nvar)
        c[0] = 1.0
        A_eq = np.zeros((nk, nvar))
        b_eq = np.zeros(nk)
        for ki, (_layer, cnt) in enumerate(kinds):
            for ci in range(nc):
                A_eq[ki, 1 + ki * nc + ci] = 1.0
            b_eq[ki] = float(cnt)
        rows: list[np.ndarray] = []
        rhs: list[float] = []
        for ci, (_dev, _bw, n_c) in enumerate(classes):
            busy = np.zeros(nvar)
            busy[0] = -float(n_c) / M
            for ki in range(nk):
                busy[1 + ki * nc + ci] = t[ki, ci]
            rows.append(busy)
            rhs.append(0.0)
            if floor > 0 and nc > 1:
                low = np.zeros(nvar)
                for ki in range(nk):
                    low[1 + ki * nc + ci] = -1.0
                rows.append(low)
                rhs.append(-float(floor * n_c))
        chain = np.zeros(nvar)
        chain[0] = -1.0
        chain[1:] = Vf * t.reshape(-1)
        rows.append(chain)
        rhs.append(0.0)
        res = simplex_solve(c, rows, rhs, A_eq, b_eq)
        self.lp_solves += 1
        if res.status == "optimal":
            if res.objective >= 1e29:
                return math.inf          # some kind only prices at inf
            return max(0.0, res.objective)
        if res.status == "infeasible":
            return math.inf
        return 0.0                       # numerical trouble: stay sound


def lp_bound_context(topo: ClusterTopology, model: ModelDesc, *,
                     global_batch: int, seq: int,
                     bctx=None) -> LPBoundContext:
    """Build the LP tier's shared pricing state (one per cascade run;
    ``bctx`` lets :func:`repro_torch.core.search.score_candidates` reuse the
    coarse tier's already-built bound context)."""
    from .search import _bound_context
    if bctx is None:
        bctx = _bound_context(topo, model, seq=seq)
    # scalar ordering must match simulator._stage_device (peak * perf): the
    # slot-domination argument is stated for the rate the simulator uses to
    # pick each group's bottleneck member
    rates = tuple(sorted(
        (d.spec.peak_flops * d.perf_factor for d in topo.alive_devices),
        reverse=True))
    class_rate = tuple(spec.peak_flops * perf for spec, perf in bctx.classes)
    by_shape: dict[tuple, list[int]] = {}
    for l in range(model.n_layers):
        key = (bctx.layer_flops1[l], bctx.layer_params[l],
               bctx.layer_is_attn[l])
        by_shape.setdefault(key, []).append(l)
    kinds = tuple((layers[0], len(layers))
                  for layers in by_shape.values())
    return LPBoundContext(topo=topo, model=model, global_batch=global_batch,
                          seq=seq, bctx=bctx, rates=rates,
                          class_rate=class_rate, kinds=kinds)


def lp_lower_bound(point: StrategyPoint, topo: ClusterTopology,
                   model: ModelDesc, *, global_batch: int, seq: int,
                   refine: bool | None = None,
                   ctx: LPBoundContext | None = None) -> float:
    """LP-relaxation lower bound on the simulated step time of every
    materialization of ``point`` — by construction
    ``point_lower_bound <= coarse_lower_bound <= lp_lower_bound <= sim``.
    With ``refine`` given, the bound additionally uses the deterministic
    materialization layout of that work item (tighter; still admissible).
    Pass ``ctx`` (:func:`lp_bound_context`) when bounding many candidates
    of one search: the packing LP is memoized per ``tp`` and the grouped
    LPs per (point, refine) / rank class profile."""
    from .search import _coarse_bound
    if ctx is None:
        ctx = lp_bound_context(topo, model, global_batch=global_batch,
                               seq=seq)
    lb1 = point_lower_bound(point, topo, model, global_batch=global_batch,
                            seq=seq)
    lb2 = max(lb1, _coarse_bound(point, ctx.bctx, global_batch=global_batch))
    if refine is None:
        return ctx.point_bound(point, lb2)
    return ctx.variant_bound(point, refine, lb2)


# ---------------------------------------------------------------------------
# Exact branch-and-bound MIP oracle
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MIPResult:
    """Outcome of :func:`mip_optimum`.

    ``completed`` is the certification flag: True means the branch-and-bound
    exhausted the tree within its budgets, so ``plan`` is *provably* the
    ``(step_time, canonical index)`` argmin over the candidate lattice —
    the exact optimum the cascade must match.  With ``completed`` False the
    incumbent is only a feasible solution and certification must be
    skipped, never failed."""

    point: StrategyPoint | None
    refine: bool
    plan: object | None              # ParallelPlan
    sim: object | None               # StepSim
    step_time: float
    index: int
    completed: bool
    nodes: int
    sims: int
    lp_solves: int
    wall_s: float


def mip_optimum(topo: ClusterTopology, model: ModelDesc, *,
                global_batch: int, seq: int, gpus_per_node: int = 8,
                max_candidates: int | None = None,
                points: Sequence[StrategyPoint] | None = None,
                node_budget: int = 100_000,
                sim_budget: int | None = None,
                wall_budget_s: float | None = None,
                obs: Obs | None = None) -> MIPResult:
    """Exact best-first branch-and-bound over the strategy lattice.

    The integer variables are the parallelism degrees: the root splits on
    ``tp`` (whose subtree bound is the pure packing LP — every other choice
    relaxed), ``tp`` nodes split on ``pp`` (adding the cheapest
    gradient-sync floor the fixed ``dp = n/(tp*pp)`` admits), and leaves
    are the concrete ``(point, refine)`` candidates, bounded by the full
    :func:`lp_lower_bound` and evaluated by the same
    materialize-and-simulate pipeline the cascade uses.  Pruning is strict
    (``bound > incumbent``) and the incumbent orders by
    ``(step_time, canonical index)``, so a completed run returns the exact
    candidate the cascade's argmin must equal, byte for byte.

    ``points`` / ``max_candidates`` mirror :func:`repro_torch.core.planner
    .plan_hybrid`'s candidate-set resolution so oracle and cascade search
    the identical lattice.  Budgets (``node_budget`` LP-bounded nodes,
    ``sim_budget`` leaf simulations, ``wall_budget_s`` seconds) make the
    oracle safe on medium instances: exhausting any of them returns the
    incumbent with ``completed=False``.

    Raises RuntimeError when no leaf simulates feasibly (mirrors
    ``plan_hybrid``'s "no feasible plan found").
    """
    from .planner import DEFAULT_MAX_CANDIDATES, enumerate_strategies
    from .search import (_score_variant, _sync_floor, point_feasible)
    t0 = time.perf_counter()
    obs = resolve_obs(obs)
    if points is None:
        points, _stats = enumerate_strategies(
            topo, model, global_batch=global_batch,
            gpus_per_node=gpus_per_node)
    points = list(points)[:max_candidates if max_candidates is not None
                          else DEFAULT_MAX_CANDIDATES]
    variants = (True, False) if topo.is_heterogeneous() else (False,)
    nv = len(variants)
    lctx = lp_bound_context(topo, model, global_batch=global_batch, seq=seq)

    leaves: list[tuple[int, StrategyPoint, bool]] = []
    for pi, point in enumerate(points):
        if not point_feasible(point, topo, model, global_batch=global_batch):
            continue
        for vi, refine in enumerate(variants):
            leaves.append((pi * nv + vi, point, refine))

    by_tp: dict[int, list[tuple[int, StrategyPoint, bool]]] = {}
    for leaf in leaves:
        by_tp.setdefault(leaf[1].tp, []).append(leaf)

    # heap entries: (bound, min canonical index, seq#, kind, payload)
    heap: list = []
    tick = 0
    for tp, group in sorted(by_tp.items()):
        bound = lctx.packing_value(tp)
        heapq.heappush(heap, (bound, min(i for i, _, _ in group), tick,
                              "tp", (tp, group)))
        tick += 1

    best_step = math.inf
    best_index = -1
    best: tuple[StrategyPoint, bool, object, object] | None = None
    nodes = sims = 0
    completed = True
    memo: dict = {}
    with obs.span("search.mip", n_candidates=len(leaves)) as span:
        while heap:
            if nodes >= node_budget \
                    or (sim_budget is not None and sims >= sim_budget) \
                    or (wall_budget_s is not None
                        and time.perf_counter() - t0 > wall_budget_s):
                completed = False
                break
            bound, _minidx, _tick, kind, payload = heapq.heappop(heap)
            if bound > best_step:
                continue                      # strict: ties stay explored
            nodes += 1
            if kind == "tp":
                tp, group = payload
                by_pp: dict[int, list] = {}
                for leaf in group:
                    by_pp.setdefault(leaf[1].pp, []).append(leaf)
                for pp, sub in sorted(by_pp.items()):
                    sync = min(_sync_floor(p, lctx.bctx) for _, p, _ in sub)
                    heapq.heappush(
                        heap, (max(bound, lctx.packing_value(tp) + sync),
                               min(i for i, _, _ in sub), tick, "pp", sub))
                    tick += 1
            elif kind == "pp":
                for index, point, refine in payload:
                    lb = lp_lower_bound(point, topo, model,
                                        global_batch=global_batch, seq=seq,
                                        refine=refine, ctx=lctx)
                    heapq.heappush(heap, (lb, index, tick, "leaf",
                                          (index, point, refine)))
                    tick += 1
            else:
                index, point, refine = payload
                res = _score_variant(point, refine, topo, model,
                                     global_batch=global_batch, seq=seq,
                                     memo=memo)
                sims += 1
                if res is None:
                    continue
                plan, sim = res
                if (sim.step_time, index) < (best_step, best_index if
                                             best is not None else math.inf):
                    best_step, best_index = sim.step_time, index
                    best = (point, refine, plan, sim)
        span.set(nodes=nodes, sims=sims, completed=completed)
    obs.inc("search.mip.nodes", nodes)
    obs.inc("search.mip.sims", sims)
    if best is None:
        if not completed:
            return MIPResult(point=None, refine=False, plan=None, sim=None,
                             step_time=math.inf, index=-1, completed=False,
                             nodes=nodes, sims=sims,
                             lp_solves=lctx.lp_solves,
                             wall_s=time.perf_counter() - t0)
        raise RuntimeError("no feasible plan found")
    point, refine, plan, sim = best
    return MIPResult(point=point, refine=refine, plan=plan, sim=sim,
                     step_time=best_step, index=best_index,
                     completed=completed, nodes=nodes, sims=sims,
                     lp_solves=lctx.lp_solves,
                     wall_s=time.perf_counter() - t0)
