"""Operator graphs and the split/fusion search vocabulary (paper §2.3, §3.2.1).

The paper formulates planning over a computational graph G_C = (V_C, E_C) of
atomic operators with data dependencies.  We provide:

  * :class:`OpNode` / :class:`OpGraph` — the DAG with per-op flops / memory
    traffic / working-set / parameter sizes (inputs to Eq. 1-2 and Eq. 6),
  * builders that expand an LLM architecture config into a graph at *layer*
    granularity (the paper's "first-level optimization": split the model
    across devices, search at the global-memory level),
  * transforms: ``split_layer`` (operator splitting), ``fuse`` (operator
    fusion, FlashAttention-style), and all-reduce decomposition helpers.

Sizes are computed for one *training step* (fwd+bwd, factor 3x fwd flops) or
one forward/decode step, from an abstract model description so that the same
builders serve all 10 assigned architectures.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Iterable, Mapping, Sequence

# ---------------------------------------------------------------------------
# Graph primitives
# ---------------------------------------------------------------------------


@dataclass
class OpNode:
    """An atomic (or fused) operator — paper §3.2.1 V_C element.

    flops         : floating point operations for one execution
    bytes_accessed: HBM traffic (reads+writes) — denominator of K (Eq. 2)
    mem_required  : working set during execution, Mem_op(v)  (Eq. 6)
    params_bytes  : resident parameter+optimizer bytes attributable to v
    out_bytes     : activation bytes produced for each consumer, Mem_data (Eq. 6)
    is_matmul     : selects MXU vs VPU roofline efficiency
    """

    name: str
    kind: str
    flops: float = 0.0
    bytes_accessed: float = 0.0
    mem_required: float = 0.0
    params_bytes: float = 0.0
    out_bytes: float = 0.0
    is_matmul: bool = True
    meta: dict = field(default_factory=dict)


@dataclass
class OpGraph:
    """DAG of operators.  Edges carry the transferred tensor size."""

    nodes: dict[str, OpNode] = field(default_factory=dict)
    edges: dict[tuple[str, str], float] = field(default_factory=dict)  # (u,v)->bytes

    # -- construction --------------------------------------------------------

    def add(self, node: OpNode) -> OpNode:
        if node.name in self.nodes:
            raise ValueError(f"duplicate op name: {node.name}")
        self.nodes[node.name] = node
        return node

    def connect(self, u: str, v: str, nbytes: float | None = None) -> None:
        if u not in self.nodes or v not in self.nodes:
            raise KeyError(f"unknown op in edge ({u}, {v})")
        self.edges[(u, v)] = self.nodes[u].out_bytes if nbytes is None else nbytes

    # -- queries --------------------------------------------------------------

    def preds(self, v: str) -> list[str]:
        return [a for (a, b) in self.edges if b == v]

    def succs(self, v: str) -> list[str]:
        return [b for (a, b) in self.edges if a == v]

    def topo_order(self) -> list[str]:
        indeg = {n: 0 for n in self.nodes}
        for (_, b) in self.edges:
            indeg[b] += 1
        frontier = sorted(n for n, d in indeg.items() if d == 0)
        order: list[str] = []
        while frontier:
            n = frontier.pop(0)
            order.append(n)
            for s in sorted(self.succs(n)):
                indeg[s] -= 1
                if indeg[s] == 0:
                    frontier.append(s)
        if len(order) != len(self.nodes):
            raise ValueError("cycle in op graph")
        return order

    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes.values())

    def total_params_bytes(self) -> float:
        return sum(n.params_bytes for n in self.nodes.values())

    def critical_path_flops(self) -> float:
        """Longest path by flops — an admissible work lower bound."""
        order = self.topo_order()
        dist = {n: 0.0 for n in order}
        for n in order:
            dist[n] = max((dist[p] for p in self.preds(n)), default=0.0) \
                + self.nodes[n].flops
        return max(dist.values()) if dist else 0.0

    # -- transforms (paper §2.3) ----------------------------------------------

    def fuse(self, names: Sequence[str], fused_name: str, *,
             traffic_discount: float = 0.5) -> "OpGraph":
        """Fuse a chain of ops into one.  Fusion removes intermediate HBM
        round-trips: the fused node keeps the summed flops but only a
        fraction of the internal memory traffic (FlashAttention effect)."""
        names = list(names)
        g = self.copy()
        members = [g.nodes[n] for n in names]
        internal = {(u, v) for (u, v) in g.edges if u in names and v in names}
        internal_bytes = sum(g.edges[e] for e in internal)
        fused = OpNode(
            name=fused_name,
            kind="fused:" + "+".join(m.kind for m in members),
            flops=sum(m.flops for m in members),
            bytes_accessed=sum(m.bytes_accessed for m in members)
            - (1.0 - traffic_discount) * 2 * internal_bytes,
            mem_required=max(m.mem_required for m in members),
            params_bytes=sum(m.params_bytes for m in members),
            out_bytes=members[-1].out_bytes,
            is_matmul=any(m.is_matmul for m in members),
            meta={"fused_from": names},
        )
        fused.bytes_accessed = max(fused.bytes_accessed, fused.out_bytes)
        # Rewire edges.
        new_edges: dict[tuple[str, str], float] = {}
        for (u, v), sz in g.edges.items():
            if (u, v) in internal:
                continue
            nu = fused_name if u in names else u
            nv = fused_name if v in names else v
            if nu != nv:
                new_edges[(nu, nv)] = max(new_edges.get((nu, nv), 0.0), sz)
        for n in names:
            del g.nodes[n]
        g.nodes[fused_name] = fused
        g.edges = new_edges
        return g

    def split_node(self, name: str, parts: int, *, axis: str = "data") -> "OpGraph":
        """Split an operator into ``parts`` equal sub-operators (paper's
        operator splitting).  Sub-ops are independent (data/tensor split) and
        inherit the parent's predecessors/successors with scaled edges."""
        if parts <= 1:
            return self.copy()
        g = self.copy()
        node = g.nodes.pop(name)
        subs = []
        for i in range(parts):
            sub = replace(
                node,
                name=f"{name}.s{i}",
                flops=node.flops / parts,
                bytes_accessed=node.bytes_accessed / parts,
                mem_required=node.mem_required / parts,
                params_bytes=node.params_bytes / parts
                if axis != "data" else node.params_bytes,
                out_bytes=node.out_bytes / parts,
                meta={**node.meta, "split_of": name, "split_axis": axis},
            )
            g.nodes[sub.name] = sub
            subs.append(sub.name)
        new_edges: dict[tuple[str, str], float] = {}
        for (u, v), sz in g.edges.items():
            if u == name:
                for s in subs:
                    new_edges[(s, v)] = sz / parts
            elif v == name:
                for s in subs:
                    new_edges[(u, s)] = sz / parts
            else:
                new_edges[(u, v)] = sz
        g.edges = new_edges
        return g

    def copy(self) -> "OpGraph":
        return OpGraph(nodes={k: replace(v, meta=dict(v.meta))
                              for k, v in self.nodes.items()},
                       edges=dict(self.edges))


# ---------------------------------------------------------------------------
# Abstract model description -> op graph
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelDesc:
    """Architecture summary sufficient for cost modelling.

    This mirrors the assigned-architecture configs (repro_torch.configs) but is
    deliberately framework-independent so the planner can also describe the
    paper's own LLaMA/GPT models.
    """

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # hybrid / ssm
    ssm_state: int = 0
    block_pattern: tuple[str, ...] = ()   # e.g. ("mamba","mamba","attn") cycle
    ffn_kind: str = "swiglu"              # swiglu | geglu | gelu (2 vs 3 matrices)
    cross_attn_every: int = 0             # VLM: cross-attn layer frequency
    encoder_layers: int = 0               # enc-dec: encoder depth
    dtype_bytes: int = 2

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    def layer_kind(self, i: int) -> str:
        if self.block_pattern:
            return self.block_pattern[i % len(self.block_pattern)]
        return "attn"

    # -- parameter counting ----------------------------------------------------

    def attn_params(self) -> int:
        d, q, kv = self.d_model, self.q_dim, self.kv_dim
        return d * q + 2 * d * kv + q * d

    def ffn_params(self) -> int:
        mats = 3 if self.ffn_kind in ("swiglu", "geglu") else 2
        return mats * self.d_model * self.d_ff

    def moe_params(self) -> int:
        return self.n_experts * self.ffn_params() + self.d_model * self.n_experts

    def ssm_params(self) -> int:
        # Mamba2-style block: in_proj (2x expand), conv, dt/A/D, out_proj.
        d, e = self.d_model, 2 * self.d_model
        return d * 2 * e + e * self.ssm_state * 2 + e + e * d

    def layer_params(self, i: int) -> int:
        kind = self.layer_kind(i)
        if kind == "mamba":
            p = self.ssm_params()
        elif kind in ("slstm", "mlstm"):
            p = self.attn_params() + self.ffn_params() if self.d_ff else \
                4 * self.d_model * self.d_model + 2 * self.d_model * 4 * self.d_model
        else:
            p = self.attn_params()
            p += self.moe_params() if self.n_experts else self.ffn_params()
        if self.cross_attn_every and (i % self.cross_attn_every ==
                                      self.cross_attn_every - 1):
            p += self.attn_params()
        return p

    def total_params(self) -> int:
        body = sum(self.layer_params(i) for i in range(self.n_layers))
        body += sum(self.attn_params() + self.ffn_params()
                    for _ in range(self.encoder_layers))
        return body + self.vocab * self.d_model  # tied embedding/lm head

    def active_params(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.total_params()
        dense = self.total_params() - self.n_layers * self.moe_params()
        return dense + self.n_layers * (self.top_k * self.ffn_params()
                                        + self.d_model * self.n_experts)


# -- per-layer cost helpers ---------------------------------------------------


def _attn_flops(m: ModelDesc, batch: int, seq: int, kv_len: int | None = None,
                *, causal: bool = True) -> float:
    kv_len = kv_len or seq
    b, d, q, kv, hd, h = batch, m.d_model, m.q_dim, m.kv_dim, m.hd, m.n_heads
    proj = 2 * b * seq * d * (q + 2 * kv) + 2 * b * seq * q * d
    score_factor = 0.5 if (causal and kv_len == seq) else 1.0
    scores = 2 * 2 * b * h * seq * kv_len * hd * score_factor
    return proj + scores


def _ffn_flops(m: ModelDesc, batch: int, seq: int) -> float:
    mats = 3 if m.ffn_kind in ("swiglu", "geglu") else 2
    return mats * 2 * batch * seq * m.d_model * m.d_ff


def _moe_flops(m: ModelDesc, batch: int, seq: int) -> float:
    router = 2 * batch * seq * m.d_model * m.n_experts
    return router + m.top_k * _ffn_flops(m, batch, seq)


def _ssm_flops(m: ModelDesc, batch: int, seq: int) -> float:
    e = 2 * m.d_model
    proj = 2 * batch * seq * m.d_model * 2 * e + 2 * batch * seq * e * m.d_model
    scan = 6 * batch * seq * e * m.ssm_state
    return proj + scan


def layer_flops(m: ModelDesc, i: int, batch: int, seq: int,
                *, kv_len: int | None = None) -> float:
    """Forward FLOPs of layer ``i`` at the given batch/seq (attention,
    FFN, SSM or hybrid per ``m.layer_kind``); ``kv_len`` prices decode
    steps against a longer KV cache."""
    kind = m.layer_kind(i)
    if kind == "mamba":
        f = _ssm_flops(m, batch, seq)
    elif kind in ("slstm", "mlstm"):
        f = _ssm_flops(m, batch, seq) if not m.d_ff else \
            _attn_flops(m, batch, seq, kv_len) + _ffn_flops(m, batch, seq)
    else:
        f = _attn_flops(m, batch, seq, kv_len)
        f += _moe_flops(m, batch, seq) if m.n_experts else _ffn_flops(m, batch, seq)
    if m.cross_attn_every and (i % m.cross_attn_every == m.cross_attn_every - 1):
        f += _attn_flops(m, batch, seq, kv_len=1576, causal=False)
    return f


# ---------------------------------------------------------------------------
# LLM graph builders
# ---------------------------------------------------------------------------


def build_llm_graph(m: ModelDesc, *, batch: int, seq: int,
                    training: bool = True,
                    granularity: str = "layer") -> OpGraph:
    """Expand an LLM into an op graph for one step.

    granularity="layer": one node per transformer layer (paper's first-level
    search space).  granularity="op": each layer split into attention + ffn
    nodes (operator splitting, used by the fusion/splitting experiments).
    Training multiplies fwd flops by 3 (bwd = 2x fwd) and adds gradient
    activation traffic.
    """
    g = OpGraph()
    db = m.dtype_bytes
    act = batch * seq * m.d_model * db
    fwd_mult = 3.0 if training else 1.0
    # optimizer-resident bytes: params (2B) + grads (2B) + adam m,v (4B fp32 x2)
    state_mult = (2 + 2 + 8) / db if training else 1.0

    embed = g.add(OpNode(
        name="embed", kind="embed",
        flops=2 * batch * seq * m.d_model,
        bytes_accessed=act * 2 + batch * seq * 4,
        mem_required=act,
        params_bytes=m.vocab * m.d_model * db * state_mult,
        out_bytes=act, is_matmul=False))

    prev = ["embed"]
    enc_out: str | None = None
    for e in range(m.encoder_layers):
        flops = (_attn_flops(m, batch, 1500, causal=False)
                 + _ffn_flops(m, batch, 1500)) * fwd_mult
        node = g.add(OpNode(
            name=f"enc{e}", kind="encoder_layer",
            flops=flops,
            bytes_accessed=3 * act + (m.attn_params() + m.ffn_params()) * db,
            mem_required=2 * act,
            params_bytes=(m.attn_params() + m.ffn_params()) * db * state_mult,
            out_bytes=act))
        g.connect(prev[0], node.name)
        prev = [node.name]
        enc_out = node.name

    body_in = "embed"
    for i in range(m.n_layers):
        pb = m.layer_params(i) * db
        flops = layer_flops(m, i, batch, seq) * fwd_mult
        traffic = 4 * act + pb
        if granularity == "op" and m.layer_kind(i) == "attn":
            a = g.add(OpNode(
                name=f"layer{i}.attn", kind="attention",
                flops=_attn_flops(m, batch, seq) * fwd_mult,
                bytes_accessed=3 * act + m.attn_params() * db
                + 2 * batch * m.n_heads * seq * seq * db,   # unfused scores
                mem_required=2 * act + batch * m.n_heads * seq * seq * db,
                params_bytes=m.attn_params() * db * state_mult,
                out_bytes=act))
            fkind = "moe_ffn" if m.n_experts else "ffn"
            fflops = (_moe_flops(m, batch, seq) if m.n_experts
                      else _ffn_flops(m, batch, seq)) * fwd_mult
            fparams = (m.moe_params() if m.n_experts else m.ffn_params()) * db
            f = g.add(OpNode(
                name=f"layer{i}.ffn", kind=fkind,
                flops=fflops,
                bytes_accessed=3 * act + (m.top_k * m.ffn_params() * db
                                          if m.n_experts else fparams),
                mem_required=2 * act,
                params_bytes=fparams * state_mult,
                out_bytes=act))
            g.connect(body_in, a.name)
            g.connect(a.name, f.name)
            body_in = f.name
        else:
            node = g.add(OpNode(
                name=f"layer{i}", kind=f"{m.layer_kind(i)}_layer",
                flops=flops, bytes_accessed=traffic,
                mem_required=2 * act, params_bytes=pb * state_mult,
                out_bytes=act))
            g.connect(body_in, node.name)
            if enc_out is not None and m.layer_kind(i) == "attn":
                g.connect(enc_out, node.name, batch * 1500 * m.d_model * db)
            body_in = node.name

    head = g.add(OpNode(
        name="lm_head", kind="lm_head",
        flops=2 * batch * seq * m.d_model * m.vocab * fwd_mult,
        bytes_accessed=act + m.vocab * m.d_model * db
        + batch * seq * m.vocab * db,
        mem_required=batch * seq * m.vocab * db,
        params_bytes=0.0,      # tied with embed
        out_bytes=batch * seq * 4))
    g.connect(body_in, "lm_head")
    return g


def layer_costs(m: ModelDesc, *, batch: int, seq: int,
                training: bool = True) -> list[float]:
    """Per-layer flops vector (embed/head excluded) — the planner's layer
    assignment works over this."""
    mult = 3.0 if training else 1.0
    return [layer_flops(m, i, batch, seq) * mult for i in range(m.n_layers)]


# ---------------------------------------------------------------------------
# Collective decomposition (paper §2.3, Fig. 3)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CommOp:
    """A communication task: ``size`` bytes among ``participants``."""

    name: str
    kind: str                       # p2p | reduce | broadcast | reduce_scatter | all_gather
    size: float
    participants: tuple[int, ...]


def allreduce_naive(name: str, size: float, ranks: Sequence[int]) -> list[CommOp]:
    """Traditional all-reduce: gather-to-root then broadcast (paper Fig. 3 left)."""
    return [CommOp(f"{name}.reduce", "reduce", size, tuple(ranks)),
            CommOp(f"{name}.bcast", "broadcast", size, tuple(ranks))]


def allreduce_decomposed(name: str, size: float,
                         ranks: Sequence[int]) -> list[CommOp]:
    """Decomposed all-reduce: reduce-scatter + all-gather (paper Fig. 3 right)."""
    return [CommOp(f"{name}.rs", "reduce_scatter", size, tuple(ranks)),
            CommOp(f"{name}.ag", "all_gather", size, tuple(ranks))]
