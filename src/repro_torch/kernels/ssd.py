"""Chunked SSD (Mamba2's scan), forward and backward: the wrapper around
``csrc/ssd.cu``.

:func:`ssd_chunked` takes what ``models.layers._ssd_chunked_groups`` takes and
returns what it returns: x (B,S,nh,hd); B and C (B,S,G,N), head h reading group
``h // (nh / G)``; dt (B,S,nh); A_log and D (nh,); h0 optional (B,nh,hd,N) float32.
It gives y in x's type, D x included, and the final state in float32.  It is a
``torch.autograd.Function`` that saves only its inputs: the backward recomputes the
chunk states.

A CUDA tensor launches the kernels or raises.  A CPU tensor (float64 too) takes the
plain versions below, which follow the kernels' decomposition step by step, so the
tests hold the kernels' algebra against autograd of the model's plain form:

* :func:`ssd_fwd_plain`: (a) each chunk's own contribution to the state, (b) the
  states passed from chunk to chunk in order, (c) each chunk's output from its
  incoming state and its own decay-weighted scores;
* :func:`ssd_bwd_plain`: the same chunk states recomputed, each chunk's pull on its
  incoming state, the state gradients passed back in reverse, then each chunk's
  gradients; dB and dC summed over tiles of :data:`HEAD_TILE` heads of a group,
  dA_log and dD over per-(batch, chunk) partials, as the kernels sum them.

The chunk inside the kernels is :data:`CHUNK` whatever the caller's: the algebra is
exact for any chunk length, so the caller's ``chunk`` only has to be one S is a
multiple of, and S a multiple of :data:`CHUNK`.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build

#: as ``kChunk`` and ``kHeadTile`` in ``csrc/ssd.cu`` (a test holds them to it): the
#: chunk length inside the kernels, and the heads of one group a block takes
CHUNK = 64
HEAD_TILE = 8
#: the (head_dim, state) pairs compiled in, as ``SSD_SHAPES`` in ``csrc/ssd.cu``
SHAPES = ((16, 16), (32, 16), (64, 64), (64, 128), (128, 64))

#: calls made in this process on CUDA tensors: forwards (three kernels each) and
#: backwards (six kernels each); ``ops.reset_launch_counts`` zeroes them
launches = 0
bwd_launches = 0


# ------------------------------------------------------------------ plain versions

def _work(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _chunks(x, Bm, Cm, dt, A_log, chunk):
    """The per-chunk quantities both directions start from, in the working type:
    u = dt x and x (b,n,c,nh,hd), B and C per head (b,n,c,nh,N), dt (b,n,c,nh), the
    running log decay logP (b,n,c,nh) and the heads' A (nh,)."""
    Bb, S, nh, hd = x.shape
    G = Bm.shape[2]
    n, wt = S // chunk, _work(x)
    group = torch.arange(nh, device=x.device) // (nh // G)
    A = -torch.exp(A_log.to(wt))
    xc = x.to(wt).reshape(Bb, n, chunk, nh, hd)
    dtc = dt.to(wt).reshape(Bb, n, chunk, nh)
    Bh = Bm.to(wt).reshape(Bb, n, chunk, G, -1)[:, :, :, group]
    Ch = Cm.to(wt).reshape(Bb, n, chunk, G, -1)[:, :, :, group]
    logP = torch.cumsum(A * dtc, dim=2)
    return xc, dtc[..., None] * xc, Bh, Ch, dtc, logP, A


def _decay_weights(Bh, Ch, logP):
    """W[t, s] = (C_t . B_s) exp(logP_t - logP_s) for s <= t, else 0, and the decay
    L alone: (b,n,t,s,nh) each."""
    c = logP.shape[2]
    causal = torch.ones((c, c), dtype=torch.bool, device=logP.device).tril()[..., None]
    ratio = logP[:, :, :, None] - logP[:, :, None]
    L = torch.where(causal, torch.exp(torch.where(causal, ratio, 0.0)), 0.0)
    return torch.einsum("bnthk,bnshk->bntsh", Ch, Bh) * L, L


def _chunk_states(u, Bh, logP):
    """(a): each chunk's contribution to the state leaving it,
    sum_t exp(logP_last - logP_t) u_t (x) B_t, (b,n,nh,hd,N)."""
    return torch.einsum("bnthp,bnthk->bnhpk", torch.exp(logP[:, :, -1:] - logP)[..., None] * u,
                        Bh)


def _pass(first, step, parts, reverse=False):
    """(b): the states passed in order over the chunks: the state entering each
    chunk (leaving it, when ``reverse``), and the last one.  h' = step h + part."""
    n = parts.shape[1]
    h, out = first, [None] * n
    for i in (reversed(range(n)) if reverse else range(n)):
        out[i] = h
        h = step[:, i, :, None, None] * h + parts[:, i]
    return torch.stack(out, dim=1), h


def ssd_fwd_plain(x, Bm, Cm, dt, A_log, D, h0=None, chunk: int = CHUNK):
    """:func:`ssd_chunked`'s forward in the kernels' decomposition: returns
    (y in x's type, the final state in the working type)."""
    Bb, S, nh, hd = x.shape
    N = Bm.shape[-1]
    _, u, Bh, Ch, _, logP, _ = _chunks(x, Bm, Cm, dt, A_log, chunk)
    wt = u.dtype
    first = h0.to(wt) if h0 is not None else u.new_zeros((Bb, nh, hd, N))
    h_in, h_fin = _pass(first, torch.exp(logP[:, :, -1]), _chunk_states(u, Bh, logP))
    W, _ = _decay_weights(Bh, Ch, logP)
    y = torch.einsum("bnthk,bnhpk->bnthp", Ch, h_in) \
        * torch.exp(logP)[..., None] + torch.einsum("bntsh,bnshp->bnthp", W, u)
    return y.reshape(Bb, S, nh, hd).to(x.dtype) + D[None, None, :, None] * x, h_fin


def ssd_bwd_plain(x, Bm, Cm, dt, A_log, D, h0, dy, dh_fin, chunk: int = CHUNK):
    """The gradients of :func:`ssd_fwd_plain` in the kernels' order of work, from
    the output's gradient ``dy`` and the final state's ``dh_fin`` (either may be
    None: zero).  Returns (dx, dB, dC, ddt, dA_log, dD, dh0), each in its input's
    type (dh0 in the working type when there is no h0).

    Per chunk and head, with W, L as in :func:`_decay_weights`, es_t =
    exp(logP_last - logP_t), h_in / dh_out the state entering the chunk and the
    gradient of the state leaving it:

      dW = dy u^T (masked)      dS = dW L (the scores' gradient)   g = dW W
      du = W^T dy + es dh_out B^T                    dx = dt du + D dy
      dB = dS^T C + es u dh_out      dC = dS B + exp(logP) dy h_in   (over heads)
      dlogP_t = sum_s g_ts - sum_s g_st + exp(logP_t) dy_t . (h_in C_t) - q_t,
        q_t = es_t u_t . (dh_out B_t); the last row also sum_t q_t + exp(logP_last)
        <dh_out, h_in>
      da = the reverse running sum of dlogP; ddt = A da + du . x;
      dA_log = A sum dt da; dD = sum dy . x;  dh_in = exp(logP_last) dh_out +
        sum_t exp(logP_t) dy_t (x) C_t.
    """
    Bb, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    n, per = S // chunk, nh // G
    xc, u, Bh, Ch, dtc, logP, A = _chunks(x, Bm, Cm, dt, A_log, chunk)
    wt = u.dtype
    dyf = (dy.to(wt) if dy is not None else torch.zeros_like(x, dtype=wt)).reshape(u.shape)
    last = logP[:, :, -1]                                            # (b,n,nh)
    # the forward's states again, then each chunk's pull on its incoming state and
    # the gradients passed back from the end
    first = h0.to(wt) if h0 is not None else u.new_zeros((Bb, nh, hd, N))
    h_in, _ = _pass(first, torch.exp(last), _chunk_states(u, Bh, logP))
    pull = torch.einsum("bnthp,bnthk->bnhpk", torch.exp(logP)[..., None] * dyf, Ch)
    dh_end = dh_fin.to(wt) if dh_fin is not None else torch.zeros_like(first)
    dh_out, dh0 = _pass(dh_end, torch.exp(last), pull, reverse=True)

    # each chunk
    W, L = _decay_weights(Bh, Ch, logP)
    dW = torch.einsum("bnthp,bnshp->bntsh", dyf, u) * (L > 0)
    dS, g = dW * L, dW * W
    es = torch.exp(last[:, :, None] - logP)                          # (b,n,c,nh)
    du_state = es[..., None] * torch.einsum("bnthk,bnhpk->bnthp", Bh, dh_out)
    q = (u * du_state).sum(-1)
    du = du_state + torch.einsum("bntsh,bnthp->bnshp", W, dyf)
    dC_cross = torch.exp(logP)[..., None] * torch.einsum("bnthp,bnhpk->bnthk", dyf, h_in)
    dB_state = es[..., None] * torch.einsum("bnthp,bnhpk->bnthk", u, dh_out)
    dlogP = g.sum(3) - g.sum(2) + (Ch * dC_cross).sum(-1) - q
    dlogP[:, :, -1] += q.sum(2) + torch.exp(last) * (dh_out * h_in).sum((-1, -2))
    da = dlogP.flip(2).cumsum(2).flip(2)
    ddt = A * da + (du * xc).sum(-1)

    # dB and dC per group: the heads' score gradients summed over a tile of heads
    # first (C and B are the group's), then the tiles' partial sums added
    dB = torch.zeros((Bb, n, chunk, G, N), dtype=wt, device=x.device)
    dC = torch.zeros_like(dB)
    for g in range(G):
        for j in range(0, per, HEAD_TILE):
            hs = slice(g * per + j, min(g * per + j + HEAD_TILE, (g + 1) * per))
            dS_sum = dS[..., hs].sum(-1)                             # (b,n,t,s)
            dB[:, :, :, g] += torch.einsum("bnts,bntk->bnsk", dS_sum, Ch[:, :, :, g * per]) \
                + dB_state[:, :, :, hs].sum(3)
            dC[:, :, :, g] += torch.einsum("bnts,bnsk->bntk", dS_sum, Bh[:, :, :, g * per]) \
                + dC_cross[:, :, :, hs].sum(3)
    # dA_log and dD: a partial per (batch, chunk, head), then their sum
    dA_log = A * (dtc * da).sum(2).reshape(-1, nh).sum(0)
    dD = (dyf * xc).sum((2, 4)).reshape(-1, nh).sum(0)
    dx = dtc[..., None] * du + D.to(wt)[:, None] * dyf
    return (dx.reshape(x.shape).to(x.dtype), dB.reshape(Bm.shape).to(Bm.dtype),
            dC.reshape(Cm.shape).to(Cm.dtype), ddt.reshape(dt.shape).to(dt.dtype),
            dA_log.to(A_log.dtype), dD.to(D.dtype), dh0.to(h0.dtype) if h0 is not None else dh0)


# ------------------------------------------------------------------ the kernels

def _check(x, Bm, Cm, dt, A_log, D, h0, chunk) -> None:
    """Raise for what the kernels do not take (the CPU path takes any of it)."""
    if x.ndim != 4 or Bm.ndim != 4 or Cm.shape != Bm.shape or dt.ndim != 3:
        raise ValueError(f"ssd: x {tuple(x.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}, "
                         f"dt {tuple(dt.shape)}: want (B,S,nh,hd), (B,S,G,N) twice, (B,S,nh)")
    Bb, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if Bm.shape[:2] != (Bb, S) or dt.shape != (Bb, S, nh) or A_log.shape != (nh,) \
            or D.shape != (nh,) or nh % G:
        raise ValueError(f"ssd: x {tuple(x.shape)}, B {tuple(Bm.shape)}, dt "
                         f"{tuple(dt.shape)}, A_log {tuple(A_log.shape)}, D {tuple(D.shape)} "
                         "do not agree (or nh is no multiple of the groups)")
    if h0 is not None and (h0.shape != (Bb, nh, hd, N) or h0.dtype != torch.float32):
        raise ValueError(f"ssd: h0 {tuple(h0.shape)} {h0.dtype}: want {(Bb, nh, hd, N)} "
                         "float32")
    if (hd, N) not in SHAPES:
        raise ValueError(f"ssd: head_dim {hd} with state {N} is not compiled in "
                         f"(SHAPES {SHAPES})")
    if S % chunk or S % CHUNK:
        raise ValueError(f"ssd: S {S} is no multiple of the chunk {chunk} and of the "
                         f"kernels' {CHUNK}")
    for name, t in (("x", x), ("B", Bm), ("C", Cm), ("dt", dt), ("A_log", A_log), ("D", D)):
        if t.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"ssd: {name} is {t.dtype}; the kernels take float32, bfloat16 "
                            "and float16")
    if not Bm.dtype == Cm.dtype == x.dtype:
        raise TypeError(f"ssd: x {x.dtype}, B {Bm.dtype}, C {Cm.dtype}: one type for the three")


def _rows(t: torch.Tensor, inner: int) -> torch.Tensor:
    """``t`` with its last ``inner`` dims packed (strides of the first two free)."""
    want, ok = 1, True
    for d in range(t.ndim - 1, t.ndim - 1 - inner, -1):
        ok = ok and (t.shape[d] == 1 or t.stride(d) == want)
        want *= t.shape[d]
    return t if ok else t.contiguous()


def _call(x, Bm, Cm, dt, A_log, D, h0, **ptrs) -> _build.SsdCall:
    """The argument block of one call, inputs as they are (packed by ``_rows``)."""
    Bb, S, nh, hd = x.shape
    dev = x.get_device()
    dy = ptrs.pop("dy", None)
    call = _build.SsdCall(
        x=x.data_ptr(), B=Bm.data_ptr(), C=Cm.data_ptr(), dt=dt.data_ptr(),
        A_log=A_log.data_ptr(), D=D.data_ptr(), h0=h0.data_ptr() if h0 is not None else None,
        dy=dy.data_ptr() if dy is not None else None,
        stream=torch._C._cuda_getCurrentRawStream(dev), batch=Bb, seqlen=S, heads=nh,
        groups=Bm.shape[2], hd=hd, state=Bm.shape[3],
        x_sb=x.stride(0), x_ss=x.stride(1), b_sb=Bm.stride(0), b_ss=Bm.stride(1),
        c_sb=Cm.stride(0), c_ss=Cm.stride(1), dt_sb=dt.stride(0), dt_ss=dt.stride(1),
        dy_sb=dy.stride(0) if dy is not None else 0, dy_ss=dy.stride(1) if dy is not None else 0,
        x_dtype=_build.DTYPE_CODES[x.dtype], dt_dtype=_build.DTYPE_CODES[dt.dtype],
        a_dtype=_build.DTYPE_CODES[A_log.dtype], d_dtype=_build.DTYPE_CODES[D.dtype],
        device=dev)
    for name, t in ptrs.items():
        setattr(call, name, t.data_ptr() if t is not None else None)
    return call


def _inputs(x, Bm, Cm, dt):
    return _rows(x, 2), _rows(Bm, 2), _rows(Cm, 2), _rows(dt, 1)


def _scratch(x, Bm, chunks: int) -> dict:
    Bb, S, nh, hd = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    return {"states": torch.empty((Bb, chunks, nh, hd, Bm.shape[3]), **f32),
            "decay": torch.empty((Bb, chunks, nh), **f32)}


def _fwd_cuda(x, Bm, Cm, dt, A_log, D, h0):
    global launches
    x, Bm, Cm, dt = _inputs(x, Bm, Cm, dt)
    A_log, D = A_log.contiguous(), D.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    Bb, S, nh, hd = x.shape
    y = torch.empty((Bb, S, nh, hd), dtype=x.dtype, device=x.device)
    h_fin = torch.empty((Bb, nh, hd, Bm.shape[3]), dtype=torch.float32, device=x.device)
    call = _call(x, Bm, Cm, dt, A_log, D, h0, y=y, h_fin=h_fin,
                 **_scratch(x, Bm, S // CHUNK))
    code = _build.load().repro_ssd_fwd(ctypes.addressof(call))
    launches += 1
    _build.check(code, "ssd")
    return y, h_fin


def _bwd_cuda(x, Bm, Cm, dt, A_log, D, h0, dy, dh_fin):
    global bwd_launches
    x, Bm, Cm, dt = _inputs(x, Bm, Cm, dt)
    A_log, D = A_log.contiguous(), D.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    Bb, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    n, tiles = S // CHUNK, -(-(nh // G) // HEAD_TILE)
    dy = _rows(dy, 2) if dy is not None else torch.zeros_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    out = {"dx": torch.empty((Bb, S, nh, hd), dtype=x.dtype, device=x.device),
           "dB": torch.empty((Bb, S, G, N), dtype=x.dtype, device=x.device),
           "dC": torch.empty((Bb, S, G, N), dtype=x.dtype, device=x.device),
           "ddt": torch.empty((Bb, S, nh), dtype=dt.dtype, device=x.device),
           "dA_log": torch.empty((nh,), dtype=A_log.dtype, device=x.device),
           "dD": torch.empty((nh,), dtype=D.dtype, device=x.device),
           "dh0": torch.empty((Bb, nh, hd, N), **f32) if h0 is not None else None}
    call = _call(x, Bm, Cm, dt, A_log, D, h0, dy=dy,
                 dh_fin=dh_fin.contiguous() if dh_fin is not None else None,
                 dstates=torch.empty((Bb, n, nh, hd, N), **f32),
                 part_bc=torch.empty((2, tiles, Bb, S, G, N), **f32),
                 part_head=torch.empty((Bb, n, nh, 2), **f32),
                 **_scratch(x, Bm, n), **out)
    code = _build.load().repro_ssd_bwd(ctypes.addressof(call))
    bwd_launches += 1
    _build.check(code, "ssd backward")
    return tuple(out.values())


class SsdChunked(torch.autograd.Function):
    """The chunkwise SSD with its own backward; saves its inputs only."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, dt, A_log, D, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, Bm, Cm, dt, A_log, D, h0)
        ctx.chunk = chunk
        if x.is_cuda:
            return _fwd_cuda(x, Bm, Cm, dt, A_log, D, h0)
        y, h_fin = ssd_fwd_plain(x, Bm, Cm, dt, A_log, D, h0, chunk=chunk)
        return y, h_fin.to(torch.float32)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_fin):
        x, Bm, Cm, dt, A_log, D, h0 = ctx.saved_tensors
        if x.is_cuda:
            grads = _bwd_cuda(x, Bm, Cm, dt, A_log, D, h0, dy, dh_fin)
        else:
            grads = ssd_bwd_plain(x, Bm, Cm, dt, A_log, D, h0, dy, dh_fin, chunk=ctx.chunk)
        dh0 = grads[6].to(h0.dtype) if h0 is not None and grads[6] is not None else None
        return (*grads[:6], dh0, None)


def ssd_chunked(x, Bm, Cm, dt, A_log, D, h0=None, chunk: int = CHUNK):
    """The chunkwise SSD, ``models.layers._ssd_chunked_groups``'s contract: returns
    (y in x's type with D x, the final state in float32).  CUDA tensors launch the
    kernels (forward and backward) or raise; CPU tensors take the plain versions."""
    for t in (x, Bm, Cm, dt, A_log, D, h0):
        if isinstance(t, DTensor):
            raise TypeError("ssd: the kernels take plain tensors; a DTensor goes through "
                            "models.layers._local_rows_and_heads")
    if x.is_cuda:
        _check(x, Bm, Cm, dt, A_log, D, h0, chunk)
        devices = {t.device for t in (x, Bm, Cm, dt, A_log, D, h0) if t is not None}
        if len(devices) != 1:
            raise ValueError(f"ssd: inputs on {sorted(map(str, devices))}; all on one card")
    return SsdChunked.apply(x, Bm, Cm, dt, A_log, D, h0, chunk)
