"""Sequence-parallel (context-parallel) first-order scan across ranks.

Counterpart of ``ceigm_unet_tpu/parallel/ring_scan.py``. The combine of
h_t = a_t * h_{t-1} + b_t is associative, so the sequence axis can be
sharded exactly: each shard scans locally, the shards exchange their
(total decay, final state) pair, and each shard folds in the exclusive
prefix of its predecessors. The JAX package does this under ``shard_map``
over a mesh axis; here the shards live on the ranks of a process group
(:func:`sequence_parallel_scan`), or stacked on a leading axis of one
tensor in one process (:func:`stacked_ring_scan`), which runs the same
arithmetic, so an n-shard ring runs on one card.

Every local scan is :func:`scan_rows` (K11, ``csrc/scan_rows.cu`` on the
card; its plain version on the CPU): a shard's carried-in state folds into
its first drive element, b_0 + a_0 * h_in, and the shard scans again, so
the forward takes two local scans and the backward two more.

The backward is the JAX package's adjoint: the scan in the other direction
of the successor-shifted decay a_{t+1} driven by the cotangent, with the
one-element global shifts exchanged between neighbouring shards.

The two shard forms also carry the exchanges of the H-sharded model
(``parallel/sp_ops.py``, ``parallel/sp_ss2d.py``): ``swap_edges`` (rows to
the shards 1, 2, ... before and after), ``all_to_all`` (one block of rows to
each shard), ``sum_shards`` (a sum over the shards, on every shard),
``gather`` (every shard's tensor on every shard; on a group its adjoint is
``reduce_scatter``) and ``spread`` (a value reduced from it, on each
shard). A
ring's ``lead`` views the model's batch axis as the shards' leading axes:
() on a group's rank, (n,) for stacked shards, which ride in the batch axis
as (n*B, ...).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ceigm_unet_tpu_torch.ops.selective_scan import _bc4, _prep, scan_rows
from ceigm_unet_tpu_torch.parallel import mesh


class _GroupRing:
    """Shards on the ranks of ``group``, each holding (..., L/N)."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.idx = dist.get_rank(group)

    def gather(self, s):
        return mesh.all_gather(s, self.group)

    def pick(self, per_shard):
        return per_shard[self.idx]

    def _p2p(self, sends, recvs) -> None:
        """Post each (tensor, shard) send and receive whose shard exists
        in one ``batch_isend_irecv``, and wait for them."""
        peer = lambda i: dist.get_global_rank(self.group, i)
        ops = [dist.P2POp(dist.isend, t.contiguous(), peer(i), self.group)
               for t, i in sends if 0 <= i < self.n]
        ops += [dist.P2POp(dist.irecv, t, peer(i), self.group)
                for t, i in recvs if 0 <= i < self.n]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def neighbour(self, edge, fill: float, successor: bool):
        """The edge of shard idx + 1 (``successor``) or idx - 1 on this
        rank; ``fill`` where there is none."""
        step = 1 if successor else -1
        got = torch.full_like(edge, fill)
        self._p2p([(edge, self.idx - step)], [(got, self.idx + step)])
        return got

    def swap_edges(self, to_pred, to_succ):
        """Rows to the shards h = 1, 2, ... away, in one batch:
        ``to_pred[h - 1]`` goes to shard idx - h and ``to_succ[h - 1]`` to
        idx + h. Returns (from_pred, from_succ): ``from_pred[h - 1]`` is
        what shard idx - h sent in its ``to_succ[h - 1]``, ``from_succ[h -
        1]`` what shard idx + h sent in its ``to_pred[h - 1]``; zeros where
        there is no such shard."""
        from_pred = [t.new_zeros(t.shape) for t in to_succ]
        from_succ = [t.new_zeros(t.shape) for t in to_pred]
        hops = lambda ts, step: [(t, self.idx + step * h)
                                 for h, t in enumerate(ts, 1)]
        self._p2p(hops(to_pred, -1) + hops(to_succ, 1),
                  hops(from_pred, -1) + hops(from_succ, 1))
        return from_pred, from_succ

    def sum_shards(self, t):
        """The sum of every shard's t, on this rank (outside autograd)."""
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def spread(self, t):
        """A value every shard computed alike, as this rank holds it."""
        return t

    def reduce_scatter(self, g):
        """The adjoint of :meth:`gather`: g (n, ...) on every rank -> the
        sum over the ranks of their g[idx]."""
        out = torch.empty_like(g[0])
        dist.reduce_scatter(out, [p.contiguous() for p in g.unbind(0)],
                            group=self.group)
        return out

    def lead(self, t):
        return t

    def unlead(self, t):
        return t

    def all_to_all(self, t):
        """(n, ...): row j goes to shard j; row i of the result is the row
        shard i sent to this one (``all_to_all_single``, which splits dim
        0)."""
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out


class _StackedRing:
    """n shards stacked on the leading axis: (n, ..., L/n)."""

    def __init__(self, n: int):
        self.n = n

    def gather(self, s):
        return s

    def pick(self, per_shard):
        return per_shard

    def neighbour(self, edge, fill: float, successor: bool):
        pad = torch.full_like(edge[:1], fill)
        if successor:
            return torch.cat([edge[1:], pad])
        return torch.cat([pad, edge[:-1]])

    def swap_edges(self, to_pred, to_succ):
        def shift(t, h, down):
            if h >= self.n:
                return torch.zeros_like(t)
            pad = torch.zeros_like(t[:h])
            return torch.cat([pad, t[:-h]]) if down else torch.cat([t[h:],
                                                                    pad])
        return ([shift(t, h, True) for h, t in enumerate(to_succ, 1)],
                [shift(t, h, False) for h, t in enumerate(to_pred, 1)])

    def sum_shards(self, t):
        return t.sum(0, keepdim=True).expand_as(t)

    def spread(self, t):
        """(...) -> (n, ...): a value every shard computed alike, on each
        shard."""
        return t.expand(self.n, *t.shape)

    def lead(self, t):
        """(n*B, ...) -> (n, B, ...)."""
        return t.unflatten(0, (self.n, -1))

    def unlead(self, t):
        return t.flatten(0, 1)

    def all_to_all(self, t):
        """(n_to, n_from, ...) -> (n_from, n_to, ...): the group form's
        exchange, with the shard axis (axis 1 on entry) moved to axis 1
        of the result."""
        return t.transpose(0, 1)


def _exclusive_prefix(summ: torch.Tensor, reverse: bool) -> torch.Tensor:
    """(n, ..., 2) shards' (total decay, final state), in shard order ->
    (n, ...) the state each shard receives from the shards the scan visits
    before it."""
    n = summ.shape[0]
    h = torch.zeros_like(summ[0, ..., 1])
    out = [h] * n
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        out[i] = h
        h = summ[i, ..., 0] * h + summ[i, ..., 1]
    return torch.stack(out)


def _ring_scan(a, b, ring, reverse: bool) -> torch.Tensor:
    """The global scan's shard (outside autograd)."""
    if reverse:
        a, b = a.flip(-1), b.flip(-1)
    h = scan_rows(a, b)
    summ = ring.gather(torch.stack([a.prod(-1), h[..., -1]], -1))
    h_in = ring.pick(_exclusive_prefix(summ, reverse))
    b = b.clone()
    b[..., 0] += a[..., 0] * h_in
    h = scan_rows(a, b)
    return h.flip(-1) if reverse else h


def _shift(x, ring, successor: bool, fill: float) -> torch.Tensor:
    """One-element global shift along the sharded last axis: x'_t =
    x_{t+1} (``successor``) or x_{t-1}, ``fill`` at the global end."""
    if successor:
        edge = ring.neighbour(x[..., :1], fill, successor=True)
        return torch.cat([x[..., 1:], edge], -1)
    edge = ring.neighbour(x[..., -1:], fill, successor=False)
    return torch.cat([edge, x[..., :-1]], -1)


class _RingScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b, ring, reverse):
        h = _ring_scan(a, b, ring, reverse)
        ctx.save_for_backward(a, h)
        ctx.ring, ctx.reverse = ring, reverse
        return h

    @staticmethod
    def backward(ctx, gh):
        """Adjoint of h_t = a_t h_prev(t) + b_t over the global order: g =
        the scan in the other direction of (a successor-shifted, gh); da_t =
        g_t h_prev(t), db_t = g_t."""
        a, h = ctx.saved_tensors
        ring, reverse = ctx.ring, ctx.reverse
        a_next = _shift(a, ring, successor=not reverse, fill=1.0)
        g = _ring_scan(a_next, gh.float(), ring, not reverse)
        h_prev = _shift(h, ring, successor=reverse, fill=0.0)
        return g * h_prev, g, None, None


def _check(a, b):
    if a.shape != b.shape or a.dtype != torch.float32 \
            or b.dtype != torch.float32:
        raise ValueError(f"ring scan: takes float32 a and b of one shape, "
                         f"got {a.dtype} {tuple(a.shape)}, {b.dtype} "
                         f"{tuple(b.shape)}")


def sequence_parallel_scan(a: torch.Tensor, b: torch.Tensor,
                           group: Optional[dist.ProcessGroup] = None,
                           reverse: bool = False) -> torch.Tensor:
    """Exact distributed scan h_t = a_t h_{t-1} + b_t over the last axis,
    sharded in rank order over ``group`` (the active group by default).

    a, b: this rank's fp32 shard (..., L_local). Returns this rank's shard
    of the global inclusive scan. ``reverse`` scans the global sequence
    back to front. Differentiable in a and b; every rank of the group calls
    it, and its backward, together."""
    group = group or mesh.active_group()
    if group is None:
        raise RuntimeError("sequence_parallel_scan: no process group (see "
                           "parallel.init_data_parallel)")
    _check(a, b)
    return _RingScan.apply(a, b, _GroupRing(group), reverse)


def stacked_ring_scan(a: torch.Tensor, b: torch.Tensor,
                      reverse: bool = False) -> torch.Tensor:
    """:func:`sequence_parallel_scan`'s arithmetic on n shards stacked on
    the leading axis of one tensor: a, b (n, ..., L/n) -> h (n, ..., L/n),
    shard i holding elements [i L/n, (i+1) L/n) of the global scan (see
    :func:`to_shards`). Differentiable."""
    _check(a, b)
    return _RingScan.apply(a, b, _StackedRing(a.shape[0]), reverse)


def to_shards(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., L) -> (n, ..., L/n): the last axis cut into n shards."""
    if x.shape[-1] % n:
        raise ValueError(f"to_shards: {n} shards do not divide L "
                         f"{x.shape[-1]}")
    return x.unflatten(-1, (n, x.shape[-1] // n)).movedim(-2, 0)


def from_shards(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_shards`."""
    return x.movedim(0, -2).flatten(-2)


def selective_scan_ring(u, delta, A, B4, C4, D, delta_bias,
                        delta_softplus: bool, ring,
                        reverse: bool) -> torch.Tensor:
    """:func:`selective_scan_sp`'s arithmetic over ``ring`` (a group's
    ranks or stacked shards): u, delta (*lead, batch, dim, L_local), B4,
    C4 (*lead, batch, G, N, L_local), where ``lead`` is () on a group's
    rank and (n,) for stacked shards. Returns y in fp32."""
    *lead, batch, dim, L = u.shape
    G, N = B4.shape[-3], A.shape[-1]
    rows = lambda t: t.flatten(0, len(lead))
    uf, _, a, b = _prep(rows(u), rows(delta), A, rows(B4), delta_bias,
                        delta_softplus)
    _check(a, b)
    h = _RingScan.apply(a.unflatten(0, (*lead, batch)),
                        b.unflatten(0, (*lead, batch)), ring, reverse)
    y = torch.einsum("...gdnl,...gnl->...gdl",
                     h.reshape(*lead, batch, G, dim // G, N, L),
                     C4.float()).reshape(*lead, batch, dim, L)
    if D is not None:
        y = y + D.float()[:, None] * uf.view(*lead, batch, dim, L)
    return y


def selective_scan_sp(u, delta, A, B, C, D=None, delta_bias=None,
                      delta_softplus: bool = False,
                      group: Optional[dist.ProcessGroup] = None,
                      reverse: bool = False) -> torch.Tensor:
    """Sequence-parallel selective scan: ``ops.selective_scan``'s API, with
    u, delta (batch, dim, L_local) and B, C (batch, [G,] N, L_local) this
    rank's shards along L over ``group``. ``reverse`` scans the global
    sequence back to front. The scan elements and the C contraction are
    PyTorch ops on the shard, differentiable through autograd; the scan is
    :func:`sequence_parallel_scan`'s. Returns y in u's dtype."""
    group = group or mesh.active_group()
    if group is None:
        raise RuntimeError("selective_scan_sp: no process group (see "
                           "parallel.init_data_parallel)")
    return selective_scan_ring(u, delta, A, _bc4(B), _bc4(C), D, delta_bias,
                               delta_softplus, _GroupRing(group),
                               reverse).to(u.dtype)


def selective_scan_sp_check(device=None) -> None:
    """The multi-process dry run's check: a selective scan with L sharded
    over the active group's ranks (64 elements each) against the unsharded
    op on every rank's device. Raises on a mismatch (rtol 1e-4, atol
    1e-4)."""
    import numpy as np

    from ceigm_unet_tpu_torch.ops.selective_scan import selective_scan
    rank, n = mesh.rank_and_size()
    dev = mesh.rank_device(device or "cpu")
    rng = np.random.default_rng(7)
    batch, dim, N, L = 2, 8, 1, 64 * n
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    u = t(rng.standard_normal((batch, dim, L)))
    delta = t(0.4 * rng.standard_normal((batch, dim, L)))
    A = t(-0.5 - rng.random((dim, N)))
    B = t(rng.standard_normal((batch, 1, N, L)))
    C = t(rng.standard_normal((batch, 1, N, L)))
    part = slice(rank * 64, (rank + 1) * 64)
    with torch.no_grad():
        y = selective_scan_sp(u[..., part], delta[..., part], A,
                              B[..., part], C[..., part], delta_softplus=True)
        got = mesh.all_gather(y).movedim(0, -2).flatten(-2)
        want = selective_scan(u, delta, A, B, C, delta_softplus=True)
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError(
            f"selective_scan_sp_check: max abs err "
            f"{(got - want).abs().max().item():.3e} on rank {rank} of {n}")
