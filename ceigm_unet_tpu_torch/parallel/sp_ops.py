"""The exchanges of the H-sharded MSVM-UNet: halos, sums, extrema and the
one map gather, each differentiable with its adjoint as its backward.

The JAX package leaves every op but the scan to GSPMD, which inserts the
halos and collectives of an H-sharded input by itself
(``ceigm_unet_tpu/parallel/sp_model.py``). PyTorch has no GSPMD, so each op
of the port's model that reads across rows, or reduces over H, calls one of
these under the context of ``parallel/sp_context.py``:

- :func:`row_halo`: ``above`` rows of the shards before and ``below`` rows
  of the shards after (from as many shards as the rows need), with zeros
  (``"zero"``: the global zero padding) or this shard's edge row
  (``"edge"``: the global border clamp) beyond the image. Its backward sends
  the halo rows' cotangents back to their senders. It carries every spatial
  conv (:func:`conv2d`), the island's depthwise conv, the CustomFfn
  (:func:`rows_with_halo`, 4 rows of x), LGAG's gate (2 rows of g) and the
  last upsample (:func:`upsample_rows`, 1 row, edge fill).
- :func:`mean_hw`: the global mean over (H, W), a sum over the shards whose
  backward sums the cotangent over them (``mesh.all_reduce_sum``'s
  pattern). GroupMambaLayer's SE pool and MultiScaleCAB's average pool.
- :func:`amax_hw` / :func:`amin_hw`: each shard's extrema gathered and
  reduced under autograd, so the gradient reaches the winning shard's
  arg-extremum as the unsharded op's does. MultiScaleCAB's max and min
  pools.
- :func:`sample_rows`: DySample's source map gathered whole over H (its
  adjoint a reduce-scatter), each shard sampling its own output rows.

Every exchange runs over the context's ring (``parallel/ring_scan.py``): a
group's ranks, one shard each, or n shards stacked in one process, which
ride in the model's batch axis as (n*B, H/n, W, C) and which the ring's
``lead`` views as (n, B, H/n, W, C).

Gradient convention: the shards' parameter gradients are shares. On a group
each rank's backward holds its shard's share of the gradient of whatever
the ranks backpropagate; a loss that every rank computes whole through
``mesh.all_reduce_sum`` (``losses.py``) leaves each rank n times its share,
and the mean of the ranks' gradients (``mesh.reduce_gradients``) is the
gradient (``parallel/sp_model.py``). Stacked shards in one process hold the
gradient itself.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from ceigm_unet_tpu_torch.parallel.ring_scan import _StackedRing


def _cuts(total: int, hl: int) -> list:
    """Row counts of the pieces of a ``total``-row halo taken from the
    shards 1, 2, ... away, ``hl`` rows each: whole shards, then the
    rest."""
    return [min(hl, total - h) for h in range(0, total, hl)]


class _Halo(torch.autograd.Function):
    """(*lead, Hl, W, C) -> (*lead, above + Hl + below, W, C), zeros where
    there is no shard."""

    @staticmethod
    def forward(ctx, x, ring, above, below):
        hl = x.shape[-3]
        ctx.ring, ctx.cuts = ring, (_cuts(above, hl), _cuts(below, hl))
        to_succ = [x[..., hl - k:, :, :] for k in ctx.cuts[0]]
        to_pred = [x[..., :k, :, :] for k in ctx.cuts[1]]
        from_pred, from_succ = ring.swap_edges(to_pred, to_succ)
        return torch.cat([*from_pred[::-1], x, *from_succ], dim=-3)

    @staticmethod
    def backward(ctx, g):
        up, down = ctx.cuts
        parts = g.split([*up[::-1], g.shape[-3] - sum(up) - sum(down),
                         *down], dim=-3)
        back_pred = list(parts[:len(up)])[::-1]     # hop 1 first
        back_succ = list(parts[len(up) + 1:])
        gx = parts[len(up)].clone()
        hl = gx.shape[-3]
        # what the shards before sent back: the cotangents of the first
        # rows this shard sent them; the shards after, of its last rows
        got_pred, got_succ = ctx.ring.swap_edges(back_pred, back_succ)
        for k, t in zip(down, got_pred):
            gx[..., :k, :, :] += t
        for k, t in zip(up, got_succ):
            gx[..., hl - k:, :, :] += t
        return gx, None, None, None


def _stacked(ring) -> bool:
    return isinstance(ring, _StackedRing)


def _shard_index(ring):
    """This shard's index, a tensor of shape (*lead, 1, 1, 1, 1) for the
    (*lead, B, Hl, W, C) layout."""
    if _stacked(ring):
        return torch.arange(ring.n).view(-1, 1, 1, 1, 1)
    return torch.tensor(ring.idx)


def row_halo(x: torch.Tensor, ring, above: int, below: int,
             fill: str = "zero") -> torch.Tensor:
    """x (*lead, B, Hl, W, C), a shard in the ring's lead layout -> (*lead,
    B, above + Hl + below, W, C): the rows above and below it in the
    image. ``fill`` says what stands beyond the image: ``"zero"`` zeros,
    ``"edge"`` copies of the image's edge row (which this shard holds, so
    ``"edge"`` takes at most Hl rows)."""
    if fill not in ("zero", "edge"):
        raise ValueError(f"row_halo: fill {fill!r} is 'zero' or 'edge'")
    hl = x.shape[-3]
    if fill == "edge" and max(above, below) > hl:
        raise ValueError(f"row_halo: an edge-filled halo of {above} / "
                         f"{below} rows reaches past a shard of {hl}")
    y = _Halo.apply(x, ring, above, below)
    if fill == "zero":
        return y
    idx = _shard_index(ring).to(x.device)
    top, bottom = y[..., :above, :, :], y[..., above + hl:, :, :]
    top = torch.where(idx == 0, x[..., :1, :, :].expand_as(top), top)
    bottom = torch.where(idx == ring.n - 1,
                         x[..., -1:, :, :].expand_as(bottom), bottom)
    return torch.cat([top, x, bottom], dim=-3)


def conv2d(x, weight, bias, stride, padding, dilation, groups, ring):
    """``F.conv2d`` of the NHWC shard x (model layout) with zero padding,
    on the image: the conv's rows from a zero-filled halo of ``padding_h``
    rows above and ``dilation_h * (kh - 1) - padding_h - stride_h + 1``
    below, then the conv with no row padding. Raises when ``stride_h``
    does not divide the shard's H/n."""
    hl, kh = x.shape[1], weight.shape[2]
    sh, ph, dh = stride[0], padding[0], dilation[0]
    if hl % sh:
        raise ValueError(f"sharded conv: stride {sh} does not divide the "
                         f"shard's H/n = {hl} (H {hl * ring.n}, n {ring.n})")
    above, below = ph, dh * (kh - 1) - ph - sh + 1
    xh = ring.unlead(row_halo(ring.lead(x), ring, above, below))
    y = F.conv2d(xh.permute(0, 3, 1, 2), weight, bias, stride,
                 (0, padding[1]), dilation, groups)
    return y.permute(0, 2, 3, 1)


class _ShardSum(torch.autograd.Function):
    """The sum over the shards, on every shard; the backward sums the
    cotangent over the shards (``mesh.all_reduce_sum``'s pattern)."""

    @staticmethod
    def forward(ctx, t, ring):
        ctx.ring = ring
        return ring.sum_shards(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.sum_shards(g), None


class _Gather(torch.autograd.Function):
    """Every rank's t, (n, *t.shape); the backward is the reduce-scatter
    (each rank's t receives the sum of every rank's cotangent for it)."""

    @staticmethod
    def forward(ctx, t, ring):
        ctx.ring = ring
        return ring.gather(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.reduce_scatter(g), None


def _gather(t, ring):
    """(n, ...) every shard's t: on a group the all-gather, stacked the
    lead-layout tensor itself."""
    return t if _stacked(ring) else _Gather.apply(t, ring)


def mean_hw(x: torch.Tensor, ring) -> torch.Tensor:
    """(Bt, Hl, W, C) -> (Bt, C): the mean over the image's H and W."""
    s = ring.unlead(_ShardSum.apply(ring.lead(x.sum(dim=(1, 2))), ring))
    return s / (x.shape[1] * ring.n * x.shape[2])


def _extremum(x, ring, reduce):
    local = ring.lead(reduce(x, dim=(1, 2)))
    return ring.unlead(ring.spread(reduce(_gather(local, ring), dim=0)))


def amax_hw(x: torch.Tensor, ring) -> torch.Tensor:
    """(Bt, Hl, W, C) -> (Bt, C): the max over the image's H and W."""
    return _extremum(x, ring, torch.amax)


def amin_hw(x: torch.Tensor, ring) -> torch.Tensor:
    """(Bt, Hl, W, C) -> (Bt, C): the min over the image's H and W."""
    return _extremum(x, ring, torch.amin)


def shard_rows(t: torch.Tensor, ring, batch: int) -> torch.Tensor:
    """Values per image row, t (H, ...), as (batch, Hl, ...): each image of
    the shard's (model layout) batch with its own rows' values."""
    per = t.unflatten(0, (ring.n, -1))                    # (n, Hl, ...)
    if _stacked(ring):
        return per[:, None].expand(ring.n, batch // ring.n,
                                   *per.shape[1:]).flatten(0, 1)
    return per[ring.idx].expand(batch, *per.shape[1:])


def sample_rows(sample: Callable, x: torch.Tensor, grid: torch.Tensor,
                ring) -> torch.Tensor:
    """``sample(source, grid)`` with the source x (Bt, Hl, W, C) gathered
    whole over H and the grid (Bt, Ho_l, Wo, ...) the shard's output rows,
    in the image's normalised coordinates. A group's rank all-gathers the
    map (B, H, W, C) and samples its rows; stacked shards hold the map
    between them and sample all their rows in one call."""
    src = _gather(ring.lead(x), ring).movedim(0, 1).flatten(1, 2)
    if not _stacked(ring):
        return sample(src, grid)
    whole = ring.lead(grid).movedim(0, 1).flatten(1, 2)
    out = sample(src, whole)
    return ring.unlead(out.unflatten(1, (ring.n, -1)).movedim(1, 0))


def rows_with_halo(fn: Callable, x: torch.Tensor, ring, reach: int,
                   pointwise: Sequence[torch.Tensor] = (),
                   cut: bool = False) -> torch.Tensor:
    """``fn`` of the shard x (Bt, Hl, W, C) with ``reach`` rows of the
    image on each side (zero-filled), keeping the shard's Hl rows of its
    output; ``pointwise`` tensors of x's rows, which ``fn`` reads only
    pointwise, get zero rows there. ``fn`` maps (b, h, W, .) to (b, h, W,
    .), and its outputs at the shard's rows must read at most ``reach``
    rows away.

    ``cut``: the rows beyond the image are taken off rather than left as
    zeros, so that ``fn``'s own zero padding at the tensor's edge stands
    where the image's does (for an ``fn`` whose border is not that of a
    zero input). Shards then differ in height, so stacked shards run
    ``fn`` once per shard (n calls)."""
    hl = x.shape[1]
    xh = row_halo(ring.lead(x), ring, reach, reach)
    pads = [F.pad(ring.lead(t), (0, 0, 0, 0, reach, reach))
            for t in pointwise]
    if not cut:
        out = fn(ring.unlead(xh), *[ring.unlead(p) for p in pads])
        return out[:, reach:reach + hl]
    n, H = ring.n, hl * ring.n

    def one(i, xi, *pi):
        top = min(reach, i * hl)
        rows = slice(reach - top, reach + hl + min(reach, H - (i + 1) * hl))
        return fn(xi[:, rows], *[p[:, rows] for p in pi])[:, top:top + hl]
    if not _stacked(ring):
        return one(ring.idx, xh, *pads)
    return ring.unlead(torch.stack([one(i, xh[i], *[p[i] for p in pads])
                                    for i in range(n)]))


def upsample_rows(x: torch.Tensor, ring, scale: int) -> torch.Tensor:
    """``F.interpolate(bilinear, align_corners=False)`` by ``scale`` of the
    NHWC shard x, on the image: a one-row edge-filled halo (the border
    clamp), the Hl + 2 rows upsampled, output rows [scale, scale + scale *
    Hl) kept."""
    hl = x.shape[1]
    xh = ring.unlead(row_halo(ring.lead(x), ring, 1, 1, fill="edge"))
    y = F.interpolate(xh.permute(0, 3, 1, 2), scale_factor=scale,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)[:, scale:scale + scale * hl]

