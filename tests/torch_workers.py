"""Tasks that tests/test_torch_parallel.py runs in spawned ranks.

The ranks import torch and the port only (``tests/conftest.py``, which
imports JAX, is never loaded there); ``parallel.dryrun.spawn`` joins them in
one gloo group and pickles these functions by name.
"""
import contextlib

import torch

from ceigm_unet_tpu_torch.parallel import dryrun, mesh
from ceigm_unet_tpu_torch.train import trainstep


@contextlib.contextmanager
def injected_draws(draws):
    """The train step's augmentation parameters taken from ``draws`` (one
    dict of numpy arrays per step, for the global batch) instead of its
    generator: the draws of another implementation."""
    it = iter(draws)
    saved = trainstep.sample_params
    trainstep.sample_params = lambda gen, total, h, w, out, device: {
        k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
    try:
        yield
    finally:
        trainstep.sample_params = saved


def trajectories(cases, draws):
    """For each case (image, label, frozen flags, device augmentation):
    the trajectory with stochastic depth on (drop-path 0.2), and the one
    with it off, with ``draws`` injected where the case augments on the
    device (the JAX side's draws)."""
    out = {}
    for name, (image, label, frozen, aug) in cases.items():
        size = 32 if aug else None
        out[name] = dryrun.trajectory(image, label, frozen,
                                      device_aug_size=size)
        with injected_draws(draws) if aug else contextlib.nullcontext():
            out[name, "no drop-path"] = dryrun.trajectory(
                image, label, frozen, drop_path_rate=0.0,
                device_aug_size=size)
    return out


def losses(logits, labels, weights):
    """Each loss of ``losses.py`` on this rank's rows of the global
    (logits, labels), with the gradient of the logits rows (``weights``:
    the class weights of the weighted cross-entropy and Dice)."""
    from ceigm_unet_tpu_torch import losses as L
    rows = mesh.shard_batch({"x": torch.from_numpy(logits),
                             "y": torch.from_numpy(labels)})
    w = torch.from_numpy(weights)
    fns = {"dice_ce": lambda x, y: L.dice_ce_loss(x, y, 0.4, 0.6),
           "weighted": lambda x, y: L.dice_ce_loss(x, y, 0.4, 0.6, w, w),
           "dice_focal": lambda x, y: L.dice_focal_loss(x, y, alpha=0.25)}
    out = {}
    for name, fn in fns.items():
        x = rows["x"].clone().requires_grad_()
        loss = fn(x, rows["y"])
        loss.backward()
        out[name] = loss.item(), x.grad.numpy()
    return out


def inference(image):
    """This rank's rows of the eval forward of the global batch, and the
    ``torch.distributed`` calls made during it."""
    from ceigm_unet_tpu_torch.models import build_model
    model = build_model(num_classes=4, enc_name="gm_test", device="cpu")
    x = mesh.shard_batch({"x": torch.from_numpy(image)})["x"]
    with mesh.watch_collectives() as calls, torch.no_grad():
        logits = model(x)
    return logits.numpy(), calls


def training_loop(cfg, data_dir, list_dir):
    """``run_training`` on the ACDC-format slices, 2 steps, each rank with
    log and checkpoint directories of its own (``<dir>/rank<r>``), so that
    the test can see which rank wrote."""
    import dataclasses
    import os

    from ceigm_unet_tpu_torch.data.datasets import ACDCDataset
    from ceigm_unet_tpu_torch.train import loop
    rank, _ = mesh.rank_and_size()
    cfg = dataclasses.replace(
        cfg, log_dir=os.path.join(cfg.log_dir, f"rank{rank}"),
        ckpt_dir=os.path.join(cfg.ckpt_dir, f"rank{rank}"))
    ds = ACDCDataset(data_dir, "train", list_dir, cfg.img_size, seed=cfg.seed)
    val = ACDCDataset(data_dir, split="test", list_dir=list_dir,
                      augment=False)
    _, step = loop.run_training(cfg, ds, [val[i] for i in range(len(val))],
                                max_steps=2, device="cpu")
    return step.count


def dp_cases(cases, draws, image, loss_args, loop_args):
    """Every data-parallel case of the test module, in one group."""
    return {"trajectories": trajectories(cases, draws),
            "losses": losses(*loss_args),
            "inference": inference(image),
            "loop": training_loop(*loop_args)}


def ring_cases(scan, grad, sp, sp_grad):
    """This rank's shards of the ring scan's results on the global inputs:
    the forward and the gradients of sum(h * ct) (``scan``: a, b; ``grad``:
    a, b, ct), each forward and reverse, with the ``torch.distributed``
    calls of the gradients' forward and backward; ``selective_scan_sp``'s forward
    (``sp``) and, scanning in reverse, the gradients of sum(y^2) in u,
    delta, B and C (``sp_grad``)."""
    from ceigm_unet_tpu_torch.parallel import (selective_scan_sp,
                                               sequence_parallel_scan)
    rank, n = mesh.rank_and_size()

    def part(x):
        x = torch.from_numpy(x)
        w = x.shape[-1] // n
        return x[..., rank * w:(rank + 1) * w].contiguous()
    out = {}
    for reverse in (False, True):
        with torch.no_grad():
            out["scan", reverse] = sequence_parallel_scan(
                part(scan["a"]), part(scan["b"]), reverse=reverse).numpy()
        a = part(grad["a"]).requires_grad_()
        b = part(grad["b"]).requires_grad_()
        with mesh.watch_collectives() as calls:
            (sequence_parallel_scan(a, b, reverse=reverse)
             * part(grad["ct"])).sum().backward()
        out["grad", reverse] = a.grad.numpy(), b.grad.numpy()
        out["calls", reverse] = calls
    with torch.no_grad():
        out["sp"] = selective_scan_sp(
            part(sp["u"]), part(sp["delta"]), torch.from_numpy(sp["A"]),
            part(sp["B"]), part(sp["C"]), torch.from_numpy(sp["D"]),
            torch.from_numpy(sp["bias"]), delta_softplus=True).numpy()
    xs = [part(sp_grad[k]).requires_grad_() for k in ("u", "delta", "B", "C")]
    y = selective_scan_sp(xs[0], xs[1], torch.from_numpy(sp_grad["A"]),
                          xs[2], xs[3], delta_softplus=True, reverse=True)
    (y.float() ** 2).sum().backward()
    out["sp_grad"] = [x.grad.numpy() for x in xs]
    return out


def sp_cases(cases):
    """This rank's results of the H-sharded QuadGroupSS2D over the group,
    for each case (C -> the block's state dict, x, ct; global (B, H, W, C)
    arrays, H sharded in rank order):

    - ``out``, ``gx``, ``gp``: the functional block's output shard and the
      gradients of sum(out * ct) in this rank's x shard and in every
      parameter (this rank's share);
    - ``calls``: the ``torch.distributed`` calls of that forward and
      backward; ``gathered``: the element count of each all-gather's input
      in it (a wrapper local to this task);
    - ``module``: the module under ``sp_scan_island`` (no grad), and
      ``functional`` the functional call on the same shard;
    - ``kernel``: the output shard with ``dwconv="kernel"``;
    - ``raises``: what ``quant_scan=True`` and a W that the ranks do not
      divide raise."""
    import torch.distributed as dist

    from ceigm_unet_tpu_torch.convert import jax_import
    from ceigm_unet_tpu_torch.models.ss2d import QuadGroupSS2D
    from ceigm_unet_tpu_torch.parallel.sp_context import sp_scan_island
    from ceigm_unet_tpu_torch.parallel.sp_ss2d import quad_group_ss2d_sp
    rank, n = mesh.rank_and_size()

    def part(a):
        rows = a.shape[1] // n
        return torch.from_numpy(a[:, rank * rows:(rank + 1) * rows].copy())
    out = {}
    for C, (sd, x, ct) in cases.items():
        block = QuadGroupSS2D(C)
        jax_import.load_numpy_state_dict(block, sd)
        xs = part(x).requires_grad_()
        gathered = []
        all_gather = dist.all_gather

        def counted(parts, t, *a, **kw):
            gathered.append(t.numel())
            return all_gather(parts, t, *a, **kw)
        dist.all_gather = counted
        try:
            with mesh.watch_collectives() as calls:
                y = quad_group_ss2d_sp(block, xs)
                (y * part(ct)).sum().backward()
        finally:
            dist.all_gather = all_gather
        r = dict(out=y.detach().numpy(), gx=xs.grad.numpy(),
                 gp={k: p.grad.numpy() for k, p in block.named_parameters()},
                 calls=calls, gathered=gathered)
        with torch.no_grad():
            with sp_scan_island():
                r["module"] = block(xs).numpy()
            r["functional"] = quad_group_ss2d_sp(block, xs).numpy()
            kernel = QuadGroupSS2D(C, dwconv="kernel")
            jax_import.load_numpy_state_dict(kernel, sd)
            r["kernel"] = quad_group_ss2d_sp(kernel, xs).numpy()
            raises = []
            for blk, xr in ((QuadGroupSS2D(C, quant_scan=True), xs),
                            (block, torch.zeros(2, 4, 8 * n + 1, C))):
                try:
                    with sp_scan_island():
                        blk(xr)
                    raises.append(None)
                except ValueError as e:
                    raises.append(str(e))
            r["raises"] = raises
        out[C] = r
    return out


def _halo_zero(x, ring):
    """5 rows above and 3 below: three and two shards away at H/n = 2."""
    from ceigm_unet_tpu_torch.parallel import sp_ops
    return ring.unlead(sp_ops.row_halo(ring.lead(x), ring, 5, 3))


def _halo_edge(x, ring):
    from ceigm_unet_tpu_torch.parallel import sp_ops
    return ring.unlead(sp_ops.row_halo(ring.lead(x), ring, 1, 2,
                                       fill="edge"))


def _gather_sample(x, ring, grid):
    """DySample's grouped grid-sample of the map gathered over H, at the
    shard's rows of ``grid``."""
    from ceigm_unet_tpu_torch.ops.grid_sample import dysample_grid_sample
    from ceigm_unet_tpu_torch.parallel import sp_ops
    return sp_ops.sample_rows(dysample_grid_sample, x, grid, ring)


def sharded_exchanges():
    """name -> fn(x, ring, aux): each exchange of ``parallel/sp_ops.py`` on
    the (model layout) shard x; ``aux`` is the shard's rows of the
    exchange's extra input (the sample grid), or None."""
    from ceigm_unet_tpu_torch.parallel import sp_ops
    return {"halo_zero": lambda x, ring, aux: _halo_zero(x, ring),
            "halo_edge": lambda x, ring, aux: _halo_edge(x, ring),
            "sum": lambda x, ring, aux: sp_ops.mean_hw(x, ring),
            "max": lambda x, ring, aux: sp_ops.amax_hw(x, ring),
            "min": lambda x, ring, aux: sp_ops.amin_hw(x, ring),
            "gather": _gather_sample}


def run_exchanges(ring, cases, part, mine):
    """Each exchange on the shard's rows (``part``) of its case's x and
    aux, with the shard's (``mine``) cotangent, from (x, cts with a leading
    shard axis, aux): the output and the gradient of sum(out * ct) in
    x."""
    out = {}
    for name, fn in sharded_exchanges().items():
        x, cts, aux = cases[name]
        xs = part(x).requires_grad_()
        y = fn(xs, ring, None if aux is None else part(aux))
        (y * mine(cts)).sum().backward()
        out[name] = y.detach().numpy(), xs.grad.numpy()
    return out


def sp_model_cases(sd, x, labels, exchanges):
    """This rank's results of the H-sharded gm_test model (4 classes, eval,
    ``sd``'s weights) on its rows of the global x (B, H, W, 1) and labels:

    - ``logits``: ``sp_forward``'s shard, with the ``torch.distributed``
      calls of that forward (``calls``) and the element count of each
      all-gather's input in it (``gathered``, a wrapper local to this task);
    - ``loss``, ``grads``: ``sp_value_and_grad``'s;
    - ``exchanges``: :func:`run_exchanges` over the group, ``exchanges``
      holding each case's global arrays, the cotangent with a leading
      shard axis;
    - ``train``: what ``sp_forward`` raises for the model in training
      mode."""
    import numpy as np
    import torch.distributed as dist

    from ceigm_unet_tpu_torch.convert import jax_import
    from ceigm_unet_tpu_torch.models import build_model
    from ceigm_unet_tpu_torch.parallel import sp_forward, sp_value_and_grad
    from ceigm_unet_tpu_torch.parallel.ring_scan import _GroupRing
    rank, n = mesh.rank_and_size()

    def part(a):
        rows = a.shape[1] // n
        return torch.from_numpy(
            np.ascontiguousarray(a[:, rank * rows:(rank + 1) * rows]))
    model = build_model(num_classes=4, enc_name="gm_test", device="cpu")
    jax_import.load_numpy_state_dict(model, sd)
    gathered = []
    all_gather = dist.all_gather

    def counted(parts, t, *a, **kw):
        gathered.append(t.numel())
        return all_gather(parts, t, *a, **kw)
    dist.all_gather = counted
    try:
        with torch.no_grad(), mesh.watch_collectives() as calls:
            logits = sp_forward(model, part(x))
    finally:
        dist.all_gather = all_gather
    loss, grads = sp_value_and_grad(model, part(x), part(labels).long())
    out = dict(logits=logits.numpy(), calls=calls, gathered=gathered,
               loss=loss.item(), grads={k: g.numpy() for k, g in
                                        grads.items()},
               exchanges=run_exchanges(
                   _GroupRing(dist.group.WORLD), exchanges, part,
                   lambda a: torch.from_numpy(a[rank].copy())))
    try:
        sp_forward(model.train(), part(x))
        out["train"] = None
    except ValueError as e:
        out["train"] = str(e)
    return out


def sp_legacy_cases(sd, x, labels, blocks):
    """This rank's results of the H-sharded legacy MSVM-UNet (vssm_test, 9
    classes, eval, ``sd``'s weights) on its rows of the global x (B, H, W,
    1) and labels:

    - ``logits``: ``sp_forward``'s shard, with the ``torch.distributed``
      calls of that forward (``calls``);
    - ``loss``, ``grads``: ``sp_value_and_grad``'s;
    - ``blocks``: for each d_state -> (the SS2D's state dict, x, ct; global
      (B, H, W, C) arrays), ``ss2d_sp``'s output shard and the gradients of
      sum(out * ct) in this rank's x shard and in every parameter (this
      rank's share)."""
    import numpy as np

    from ceigm_unet_tpu_torch.convert import jax_import
    from ceigm_unet_tpu_torch.models import build_legacy_model
    from ceigm_unet_tpu_torch.models.ss2d import SS2D
    from ceigm_unet_tpu_torch.parallel import sp_forward, sp_value_and_grad
    from ceigm_unet_tpu_torch.parallel.sp_ss2d import ss2d_sp
    rank, n = mesh.rank_and_size()

    def part(a):
        rows = a.shape[1] // n
        return torch.from_numpy(
            np.ascontiguousarray(a[:, rank * rows:(rank + 1) * rows]))
    model = build_legacy_model(enc_name="vssm_test", device="cpu")
    jax_import.load_numpy_state_dict(model, sd)
    with torch.no_grad(), mesh.watch_collectives() as calls:
        logits = sp_forward(model, part(x))
    loss, grads = sp_value_and_grad(model, part(x), part(labels).long())
    out = dict(logits=logits.numpy(), calls=calls, loss=loss.item(),
               grads={k: g.numpy() for k, g in grads.items()}, blocks={})
    for d_state, (bsd, bx, ct) in blocks.items():
        op = SS2D(bx.shape[-1], d_state=d_state)
        jax_import.load_numpy_state_dict(op, bsd)
        xs = part(bx).requires_grad_()
        y = ss2d_sp(op, xs)
        (y * part(ct)).sum().backward()
        out["blocks"][d_state] = (
            y.detach().numpy(), xs.grad.numpy(),
            {k: p.grad.numpy() for k, p in op.named_parameters()})
    return out
