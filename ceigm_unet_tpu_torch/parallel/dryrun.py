"""Multi-process dry run: data-parallel training and the ring scan over n
processes.

Counterpart of ``ceigm_unet_tpu/parallel/dryrun.py`` (the body of
``entry.dryrun_multichip``). The JAX package runs it in one process over a
mesh of n devices; here n processes are spawned (:func:`spawn`), joined in
one process group (NCCL on cards, one card per rank; gloo on the CPU), and
each runs :func:`_dryrun_rank`:

- two data-parallel gm_tiny steps on its rows (AdamW, encoder freeze off,
  then on), whose losses must be finite;
- ``ring_scan.selective_scan_sp_check``: a selective scan with L sharded
  over the ranks against the unsharded op;
- the tiny SGD step of gm_test (:func:`trajectory`), with and without
  on-device augmentation, whose parameters and BatchNorm statistics the
  parent holds against the same step in one process without a group
  (:func:`assert_equiv`, the JAX dry run's tolerance).
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ceigm_unet_tpu_torch.models import build_model
from ceigm_unet_tpu_torch.parallel import mesh
from ceigm_unet_tpu_torch.parallel.ring_scan import selective_scan_sp_check
from ceigm_unet_tpu_torch.train.loop import no_tf32
from ceigm_unet_tpu_torch.train.trainstep import (cosine_lr, make_optimizer,
                                                  make_sgd, make_train_step,
                                                  param_groups)


def _worker(rank: int, n: int, tmp: str, device: str, task: Callable,
            args: tuple, collective_timeout_s: float) -> None:
    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        torch.set_num_threads(1)
        mesh.init_data_parallel(n, device=device, rank=rank,
                                store_path=os.path.join(tmp, "store"),
                                timeout_s=collective_timeout_s)
        torch.save({"result": task(*args)}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Launch:
    """n spawned ranks running one task (see :func:`start`)."""

    def __init__(self, procs, tmp: str):
        self.procs, self.tmp = procs, tmp

    def join(self, timeout_s: float = 120.0) -> List:
        """Each rank's return value, in rank order. Raises when a rank
        failed (with its traceback) or when the ranks outlive
        ``timeout_s``, after killing every rank still running."""
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        results, errors = [], []
        for r in range(len(self.procs)):
            path = os.path.join(self.tmp, f"rank{r}.pt")
            got = (torch.load(path, weights_only=False)
                   if os.path.exists(path) else {"error": "no result"})
            results.append(got.get("result"))
            if "error" in got:
                errors.append(f"rank {r}: {got['error']}")
        shutil.rmtree(self.tmp, ignore_errors=True)
        if hung:
            raise TimeoutError(f"ranks {hung} still ran after {timeout_s} s "
                               f"(killed); " + " | ".join(errors))
        if errors:
            raise RuntimeError("\n".join(errors))
        return results


def start(n: int, task: Callable, args: Sequence = (), device: str = "cpu",
          collective_timeout_s: float = 60.0) -> Launch:
    """Spawn n processes, rank r in process r, joined in one group through
    a ``FileStore`` in a fresh temporary directory; each runs
    ``task(*args)`` (a module-level function: it is pickled by name) with
    one CPU thread. ``device`` "cuda" gives rank r the card ``cuda:r``
    (NCCL); "cpu" runs gloo. A collective that waits longer than
    ``collective_timeout_s`` raises in its rank. The ranks are daemonic:
    a task must not start processes of its own."""
    if torch.device(device).type == "cuda" \
            and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks on the card need {n} CUDA devices; "
                           f"this host has {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="ceigm_dp_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, n, tmp, str(device), task, tuple(args),
                               collective_timeout_s))
             for r in range(n)]
    for p in procs:
        p.start()
    return Launch(procs, tmp)


def spawn(n: int, task: Callable, args: Sequence = (), device: str = "cpu",
          timeout_s: float = 120.0) -> List:
    """:func:`start`, then :meth:`Launch.join` within ``timeout_s``."""
    return start(n, task, args, device).join(timeout_s)


def trajectory(image: np.ndarray, label: np.ndarray, frozen: Sequence[bool],
               device: str = "cpu", drop_path_rate: float = 0.2,
               device_aug_size: Optional[int] = None):
    """SGD (lr 1e-2, momentum 0.9) steps of the 4-class gm_test MSVM-UNet
    seeded with 0 on the global batch (numpy image (B, H, W, 1), label
    (B, H, W)), one per entry of ``frozen`` (True: encoder frozen), DiceCE
    0.4/0.6, the drop-path masks from one generator seeded with 7, TF32
    off; with a group active, on this rank's rows. Returns (losses,
    state_dict as numpy)."""
    dev = mesh.rank_device(device)
    model = build_model(num_classes=4, enc_name="gm_test", device=dev,
                        decoder_drop_path_rate=drop_path_rate).train()
    step = make_train_step(model, make_sgd(param_groups(model), momentum=0.9),
                           lambda s: 1e-2, 0.4, 0.6,
                           device_aug_size=device_aug_size)
    batch = mesh.shard_batch({"image": torch.from_numpy(image),
                              "label": torch.from_numpy(label)})
    batch = {k: v.to(dev) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(7)
    with no_tf32():
        losses = [step(batch, freeze_encoder=f, generator=gen)["loss"].item()
                  for f in frozen]
    return losses, {k: v.detach().cpu().numpy()
                    for k, v in model.state_dict().items()}


def assert_equiv(one, many) -> None:
    """The JAX dry run's check of (losses, state) of one process against
    n: each loss within 1e-5 relative, every parameter and buffer within
    rtol 1e-5, atol 1e-8 + 1e-5 * max|one|."""
    (l1, s1), (ln, sn) = one, many
    for a, b in zip(l1, ln):
        if not abs(a - b) <= 1e-5 * max(1.0, abs(a)):
            raise AssertionError(f"loss {a} in one process, {b} in n")
    for k, a in s1.items():
        b = sn[k]
        if a.dtype.kind == "f" and not np.allclose(
                a, b, rtol=1e-5, atol=1e-8 + 1e-5 * np.abs(a).max()):
            raise AssertionError(f"{k}: max abs diff "
                                 f"{np.abs(a - b).max():.3e}")
        if a.dtype.kind != "f" and not np.array_equal(a, b):
            raise AssertionError(f"{k}: {a} in one process, {b} in n")


def tiny_batch(n: int, device_aug: bool):
    """The JAX dry run's tiny batch of n slices: 32x32 normal images, or
    64x64 raw uniform ones for on-device augmentation; 4 classes."""
    rng = np.random.default_rng(5)
    size = 64 if device_aug else 32
    image = (rng.uniform(0, 1, (n, size, size, 1)) if device_aug
             else rng.standard_normal((n, size, size, 1)))
    return (image.astype(np.float32),
            rng.integers(0, 4, (n, size, size)).astype(np.int64))


def _dryrun_rank(device: str):
    rank, n = mesh.rank_and_size()
    dev = mesh.rank_device(device)
    model = build_model(num_classes=9, device=dev).train()
    step = make_train_step(model, make_optimizer(param_groups(model), 1e-3),
                           cosine_lr(5e-4, 1e-6, 300, 10))
    batch = mesh.shard_batch({
        "image": torch.zeros((2 * n, 32, 32, 1), device=dev),
        "label": torch.zeros((2 * n, 32, 32), dtype=torch.long,
                             device=dev)})
    gen = torch.Generator(device=dev).manual_seed(1)
    for frozen in (False, True):
        loss = step(batch, freeze_encoder=frozen, generator=gen)["loss"]
        if not bool(torch.isfinite(loss)):
            raise AssertionError(f"rank {rank}: gm_tiny loss {loss.item()}")
    selective_scan_sp_check(device)
    return [trajectory(*tiny_batch(n, aug), [False], device,
                       device_aug_size=32 if aug else None)
            for aug in (False, True)]


def run(n: int, device: str = "cpu", timeout_s: float = 600.0) -> None:
    """The dry run over n processes (see the module docstring); raises on
    any failed check. With ``device`` "cuda" the host needs n cards."""
    results = spawn(n, _dryrun_rank, (device,), device, timeout_s)
    for aug, many in zip((False, True), results[0]):
        one = trajectory(*tiny_batch(n, aug), [False], device,
                         device_aug_size=32 if aug else None)
        assert_equiv(one, many)
    for r, res in enumerate(results[1:], 1):
        for (_, s0), (_, sr) in zip(results[0], res):
            for k, a in s0.items():
                if not np.array_equal(a, sr[k]):
                    raise AssertionError(f"rank {r} holds another {k}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    """``python -m ceigm_unet_tpu_torch.parallel.dryrun [N] [--device
    cuda|cpu]``: :func:`run` over N ranks (8 by default, as the JAX dry
    run's), on the cards unless ``--device cpu`` is given; prints
    ``dryrun_multichip: OK`` when every check passed."""
    parser = argparse.ArgumentParser(
        prog="python -m ceigm_unet_tpu_torch.parallel.dryrun",
        description="multi-process dry run: data-parallel training and the "
                    "ring scan over N ranks")
    parser.add_argument("n", nargs="?", type=int, default=8)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    run(args.n, args.device)
    print("dryrun_multichip: OK")


if __name__ == "__main__":
    main()
