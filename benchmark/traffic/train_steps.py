"""Traffic kind ``train_steps``: the served package's training step, as its
``entry.train_entry`` builds it (the Synapse recipe: DiceCE, AdamW, the
per-epoch cosine LR), unfrozen, stepping through a few seeded synthetic
batches kept on the card with a seeded stochastic-depth generator. The host
waits for the card only at the window's end, as the training loop reads the
loss once per epoch.

Parameters (the mix's file): ``dtype`` (float32 steps run with TF32 off,
as the training loop runs them), ``batch``, ``img``, ``batches`` (distinct
batches the steps cycle through), ``checked_steps`` (how many steps in a
row each check follows), ``window_check_step`` (the optimizer step, counted
from the first, at which the window's checked steps begin), ``trace_steps``
(steps in a traced window) and ``recipe`` (what the reference steps with).

Two runs of ``checked_steps`` steps go through the same step object and are
held against the plain reference:

- the start: the first steps, in set-up, from the seeded weights; the
  reference steps from the same seeded weights;
- the window: the steps from ``window_check_step`` on, inside the timed
  window. Their parameters and AdamW moments are copied to the host on the
  stream as they stand before the first of them, and the reference resumes
  from that copy, with the same batches and stochastic-depth generator
  state.

Each yields each step's loss, the first step's logits, every parameter's
first gradient as AdamW got it (from its first moment before and after the
step) and every parameter's change over the steps.
"""
from __future__ import annotations

import contextlib
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from benchmark import inputs
from benchmark.reference import msvm_unet as ref_model
from benchmark.reference import train as ref_train
from benchmark.weights import make_state, stream_seed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# leaves whose reference gradient is below this share of the median leaf's
# are rounding noise (Adam moves them by a full step regardless) and are
# left out of the change
NOISE_LEAF = 1e-3


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for float32 matrix products and convolutions on or off inside
    the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[k].detach().float().norm() for k in names])
    return dict(zip(names, vals.tolist()))


def compare(got: Dict, ref: Dict, worst_of: Dict = None) -> Dict[str, float]:
    """The numbers a checked run can be held to:

    - ``loss_gap``: the largest relative gap of a step's loss;
      ``loss_gap_later`` the same over the steps after the first;
    - ``logit_gap``: the largest gap of the first step's logits over the
      reference's largest |logit|;
    - ``grad_gap``, ``grad_gap_median``: the worst and the median leaf's
      gap of the first-gradient norms, each measured against the larger of
      the reference's norm of that leaf and of the median leaf;
      ``change_gap``, ``change_gap_median``: the same of the change norms,
      noise leaves left out;
    - ``grad_diff_median``, ``change_diff_median``: the median leaf's norm
      of the difference, measured as above;
    - ``grad_norm_gap``: the gap of the first gradient's norm over all
      leaves; ``grad_diff``, ``change_diff``: the norm of the difference
      over all leaves (moved leaves for the change) over the reference's.

    ``worst_of``, if given, receives the leaves that set the worst gaps."""
    inf = float("inf")
    out = {}
    gl, rl = got["losses"], ref["losses"]
    if len(gl) != len(rl):
        out["loss_gap"] = out["loss_gap_later"] = inf
    else:
        rel = [abs(a - b) / abs(b) for a, b in zip(gl, rl)]
        out["loss_gap"], out["loss_gap_later"] = max(rel), max(rel[1:])

    a, b = got.get("logits"), ref.get("logits")
    if b is not None:
        out["logit_gap"] = inf if a is None or a.shape != b.shape else float(
            (a.float() - b).abs().max() / b.abs().max())

    gr, cr = _norms(ref["grads"]), _norms(ref["changes"])
    gg, cg = _norms(got["grads"]), _norms(got["changes"])
    med = statistics.median(gr.values())
    moved = [k for k in gr if gr[k] >= NOISE_LEAF * med]

    def gaps(what, g, r, keys):
        """The worst and the median leaf's gap."""
        if not keys:
            return inf, inf
        m = statistics.median(r[k] for k in keys)
        by = sorted(((abs(g[k] - r[k]) / max(r[k], m) if k in g else inf,
                      k) for k in keys), reverse=True)
        if worst_of is not None:
            worst_of[what] = [(k, v, g.get(k), r[k], m) for v, k in by[:3]]
        return by[0][0], statistics.median(v for v, _ in by)

    out["grad_gap"], out["grad_gap_median"] = gaps("grad_gap", gg, gr,
                                                   list(gr))
    out["change_gap"], out["change_gap_median"] = gaps("change_gap", cg, cr,
                                                       moved)

    def diffs(key, keys, norm):
        """(median leaf's difference norm over max(its norm, the median's),
        the difference norm over all keys over the reference's)."""
        g, r = got[key], ref[key]
        if not keys or any(k not in g for k in keys):
            return inf, inf
        d = {k: float((g[k].to(r[k].device, torch.float32) - r[k]).norm())
             for k in keys}
        m = statistics.median(norm[k] for k in keys)
        whole = sum(norm[k] ** 2 for k in keys) ** 0.5
        return (statistics.median(d[k] / max(norm[k], m) for k in keys),
                sum(v * v for v in d.values()) ** 0.5 / whole
                if whole > 0 else inf)

    out["grad_diff_median"], out["grad_diff"] = diffs("grads", list(gr), gr)
    out["change_diff_median"], out["change_diff"] = diffs("changes", moved,
                                                          cr)
    whole_r = sum(v * v for v in gr.values()) ** 0.5
    whole_g = sum(gg.get(k, inf) ** 2 for k in gr) ** 0.5
    out["grad_norm_gap"] = abs(whole_g - whole_r) / whole_r \
        if whole_r > 0 else inf
    return out


def reference_readings(state, batches, cfg, recipe, generator,
                       P=ref_model.FP32, allow_tf32: bool = False,
                       moments: Optional[Dict] = None) -> Dict:
    """The plain reference's readings of ``len(batches)`` steps from
    ``state`` (and AdamW's ``moments``, if it resumes)."""
    with tf32(allow_tf32):
        r = ref_train.train_steps(state, batches, cfg["depths"], recipe,
                                  generator, P, moments)
    return {"losses": r["losses"], "logits": r["first_logits"],
            "grads": r["first_grads"], "changes": r["change"]}


class _Host:
    """Host copies of a fixed list of float32 device tensors, in one flat
    buffer (pinned where the tensors are on a card), taken on the stream
    without waiting for it."""

    def __init__(self, tensors: List[torch.Tensor], pin: bool):
        n = sum(t.numel() for t in tensors)
        self.flat = torch.empty(n, dtype=torch.float32, pin_memory=pin)
        self.views, offset = [], 0
        for t in tensors:
            self.views.append(self.flat[offset:offset + t.numel()]
                              .view(t.shape))
            offset += t.numel()

    def take(self, tensors: List[torch.Tensor]) -> None:
        for v, t in zip(self.views, tensors):
            v.copy_(t.detach(), non_blocking=True)


class Checked:
    """What ``steps`` steps in a row, from ``first`` (the optimizer steps
    taken before them), leave for the check: the parameters and AdamW's
    moments before them, the first step's logits and first moment after
    it, every step's loss, and the parameters after the last."""

    def __init__(self, first: int, steps: int, names: List[str],
                 params: List[torch.Tensor], pin: bool):
        self.first, self.steps, self.names = first, steps, names
        self.pin = pin
        self.host = {k: _Host(params, pin)
                     for k in ("p0", "m0", "v0", "m1", "p1")}
        self.losses: List[torch.Tensor] = []
        self.logits: Optional[torch.Tensor] = None
        self.gen_state = None
        self.hook = None

    def _moments(self, optimizer, params, key):
        """AdamW's moment ``key`` of each parameter (zeros before its first
        step)."""
        state = optimizer.state if optimizer is not None else {}
        return [state[p][key] if key in state.get(p, {})
                else torch.zeros_like(p) for p in params]

    def before(self, count, model, optimizer, params, gen) -> None:
        if count != self.first:
            return
        self.host["p0"].take(params)
        self.host["m0"].take(self._moments(optimizer, params, "exp_avg"))
        self.host["v0"].take(self._moments(optimizer, params, "exp_avg_sq"))
        self.gen_state = gen.get_state()
        self.hook = model.register_forward_hook(self._keep)

    def _keep(self, module, args, out):
        if self.logits is None or self.logits.shape != out.shape:
            self.logits = torch.empty(out.shape, dtype=out.dtype,
                                      pin_memory=self.pin)
        self.logits.copy_(out.detach(), non_blocking=True)

    def after(self, count, out, optimizer, params) -> None:
        if not self.first <= count < self.first + self.steps:
            return
        self.losses.append(out["loss"])
        if count == self.first:
            self.hook.remove()
            self.host["m1"].take(self._moments(optimizer, params, "exp_avg"))
        if count == self.first + self.steps - 1:
            self.host["p1"].take(params)

    @property
    def done(self) -> bool:
        return len(self.losses) == self.steps

    def readings(self, beta1: float) -> Dict:
        """Once the stream has passed the last step: the readings, and
        where the reference resumes from (parameters, moments, steps)."""
        h = {k: dict(zip(self.names, v.views)) for k, v in self.host.items()}
        return {
            "losses": [float(v) for v in self.losses],
            "logits": self.logits,
            "grads": {k: (h["m1"][k] - beta1 * h["m0"][k]) / (1.0 - beta1)
                      for k in self.names},
            "changes": {k: h["p1"][k] - h["p0"][k] for k in self.names},
            "start": {"params": h["p0"], "exp_avg": h["m0"],
                      "exp_avg_sq": h["v0"], "steps": self.first},
            "gen_state": self.gen_state}


class Traffic:
    def __init__(self, config: Dict, mix: Dict, seed: int,
                 device: torch.device):
        self.cfg, self.mix, self.seed, self.device = config, mix, seed, device
        self.dtype = DTYPES[mix["dtype"]]
        self.batch = mix["batch"]
        self.stack = contextlib.ExitStack()

    def setup(self) -> None:
        from ceigm_unet_tpu_torch.entry import train_entry
        if self.dtype == torch.float32:
            from ceigm_unet_tpu_torch.train.loop import no_tf32
            self.stack.enter_context(no_tf32())
        self.model, self.step, _ = train_entry(
            device=self.device, dtype=self.dtype, batch=self.batch,
            enc_name=self.cfg["enc_name"])
        self.shapes = {k: (tuple(v.shape), v.dtype)
                       for k, v in self.model.state_dict().items()}
        self.model.load_state_dict(make_state(self.shapes, self.seed,
                                              self.device))
        m = self.mix
        self.batches = inputs.train_batches(
            m["batches"], self.batch, m["img"], self.cfg["num_classes"],
            self.seed, self.device)
        self.gen = torch.Generator(self.device).manual_seed(
            stream_seed(self.seed, 3))
        named = dict(self.model.named_parameters())
        self.names, self.params = list(named), list(named.values())
        pin = self.device.type == "cuda"
        self.optimizer = None
        self.done = 0
        self.checks = {"start": Checked(0, m["checked_steps"], self.names,
                                        self.params, pin)}
        found = []

        def stepped(opt, args, kwargs):
            found.append(opt)
            self.optimizer = opt
        hook = register_optimizer_step_post_hook(stepped)
        try:
            self._one()
        finally:
            hook.remove()
        if len(found) != 1:
            raise RuntimeError(f"train_steps: {len(found)} optimizer steps in "
                               f"one training step")
        self.beta1 = self.optimizer.param_groups[0]["betas"][0]
        while not self.checks["start"].done:
            self._one()
        self._sync()
        start = self.checks.pop("start").readings(self.beta1)
        start["start"] = {"steps": 0}      # the reference starts from the seed
        self.readings = {"start": start}
        first = m["window_check_step"]
        if first < self.done:
            raise ValueError(f"train_steps: window_check_step {first} comes "
                             f"before the window's first step {self.done}")
        self.checks["window"] = Checked(first, m["checked_steps"], self.names,
                                        self.params, pin)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _one(self):
        for c in self.checks.values():
            c.before(self.done, self.model, self.optimizer, self.params,
                     self.gen)
        out = self.step(self.batches[self.done % len(self.batches)], False,
                        self.gen)
        for c in self.checks.values():
            c.after(self.done, out, self.optimizer, self.params)
        self.done += 1
        return out

    def window(self, seconds: float) -> Dict:
        """Steps until ``seconds`` have passed and the window's checked
        steps are done."""
        steps = 0
        check = self.checks["window"]
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline or not check.done:
            out = self._one()
            steps += 1
        self._sync()
        t1 = time.perf_counter()
        self.readings["window"] = self.checks.pop("window").readings(
            self.beta1)
        finite = bool(torch.isfinite(out["loss"]))
        return {"window_s": t1 - t0, "attempted": steps,
                "failed": 0 if finite else steps,
                "samples": steps * self.batch}

    @contextlib.contextmanager
    def instrument(self):
        """Ranges around the model's forward (hooks) and the optimizer's
        step (its step hooks); the backward is read as what the autograd
        engine launches."""
        rf = torch.profiler.record_function
        opened = []

        def enter(name):
            def pre(*args):
                opened.append(rf(name))
                opened[-1].__enter__()
            return pre

        def leave(*args):
            opened.pop().__exit__(None, None, None)

        handles = [
            self.model.register_forward_pre_hook(enter("bench.forward")),
            self.model.register_forward_hook(leave),
            self.optimizer.register_step_pre_hook(enter("bench.optimizer")),
            self.optimizer.register_step_post_hook(leave)]
        try:
            yield
        finally:
            for h in handles:
                h.remove()

    def trace_units(self) -> Dict:
        for _ in range(self.mix["trace_steps"]):
            with torch.profiler.record_function("bench.step"):
                self._one()
        self._sync()
        return {"steps": self.mix["trace_steps"], "batch": self.batch}

    def release(self) -> None:
        del self.model, self.step, self.optimizer, self.params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, which: str, P=ref_model.FP32,
                  allow_tf32: bool = False) -> Dict:
        """The plain reference's readings of the checked steps ``which``
        ("start": from the seeded weights; "window": resumed from the
        program's parameters and moments before them)."""
        r = self.readings[which]
        first = r["start"]["steps"]
        n = self.mix["checked_steps"]
        batches = [self.batches[i % len(self.batches)]
                   for i in range(first, first + n)]
        gen = torch.Generator(self.device)
        if which == "start":
            state, moments = make_state(self.shapes, self.seed,
                                        self.device), None
            gen.manual_seed(stream_seed(self.seed, 3))
        else:
            state = {**make_state(self.shapes, self.seed, self.device),
                     **{k: v.to(self.device)
                        for k, v in r["start"]["params"].items()}}
            moments = r["start"]
            gen.set_state(r["gen_state"])
        return reference_readings(state, batches, self.cfg,
                                  self.mix["recipe"], gen, P, allow_tf32,
                                  moments)

    def check(self, log=print) -> Dict[str, float]:
        """The start's numbers under their names, the window's prefixed
        ``window_``."""
        values = {}
        for which, prefix in (("start", ""), ("window", "window_")):
            worst: Dict = {}
            got = compare(self.readings[which], self.reference(which), worst)
            values.update({prefix + k: v for k, v in got.items()})
            for what in ("grad_gap", "change_gap"):
                log(f"{prefix}{what}: worst leaves (leaf, gap, program, "
                    f"reference, median): {worst[what]}", file=sys.stderr)
        self.stack.close()
        return values
