"""Traffic kind ``volumes``: one client serving CT volumes one after another
through the served package's ``predict_volume``, as its inference command
walks a test split (a closed loop).

Parameters (the mix's file): ``dtype``, ``batch``, ``patch`` [h, w],
``slice_hw`` [H, W], ``depth_low`` / ``depth_high`` / ``depth_count`` (the
set of depths every seed serves, each seed in its own order),
``pool_slices`` (the host pool the volumes are cut from, as views),
``sample_volumes`` (how many served volumes are checked, drawn from the
seed over every volume of the window) and ``trace_volumes`` (volumes in a
traced window).

The check: the logits the window produced for the sampled volumes, kept by
a forward hook, against the plain reference's logits of the same raw
slices (scipy's cubic zoom, the normalisation, the reference forward in
float32); and each sampled class map against scipy's nearest zoom of the
argmax of those logits. ``logit_gap`` is the largest gap over the sample
as a share of the reference's largest |logit|; ``map_mismatch`` counts the
pixels that differ.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import msvm_unet as ref_model
from benchmark.reference import zoom as ref_zoom
from benchmark.weights import make_state, stream_seed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
REF_ROWS = 32          # slices per block of the reference forward


class Traffic:
    def __init__(self, config: Dict, mix: Dict, seed: int,
                 device: torch.device):
        self.cfg, self.mix, self.seed, self.device = config, mix, seed, device
        self.dtype = DTYPES[mix["dtype"]]
        self.batch = mix["batch"]
        self.patch = tuple(mix["patch"])
        self.hw = tuple(mix["slice_hw"])

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from ceigm_unet_tpu_torch.eval import volume
        from ceigm_unet_tpu_torch.models import build_model
        self.volume = volume
        self.model = build_model(
            num_classes=self.cfg["num_classes"], enc_name=self.cfg["enc_name"],
            dtype=self.dtype, device=self.device)
        shapes = {k: (tuple(v.shape), v.dtype)
                  for k, v in self.model.state_dict().items()}
        self.shapes = shapes
        self.model.load_state_dict(make_state(shapes, self.seed, self.device))
        self.model.eval()
        self.pool = inputs.volume_pool(self.mix["pool_slices"], self.hw,
                                       self.seed, self.device)
        self.order = inputs.VolumeOrder(
            inputs.depth_set(self.mix["depth_low"], self.mix["depth_high"],
                             self.mix["depth_count"]),
            self.mix["pool_slices"], self.seed)
        self.sample_rng = np.random.default_rng(stream_seed(self.seed, 5))
        k = self.mix["sample_volumes"]
        per = -(-self.mix["depth_high"] // self.batch)
        shape = (self.batch, *self.patch, self.cfg["num_classes"])
        pin = self.device.type == "cuda"
        self.bufs = [[torch.empty(shape, dtype=self.dtype, pin_memory=pin)
                      for _ in range(per)] for _ in range(k)]
        self.slots: List = [None] * k
        self.misshapen = set()
        self._capture = None
        self.model.register_forward_hook(self._keep)
        # warm-up: a volume of two batches, the second padded
        warm = self.pool[:self.batch + 1]
        for _ in range(2):
            self.volume.predict_volume(self.model, warm, self.patch,
                                       self.batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _keep(self, module, args, output):
        """Forward hook: the logits of a sampled volume's batches, copied
        to host buffers on the stream (the batch's own download waits for
        it)."""
        if self._capture is not None:
            slot, b = self._capture
            buf = self.bufs[slot][b] if b < len(self.bufs[slot]) else None
            if buf is None or buf.shape != output.shape:
                self.misshapen.add(slot)     # judged wrong in the check
            else:
                buf.copy_(output, non_blocking=True)
            self._capture = (slot, b + 1)

    def _slot(self, n: int):
        """Reservoir sampling over the window's volumes: the slot volume n
        (0-based) takes, or None."""
        k = len(self.slots)
        if n < k:
            return n
        j = int(self.sample_rng.integers(0, n + 1))
        return j if j < k else None

    # ------------------------------------------------------------ windows

    def _serve(self, start: int, depth: int):
        return self.volume.predict_volume(
            self.model, self.pool[start:start + depth], self.patch, self.batch)

    def window(self, seconds: float) -> Dict:
        """Serve volumes until ``seconds`` have passed."""
        lat, slices, failed, n = [], 0, 0, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            start, depth = self.order.next()
            slot = self._slot(n)
            self._capture = None if slot is None else (slot, 0)
            self.misshapen.discard(slot)
            ts = time.perf_counter()
            pred = self._serve(start, depth)
            lat.append(time.perf_counter() - ts)
            kept = self._capture[1] if self._capture else 0
            self._capture = None
            if pred.shape != (depth, *self.hw):
                failed += 1
            if slot is not None:
                # every batch of the volume left its logits, as served
                taken = slot not in self.misshapen and \
                    kept == -(-depth // self.batch)
                self.slots[slot] = (start, depth, pred, taken)
            slices += depth
            n += 1
        t1 = time.perf_counter()
        return {"window_s": t1 - t0, "attempted": n, "failed": failed,
                "slices": slices, "latency_s": lat}

    @contextlib.contextmanager
    def instrument(self):
        """Ranges around the calls into each layer, for a traced window:
        the encoder and the decoder (forward hooks), and the two zooms
        (wrappers put in the serving module's namespace)."""
        rf = torch.profiler.record_function
        handles, opened = [], {}

        def enter(name):
            def pre(module, args):
                opened[name] = rf(name)
                opened[name].__enter__()
            return pre

        def leave(name):
            def post(module, args, output):
                opened.pop(name).__exit__(None, None, None)
            return post

        parts = {"encoder": self.model.encoder.gm_encoder,
                 "decoder": self.model.decoder}
        for part, m in parts.items():
            handles.append(m.register_forward_pre_hook(enter(f"bench.{part}")))
            handles.append(m.register_forward_hook(leave(f"bench.{part}")))
        saved = (self.volume.zoom_slices, self.volume.zoom_slices_nearest)

        def wrap(fn, name):
            def ranged(*a, **kw):
                with rf(name):
                    return fn(*a, **kw)
            return ranged

        self.volume.zoom_slices = wrap(saved[0], "bench.zoom")
        self.volume.zoom_slices_nearest = wrap(saved[1], "bench.zoom_back")
        try:
            yield
        finally:
            self.volume.zoom_slices, self.volume.zoom_slices_nearest = saved
            for h in handles:
                h.remove()

    def trace_units(self) -> Dict:
        """Serve ``trace_volumes`` more volumes; what the per-layer readers
        count them by."""
        vols, slices, batches = 0, 0, 0
        for _ in range(self.mix["trace_volumes"]):
            start, depth = self.order.next()
            with torch.profiler.record_function("bench.volume"):
                self._serve(start, depth)
            vols += 1
            slices += depth
            batches += -(-depth // self.batch)
        return {"volumes": vols, "slices": slices, "batches": batches,
                "forwards": batches, "batch": self.batch}

    def release(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check

    def reference_logits(self, slices: np.ndarray,
                         P: ref_model.Precision = ref_model.FP32
                         ) -> torch.Tensor:
        """(N, H, W) raw slices -> (N, h, w, classes) float32 logits on the
        host, by the plain reference in blocks of rows."""
        state = make_state(self.shapes, self.seed, self.device)
        p = {k: v.float() for k, v in state.items()}
        out = []
        with torch.no_grad():
            for i in range(0, len(slices), REF_ROWS):
                x = ref_zoom.zoom_cubic(slices[i:i + REF_ROWS], self.patch)
                x = (torch.from_numpy(x).to(self.device) - 0.5) / 0.5
                out.append(ref_model.forward(
                    p, x[..., None], self.cfg["depths"], P=P).cpu())
        return torch.cat(out)

    def readings(self) -> List[Dict]:
        """Per sampled volume: its raw slices padded to whole batches, the
        kept logits, and the served map."""
        got = []
        for slot, entry in enumerate(self.slots):
            if entry is None:
                continue
            start, depth, pred, taken = entry
            nb = -(-depth // self.batch)
            if not taken:
                got.append(None)
                continue
            raw = np.zeros((nb * self.batch, *self.hw), np.float32)
            raw[:depth] = self.pool[start:start + depth]
            logits = torch.cat([self.bufs[slot][b] for b in range(nb)])
            got.append({"raw": raw, "depth": depth, "logits": logits,
                        "map": pred})
        return got

    def check(self, log=print, judged=None) -> Dict[str, float]:
        """logit_gap: the largest |program - reference| logit over the
        sample, over the reference's largest |logit|; logit_rms_gap: the
        root mean square of the difference over that of the reference;
        map_mismatch: pixels of the sampled maps that differ from the
        nearest zoom back of the argmax of their logits. ``judged`` (raw
        slices -> logits) puts another computation in the program's place
        for the logit numbers."""
        inf = float("inf")
        gap, top, sq, sq_ref, mismatch, n = 0.0, 0.0, 0.0, 0.0, 0, 0
        for r in self.readings():
            if r is None:
                gap = mismatch = inf
                continue
            ref = self.reference_logits(r["raw"])
            got = (r["logits"] if judged is None else judged(r["raw"])).float()
            if got.shape != ref.shape:
                gap = inf
                continue
            d = (got - ref).double()
            gap, top = max(gap, float(d.abs().max())), max(
                top, float(ref.abs().max()))
            sq, sq_ref = sq + float((d * d).sum()), sq_ref + float(
                (ref.double() ** 2).sum())
            back = ref_zoom.zoom_nearest(
                r["logits"].float().argmax(-1)[:r["depth"]].numpy(), self.hw)
            mismatch += int((back != r["map"]).sum()) if \
                back.shape == r["map"].shape else back.size
            n += 1
        if n == 0:                   # nothing sampled: nothing was shown
            return {"logit_gap": inf, "logit_rms_gap": inf,
                    "map_mismatch": inf}
        return {"logit_gap": gap / top if top > 0 else inf,
                "logit_rms_gap": (sq / sq_ref) ** 0.5 if sq_ref > 0 else inf,
                "map_mismatch": mismatch}
