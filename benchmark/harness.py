"""Runs one cell of the benchmark once and builds its result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own under ``benchmark/``, found by the name
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration's sizes;
- ``traffic/<traffic>.json``: a traffic mix, the parameters that its kind's
  generator ``traffic/<kind>.py`` reads;
- ``workloads/<cell>.json``: the cell (configuration, traffic, chips, why)
  and the limits of the numbers its check compares;
- ``metrics/<metric>.py``: one metric's reader (``UNIT``, ``BETTER``, for a
  per-layer metric ``LAYER`` and ``MOVES``, and ``read(ctx)``, which
  returns None where it finds nothing to read).

A run: set-up (the program built, weights and inputs made from the seed,
the cell's shapes warmed up), the timed window, with ``--trace 1`` a traced
window besides, then the program's state freed and the check against the
plain reference.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level modules no process of a run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "ceigm_unet_tpu")


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> Dict:
    return read_json(root / "BENCHMARK.json")


def workload(name: str, bench: Path = BENCH) -> Dict:
    return {"name": name, **read_json(bench / "workloads" / f"{name}.json")}


def config(name: str, bench: Path = BENCH) -> Dict:
    return read_json(bench / "configs" / f"{name}.json")


def mix(name: str, bench: Path = BENCH) -> Dict:
    return read_json(bench / "traffic" / f"{name}.json")


def load_module(path: Path) -> ModuleType:
    mod_name = "benchmark_file_" + "".join(
        c if c.isalnum() else "_" for c in str(path.relative_to(BENCH.parent)
                                               if path.is_relative_to(
                                                   BENCH.parent) else path))
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    sys.modules[mod_name] = mod
    s.loader.exec_module(mod)
    return mod


def metric(name: str, bench: Path = BENCH) -> ModuleType:
    return load_module(bench / "metrics" / f"{name}.py")


def traffic_kind(kind: str, bench: Path = BENCH) -> ModuleType:
    return load_module(bench / "traffic" / f"{kind}.py")


def cell_metrics(spec: Dict, cell: str, trace: bool) -> List[str]:
    """The metrics a run of ``cell`` reports: with trace off its end-to-end
    metrics, with trace on its per-layer metrics (those listing the cell,
    or, without a list, those moving a metric the cell reports)."""
    e2e = [m["name"] for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    return [m["name"] for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_config(cfg: Dict) -> None:
    """The configuration file states what the program runs."""
    from ceigm_unet_tpu_torch.models.emcad import EMCAD
    from ceigm_unet_tpu_torch.models.groupmamba import GROUPMAMBA_CONFIGS
    run = GROUPMAMBA_CONFIGS[cfg["enc_name"]]
    for k, v in run.items():
        v = list(v) if isinstance(v, (tuple, list)) else v
        if v != cfg[k]:
            raise ValueError(f"{cfg['name']}: the program's {k} is {v}, "
                             f"the configuration's {cfg[k]}")
    if list(EMCAD.FRONT_DEPTHS) != cfg["decoder_front_depths"]:
        raise ValueError(f"{cfg['name']}: decoder Front depths "
                         f"{EMCAD.FRONT_DEPTHS}")


def _device_info(device: torch.device, peak: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": device.type, "kind": device.type, "count": 1,
            "memory_peak_bytes": int(peak)}


def _peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def traced_window(traffic, device: torch.device):
    """The traffic's traced units under torch.profiler, inside the range
    ``bench.window``; the launch counts of the hand-written kernels over
    it."""
    from ceigm_unet_tpu_torch.ops import _build
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.trace import Trace
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = dict(_build.launch_counts)
    with profile(activities=acts) as prof:
        with traffic.instrument(), record_function("bench.window"):
            counts = traffic.trace_units()
    launches = {k: v - before.get(k, 0)
                for k, v in _build.launch_counts.items()}
    return Trace(prof), {**counts, "launches": launches}


def load_cell(name: str, bench: Path = BENCH):
    """(cell, its configuration, its traffic mix) by the cell's name."""
    cell = workload(name, bench)
    return cell, config(cell["config"], bench), mix(cell["traffic"], bench)


def run_cell(cell: Dict, cfg: Dict, mx: Dict, seed: int, seconds: float,
             trace: bool, device: torch.device, spec: Dict, t_start: float,
             log=print):
    """One run of ``cell``. Returns (result line, [(name, value, limit)])."""
    check_config(cfg)
    traffic = traffic_kind(mx["kind"]).Traffic(cfg, mx, seed, device)
    traffic.setup()
    setup_peak = _peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    record = traffic.window(seconds)
    record["peak_bytes"] = _peak(device)
    t = time.perf_counter()
    tr, traced = (traced_window(traffic, device) if trace else (None, None))
    peak = max(setup_peak, _peak(device))
    traffic.release()
    t_check = time.perf_counter()
    values = traffic.check(log)
    log(f"run: the check's numbers (compared: those with limits): {values}",
        file=sys.stderr)
    checks = [(k, values.get(k, math.inf), lim)
              for k, lim in cell["limits"].items()]
    log(f"run: set-up {setup_s:.3f} s, window {record['window_s']:.3f} s, "
        f"trace {t_check - t:.3f} s, check {time.perf_counter() - t_check:.3f}"
        f" s", file=sys.stderr)
    ctx = SimpleNamespace(record=record, setup_s=setup_s, trace=tr,
                          traced=traced, config=cfg, mix=mx, cell=cell)
    metrics = {}
    for name in cell_metrics(spec, cell["name"], trace):
        mod = metric(name)
        value = mod.read(ctx)
        if value is None:
            log(f"{name}: nothing to read", file=sys.stderr)
            continue
        metrics[name] = {"value": float(value), "unit": mod.UNIT}
    device_info = _device_info(device, peak)
    correct = all(v <= lim for _, v, lim in checks) and record["failed"] == 0
    result = {"correct": bool(correct), "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in tr.top_ops()],
                               "idle_gaps": [list(x) for x in tr.idle_gaps()]}
    result["checks"] = {n: {"value": _num(v), "limit": lim}
                        for n, v, lim in checks}
    return result, checks


def _num(v: float):
    return v if math.isfinite(v) else str(v)
