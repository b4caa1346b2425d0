"""The plain reference against the served package's plain CPU path on the
gm_test widths, given the same state dict; the benchmark's seeded weights
against the package's own initialisation; and the reference's
independence from the package."""
import ast
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import weights
from benchmark.reference import msvm_unet, train
from benchmark.traffic import train_steps
from benchmark.tests.conftest import ROOT, TINY_CONFIG, TINY_TRAIN

REF_DIR = Path(ROOT) / "benchmark" / "reference"


def _port(seed=3, dtype=torch.float32):
    from ceigm_unet_tpu_torch.models import build_model
    model = build_model(enc_name="gm_test", device="cpu", dtype=dtype)
    shapes = {k: (tuple(v.shape), v.dtype)
              for k, v in model.state_dict().items()}
    state = weights.make_state(shapes, seed, torch.device("cpu"))
    model.load_state_dict(state)
    return model, state


def _moved(state, seed=4):
    """The state with every float leaf moved by noise, so BatchNorm
    statistics, biases and gates all take part."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in state.items():
        if v.is_floating_point():
            v = v + 0.05 * torch.randn(v.shape, generator=g)
            if k.endswith("running_var"):
                v = v.abs() + 0.5
        out[k] = v
    return out


def test_reference_logits_match_the_port_in_eval():
    model, state = _port()
    state = _moved(state)
    model.load_state_dict(state)
    x = torch.randn((2, 64, 64, 1), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x)
        ref = msvm_unet.forward(state, x, TINY_CONFIG["depths"])
    scale = ref.abs().max()
    assert scale > 0
    assert float((got - ref).abs().max() / scale) < 1e-5


def test_reference_step_matches_the_port_in_training():
    from ceigm_unet_tpu_torch.losses import dice_ce_loss
    model, state = _port()
    state = _moved(state)
    model.load_state_dict(state)
    model.train()
    g = torch.Generator().manual_seed(2)
    x = torch.randn((3, 64, 64, 1), generator=g)
    y = torch.randint(0, 9, (3, 64, 64), generator=g)
    r = TINY_TRAIN["recipe"]
    loss = dice_ce_loss(model(x, generator=torch.Generator().manual_seed(7)),
                        y, r["ce_weight"], r["dc_weight"])
    loss.backward()
    params = {k: v.clone().requires_grad_(True) for k, v in state.items()
              if train.is_parameter(k)}
    p = {**state, **params}
    masks = msvm_unet.draw_masks(3, r["drop_path_rate"],
                                 torch.Generator().manual_seed(7))
    ref = train.dice_ce(msvm_unet.forward(p, x, TINY_CONFIG["depths"],
                                          train=True, masks=masks),
                        y, r["ce_weight"], r["dc_weight"])
    ref.backward()
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    got = dict(model.named_parameters())
    norm = max(float(v.grad.abs().max()) for v in params.values())
    for k, v in params.items():
        assert float((got[k].grad - v.grad).abs().max()) <= 1e-4 * norm, k


def test_reference_adamw_matches_torch():
    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn(5, 3, generator=g)}
    q = torch.nn.Parameter(p["w"].clone())
    opt = torch.optim.AdamW([q], lr=1e-3, weight_decay=1e-2)
    mine = train.AdamW(p, 1e-2)
    for _ in range(3):
        grad = torch.randn(5, 3, generator=g)
        q.grad = grad.clone()
        opt.step()
        mine.step({"w": grad}, 1e-3)
    assert torch.allclose(q.detach(), p["w"], rtol=0, atol=1e-7)


@pytest.mark.parametrize("which", ["start", "window"])
def test_train_traffic_holds_the_port_to_the_reference_on_the_cpu(which):
    T = train_steps.Traffic(TINY_CONFIG, TINY_TRAIN, 2 ** 31 + 5,
                            torch.device("cpu"))
    T.setup()
    T.window(0.0)
    got = T.readings[which]
    assert got["start"]["steps"] == (0 if which == "start" else
                                     TINY_TRAIN["window_check_step"])
    values = train_steps.compare(got, T.reference(which))
    T.stack.close()
    assert values["loss_gap"] < 1e-5 and values["logit_gap"] < 1e-5
    assert values["grad_gap"] < 1e-2 and values["change_gap"] < 1e-2
    assert values["grad_diff"] < 1e-3


def test_reference_adamw_resumes_where_it_stopped():
    g = torch.Generator().manual_seed(0)
    grads = [torch.randn(4, 2, generator=g) for _ in range(4)]
    start = torch.randn(4, 2, generator=g)
    whole = train.AdamW({"w": start.clone()}, 1e-2)
    for i, grad in enumerate(grads):
        whole.step({"w": grad}, 1e-3 * (i + 1))
    part = train.AdamW({"w": start.clone()}, 1e-2)
    for i, grad in enumerate(grads[:2]):
        part.step({"w": grad}, 1e-3 * (i + 1))
    resumed = train.AdamW({"w": part.params["w"].clone()}, 1e-2, moments={
        "exp_avg": part.m, "exp_avg_sq": part.v, "steps": part.t})
    for i, grad in enumerate(grads[2:]):
        resumed.step({"w": grad}, 1e-3 * (i + 3))
    assert torch.equal(resumed.params["w"], whole.params["w"])


def test_seeded_weights_follow_the_port_init():
    from ceigm_unet_tpu_torch.models import build_model
    model = build_model(enc_name="gm_tiny", device="cpu")
    port = model.state_dict()
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in port.items()}
    mine = weights.make_state(shapes, 2 ** 32 + 11, torch.device("cpu"))
    assert list(mine) == list(port)
    random = 0
    for k, v in port.items():
        w = mine[k]
        assert w.shape == v.shape and w.dtype == v.dtype, k
        if weights._kind(k, v.shape)[0] in ("zeros", "ones", "a_logs"):
            assert torch.equal(w, v), k          # a constant leaf
        elif v.numel() >= 2000:
            random += 1
            assert math.isclose(float(w.std()), float(v.std()),
                                rel_tol=0.1), k
            assert float(w.abs().max()) <= 1.5 * float(v.abs().max()), k
    assert random > 100


def test_seeded_weights_depend_on_the_seed_alone():
    shapes = {"a.weight": ((64, 32), torch.float32),
              "b.x_proj_weight": ((1, 3, 16), torch.float32)}
    dev = torch.device("cpu")
    one = weights.make_state(shapes, 7, dev)
    again = weights.make_state(shapes, 7, dev)
    other = weights.make_state(shapes, 8, dev)
    assert all(torch.equal(one[k], again[k]) for k in shapes)
    assert not torch.equal(one["a.weight"], other["a.weight"])
    assert float(one["a.weight"].abs().max()) <= 0.04


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(REF_DIR.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_sources_import_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "ceigm_unet_tpu",
                       "ceigm_unet_tpu_torch"}


def test_reference_runs_without_loading_the_program():
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark.reference import msvm_unet, train, zoom\n"
        "import numpy as np\n"
        "x = zoom.zoom_cubic(np.random.rand(1, 48, 48).astype('f4'), (32, 32))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "ceigm_unet_tpu",
                         "ceigm_unet_tpu_torch"}
