"""The yardstick's arithmetic: the architecture's FLOPs against a count of
the reference's own products, and the readers of ``mfu.*``,
``k1_roofline.serve`` and ``k8_roofline.train`` at one shape each against
values worked by hand."""
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness
from benchmark.reference import msvm_unet
from benchmark.tests.conftest import TINY_CONFIG


def _state(cfg):
    from ceigm_unet_tpu_torch.models import build_model
    return build_model(enc_name=cfg["enc_name"], device="cpu").state_dict()


@pytest.mark.parametrize("img", [32, 64])
def test_forward_flops_equal_the_reference_products(img):
    state = _state(TINY_CONFIG)
    x = torch.zeros((1, img, img, 1))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        msvm_unet.forward(state, x, TINY_CONFIG["depths"])
    assert flops.forward_flops(TINY_CONFIG, img) == counter.get_total_flops()


def test_gm_tiny_flops_and_blocks():
    cfg = harness.config("gm_tiny")
    blocks = flops.quad_blocks(cfg, 224)
    assert len(blocks) == 19 + 7
    assert blocks[:3] == [(56, 64)] * 3 and blocks[-2:] == [(56, 64)] * 2
    assert flops.forward_flops(cfg, 224) == 12475521518


def test_k1_and_k8_bytes_by_hand():
    # K1, b128 bf16, 56x56, C 64: u, dt and out of 128*3136*64 elements at
    # 2 bytes, B and C of 128*4*3136 at 2 bytes, 5 x 64 fp32 constants
    el = 128 * 3136 * 64
    assert flops.k1_bytes(128, 56, 64, 2) == 2 * (3 * el + 2 * 128 * 4 * 3136) \
        + 20 * 64 == 160564480
    # K8, b48 fp32, 56x56, C 96: a, b read and h written, 4 bytes each
    assert flops.k8_bytes(48, 56, 96) == 12 * 48 * 3136 * 96 == 173408256
    assert flops.bound_seconds(3.35e12) == 1.0


class FakeTrace:
    def __init__(self, ops, window_s=2.0):
        self.ops, self.window_s = ops, window_s

    def count(self, match):
        return sum(1 for n, _ in self.ops if match(n))

    def device_s(self, match=None):
        return sum(s for n, s in self.ops if match is None or match(n))


def _ctx(trace, traced, cfg, mix):
    return SimpleNamespace(trace=trace, traced=traced, config=cfg, mix=mix)


def test_k1_roofline_by_hand():
    cfg = dict(TINY_CONFIG)
    mix = {"patch": [32, 32], "dtype": "bfloat16"}
    blocks = flops.quad_blocks(cfg, 32)        # 4 encoder + 7 decoder
    assert len(blocks) == 11
    bound = sum(flops.k1_bytes(4, s, c, 2) for s, c in blocks) / 3.35e12
    ops = [("void quad_scan_ln_kernel<bf16>", bound / 11)] * 22 + \
        [("other", 1.0)]
    mod = harness.metric("k1_roofline.serve")
    traced = {"forwards": 2, "batch": 4, "launches": {"quad_scan_ln": 22}}
    assert mod.read(_ctx(FakeTrace(ops), traced, cfg, mix)) == \
        pytest.approx(100.0)
    traced["launches"]["quad_scan_ln"] = 21     # the counter disagrees
    assert mod.read(_ctx(FakeTrace(ops), traced, cfg, mix)) is None


def test_k8_roofline_by_hand():
    cfg = dict(TINY_CONFIG)
    mix = {"img": 32}
    blocks = flops.quad_blocks(cfg, 32)
    bound = 2 * sum(flops.k8_bytes(4, s, c) for s, c in blocks) / 3.35e12
    ops = [("void scan2d_kernel<4>", bound / 22)] * 22   # one step
    mod = harness.metric("k8_roofline.train")
    traced = {"steps": 1, "batch": 4, "launches": {"scan2d": 22}}
    assert mod.read(_ctx(FakeTrace(ops), traced, cfg, mix)) == \
        pytest.approx(100.0)
    ops = ops[:-1]                                     # one launch missing
    assert mod.read(_ctx(FakeTrace(ops), traced, cfg, mix)) is None


def test_mfu_by_hand():
    cfg = harness.config("gm_tiny")
    f = 12475521518
    serve = harness.metric("mfu.serve").read(_ctx(
        FakeTrace([], window_s=2.0), {"slices": 300}, cfg,
        {"patch": [224, 224], "dtype": "bfloat16"}))
    assert serve == pytest.approx(100 * 300 * f / 2.0 / 989e12)
    train = harness.metric("mfu.train").read(_ctx(
        FakeTrace([], window_s=4.0), {"steps": 2, "batch": 48}, cfg,
        {"img": 224, "dtype": "float32"}))
    assert train == pytest.approx(100 * 3 * 2 * 48 * f / 4.0 / 67e12)
