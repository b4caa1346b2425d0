"""The port's H-sharded MSVM-UNet (``parallel/sp_model.py``,
``parallel/sp_ops.py`` and the routing in ``models/``) against the JAX
package, on the CPU.

The model is gm_test with 4 classes, fp32, in eval mode. Its weights are
the port's seeded init moved by seeded noise, so that every exchange
matters: BatchNorm's running statistics and the biases off (0, 1) and 0,
the decoder's convs outside its fronts scaled up 10x (logits of order
0.1), LGAG's and SAB's weights moved off their init, and DySample's two
offset convs 600x each, so that samples land two or more rows inside
another shard and past the image's border
(:func:`test_dysample_offsets_cross_shards_and_the_border`). They reach
JAX through its converter (``convert_msvm_unet_state_dict``) and come back
to the port through ``convert/jax_import.py`` ``state_dict_from_jax``.

Cases: (2, 64, 64, 1) on 2 shards and (1, 128, 128, 1) on 4; every stage
divides n there. The reference is JAX's own ``sp_forward`` and
``sp_value_and_grad`` over 2 and 4 of the 8 virtual devices of
``tests/conftest.py``, run in two spawned processes
(``tests/sp_model_jax.py``) so that their compiles overlap. The port's
ranks are spawned gloo groups of 2 and 4 (``parallel/dryrun.py`` ``start``;
task ``tests/torch_workers.py`` ``sp_model_cases``, 120 s join timeout
each), started while JAX compiles; the stacked form runs in this process.

Tolerances: logits at ``tests/test_torch_model.py``'s LOGITS_TOL (rtol
1e-3, atol 1e-3); the loss at rtol 1e-5; each parameter gradient at
``tests/test_torch_train.py``'s fp32 GRAD_TOL (rtol 2e-3, atol 2e-3 *
max|JAX grad|); the stacked form against the group form, the sharded port
against the unsharded port and each exchange against its unsharded op at
rtol 1e-5, atol 1e-5 * max|want|, except the parameter gradients of the
whole model, at ``tests/test_sp_ss2d.py``'s rtol 2e-4 (see
:func:`_close_grad`).
"""
import math
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import sp_model_jax
import torch_workers
from ceigm_unet_tpu.convert.torch_import import convert_msvm_unet_state_dict
from ceigm_unet_tpu_torch import losses
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.models import build_model, emcad, groupmamba, layers
from ceigm_unet_tpu_torch.ops.ffn import custom_ffn_fused
from ceigm_unet_tpu_torch.ops.grid_sample import dysample_grid_sample
from ceigm_unet_tpu_torch.ops.tapconv import lgag_gate
from ceigm_unet_tpu_torch.parallel import (dryrun, init_data_parallel, mesh,
                                           sp_forward, sp_forward_stacked,
                                           sp_ops, sp_value_and_grad,
                                           sp_value_and_grad_stacked)
from ceigm_unet_tpu_torch.parallel.ring_scan import _StackedRing
from ceigm_unet_tpu_torch.parallel.sp_context import sp_stacked

torch.set_num_threads(1)

JOIN_S = 120.0
CASES = {2: (2, 64, 64), 4: (1, 128, 128)}        # n -> (B, H, W)
RANKS = tuple(CASES)
DEPTHS = (1, 1, 1, 1)
LOGITS_TOL = dict(rtol=1e-3, atol=1e-3)
GRAD_TOL = 2e-3
EXCHANGE = (2, 8, 3, 4)                           # (B, H, W, C)
OFFSET_SCALE, GATE_NOISE = 600.0, 0.2


def _close(got, want, rtol=1e-5, **kw):
    """rtol 1e-5, atol 1e-5 * max|want|: the same function with its sums
    in another order."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * np.abs(want).max(), **kw)


def _close_grad(got, want, **kw):
    """A parameter gradient of the whole model against another form of
    it: ``tests/test_sp_ss2d.py``'s rtol 2e-4, with atol 2e-4 *
    max|want|. The sharded model's scans are another algorithm than the
    unsharded one's (the ring scan's K11 passes against K1 and K8), and the
    stacked form sums its loss and its shares in another order than the
    ranks; an element that sums 10^4-10^5 fp32 terms down to a few percent
    of its tensor's largest then moves up to ~3.5e-4 of itself (rtol 1e-5
    fails on a dt projection, a D, a conv bias), while its difference stays
    within ~3e-5 of the tensor's largest element."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max(), **kw)


def _weights(seed=20):
    """(JAX variables, the port's state dict): see the module
    docstring."""
    rng = np.random.default_rng(seed)
    model = build_model(num_classes=4, enc_name="gm_test", device="cpu",
                        seed=seed)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    noise = lambda v, s: v + s * rng.standard_normal(v.shape).astype(
        np.float32)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = noise(v, 0.2)
        elif k.endswith("running_var"):
            sd[k] = v + 0.5 * rng.random(v.shape).astype(np.float32)
        elif k.endswith(".bias") or k.endswith(".x"):
            sd[k] = noise(v, 0.05)
        elif ".offset." in k:
            sd[k] = v * OFFSET_SCALE
        elif (".lgag" in k or ".spatial_attention." in k) \
                and k.endswith("weight"):
            sd[k] = noise(v, GATE_NOISE)
        elif k.startswith("decoder.") and ".cm_layer." not in k \
                and v.ndim == 4:
            sd[k] = 10.0 * v
    variables = jax.tree_util.tree_map(
        np.asarray, convert_msvm_unet_state_dict(sd, depths=DEPTHS))
    return variables, jax_import.state_dict_from_jax(variables, depths=DEPTHS)


def _inputs(n):
    B, H, W = CASES[n]
    rng = np.random.default_rng(n)
    x = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    return x, rng.integers(0, 4, (B, H, W)).astype(np.int32)


def _exchange_cases(n):
    """Each exchange's (x, cotangent per shard, aux) at EXCHANGE's shape:
    the halo's 5 rows above reach three shards at H/n 2; the sample grid
    (2 groups) reaches past the border."""
    rng = np.random.default_rng(100 + n)
    B, H, W, C = EXCHANGE
    hl = H // n
    x = rng.standard_normal(EXCHANGE).astype(np.float32)
    ct = lambda *s: rng.standard_normal((n, *s)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (B, 2 * H, 2 * W, 2, 2)).astype(np.float32)
    return {"halo_zero": (x, ct(B, hl + 8, W, C), None),
            "halo_edge": (x, ct(B, hl + 3, W, C), None),
            "sum": (x, ct(B, C), None), "max": (x, ct(B, C), None),
            "min": (x, ct(B, C), None),
            "gather": (x, ct(B, 2 * hl, 2 * W, C), grid)}


def _model(sd, **kw):
    model = build_model(num_classes=4, enc_name="gm_test", device="cpu", **kw)
    jax_import.load_numpy_state_dict(model, sd)
    return model


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def launched(weights):
    """JAX's two meshes in two spawned processes, then the port's two
    groups; all run at once."""
    variables, sd = weights
    pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
        "spawn"))
    jobs = {n: pool.submit(sp_model_jax.reference, variables, *_inputs(n), n)
            for n in RANKS}
    groups = {n: dryrun.start(n, torch_workers.sp_model_cases,
                              (sd, *_inputs(n), _exchange_cases(n)))
              for n in RANKS}
    yield jobs, groups
    pool.shutdown(cancel_futures=True)
    for g in groups.values():       # a group a failed test left running
        if any(p.is_alive() for p in g.procs):
            with pytest.raises(Exception):
                g.join(0.0)


@pytest.fixture(scope="module")
def ranks(launched):
    return {n: launched[1][n].join(JOIN_S) for n in RANKS}


@pytest.fixture(scope="module")
def jax_side(launched, weights):
    """n -> (logits, loss, the gradients by the port's parameter names)."""
    variables = weights[0]
    out = {}
    for n, job in launched[0].items():
        logits, loss, grads = job.result()
        sd = jax_import.state_dict_from_jax(
            {"params": grads, "batch_stats": variables["batch_stats"]},
            depths=DEPTHS)
        out[n] = logits, loss, sd
    return out


@pytest.fixture(scope="module")
def port_side(weights):
    """n -> the unsharded port's and the stacked form's (logits, loss,
    grads)."""
    model = _model(weights[1])
    out = {}
    for n in RANKS:
        x, y = [torch.from_numpy(a) for a in _inputs(n)]
        y = y.long()
        shards = lambda t: t.unflatten(1, (n, -1)).movedim(1, 0)
        logits = model(x)
        loss = losses.dice_ce_loss(logits, y, ce_weight=0.4, dc_weight=0.6)
        names = [k for k, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        plain = (logits.detach().numpy(), loss.item(),
                 {k: (np.zeros(p.shape, np.float32) if g is None
                      else g.numpy()) for k, p, g in
                  zip(names, model.parameters(), grads)})
        with torch.no_grad():
            st_logits = sp_forward_stacked(model, shards(x))
        st_loss, st_grads = sp_value_and_grad_stacked(model, shards(x),
                                                      shards(y))
        out[n] = plain, (st_logits.movedim(0, 1).flatten(1, 2).numpy(),
                         st_loss.item(),
                         {k: g.numpy() for k, g in st_grads.items()})
    return out


def _gathered(results, key="logits"):
    return np.concatenate([r[key] for r in results], axis=1)


@pytest.mark.parametrize("n", RANKS)
def test_sp_forward_matches_jax_and_the_unsharded_port(jax_side, ranks,
                                                       port_side, n):
    got = _gathered(ranks[n])
    want = jax_side[n][0]
    assert got.shape == (*CASES[n], 4) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **LOGITS_TOL)
    plain, stacked = port_side[n]
    _close(got, plain[0])
    _close(stacked[0], got)


@pytest.mark.parametrize("n", RANKS)
def test_sp_value_and_grad_matches_jax(jax_side, ranks, n):
    _, want_loss, want = jax_side[n]
    first = ranks[n][0]
    np.testing.assert_allclose(first["loss"], want_loss, rtol=1e-5)
    assert set(first["grads"]) == {k for k, _ in _model(
        _weights()[1]).named_parameters()}
    for r in ranks[n][1:]:              # replicated: one all-reduce
        assert r["loss"] == first["loss"]
        for k, g in r["grads"].items():
            assert np.array_equal(g, first["grads"][k]), k
    for k, g in first["grads"].items():
        w = want[k]
        np.testing.assert_allclose(
            g, w, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("n", RANKS)
def test_stacked_and_unsharded_equal_the_group(ranks, port_side, n):
    plain, stacked = port_side[n]
    group = ranks[n][0]
    for other in (stacked, plain):
        np.testing.assert_allclose(other[1], group["loss"], rtol=1e-5)
        for k, g in group["grads"].items():
            _close_grad(other[2][k], g, err_msg=k)


def _unsharded(name, x, n, aux):
    """The unsharded op of an exchange: each shard's output, from the
    whole x (B, H, W, C)."""
    hl = x.shape[1] // n
    if name == "halo_zero":
        p = F.pad(x, (0, 0, 0, 0, 5, 3))
        return [p[:, i * hl:i * hl + hl + 8] for i in range(n)]
    if name == "halo_edge":
        p = x[:, torch.arange(-1, x.shape[1] + 2).clamp(0, x.shape[1] - 1)]
        return [p[:, i * hl:i * hl + hl + 3] for i in range(n)]
    if name == "gather":
        y = dysample_grid_sample(x, aux)
        return [y[:, i * 2 * hl:(i + 1) * 2 * hl] for i in range(n)]
    red = {"sum": lambda t: t.mean((1, 2)), "max": lambda t: t.amax((1, 2)),
           "min": lambda t: t.amin((1, 2))}[name]
    return [red(x)] * n


@pytest.mark.parametrize("name", ["halo_zero", "halo_edge", "sum", "max",
                                  "min", "gather"])
@pytest.mark.parametrize("n", RANKS)
def test_each_exchange_matches_its_unsharded_op(ranks, n, name):
    """Forward and the gradient of sum_i <out_i, ct_i>, on the ranks and
    on n stacked shards."""
    cases = _exchange_cases(n)
    x, cts, aux = cases[name]
    xt = torch.from_numpy(x).requires_grad_()
    want = _unsharded(name, xt, n, None if aux is None
                      else torch.from_numpy(aux))
    sum(((w * torch.from_numpy(c)).sum() for w, c in zip(want, cts))
        ).backward()
    hl = x.shape[1] // n
    want_gx = xt.grad.numpy()
    stack = lambda a: torch.from_numpy(a).unflatten(1, (n, -1)).movedim(
        1, 0).flatten(0, 1)
    fn = torch_workers.sharded_exchanges()[name]
    xs = stack(x).requires_grad_()
    y = fn(xs, _StackedRing(n), None if aux is None else stack(aux))
    (y * torch.from_numpy(cts).flatten(0, 1)).sum().backward()
    st_out = y.detach().unflatten(0, (n, -1)).numpy()
    st_gx = xs.grad.unflatten(0, (n, -1)).numpy()
    for i in range(n):
        w = want[i].detach().numpy()
        w_gx = want_gx[:, i * hl:(i + 1) * hl]
        out, gx = ranks[n][i]["exchanges"][name]
        for got_out, got_gx in ((out, gx), (st_out[i], st_gx[i])):
            _close(got_out, w, err_msg=f"{name} shard {i}")
            _close(got_gx, w_gx, err_msg=f"{name} shard {i} grad")


def _sources(n):
    """The element counts of DySample's three source maps on one rank:
    gm_test's decoder upsamples stages 4, 3 and 2 (64, 48, 32 channels)."""
    B, H, W = CASES[n]
    return sorted(B * H // s // n * W // s * c
                  for s, c in ((32, 64), (16, 48), (8, 32)))


@pytest.mark.parametrize("n", RANKS)
def test_only_dysample_sources_are_gathered_whole(ranks, n):
    """Per forward, per rank: one all-gather of each DySample source map,
    and every other all-gather smaller than the smallest of them (the ring
    scan's (decay, state) summaries and the pools' extrema); the counts of
    each exchange (see the comment)."""
    for r in ranks[n]:
        big = sorted(k for k in r["gathered"] if k >= min(_sources(n)))
        assert big == _sources(n), (r["gathered"], _sources(n))
        # 11 quad blocks (4 encoder, 7 decoder): 4 ring summaries each; 4
        # MultiScaleCABs: max and min; 3 DySamples. All-reduces: 11 SE
        # pools, 4 CAB means. Halos: 4 Stem convs, 3 DownSamples, 4
        # Pvt2Ffn and 11 quad depthwise convs, 4 x 3 SAB convs, 3 EUCB2
        # and 3 DySample offset convs, 7 CustomFfns, 3 LGAGs, the last
        # upsample. All-to-alls: 2 per column-major direction per block.
        assert r["calls"] == {"all_gather": 44 + 8 + 3, "all_reduce": 15,
                              "batch_isend_irecv": 4 + 3 + 4 + 11 + 12 + 3
                              + 3 + 7 + 3 + 1,
                              "all_to_all_single": 44}, r["calls"]


def test_dysample_offsets_cross_shards_and_the_border(weights):
    """In the unsharded forward of each case, at each DySample, some
    samples land two or more rows inside a shard other than their output
    row's, and some past the image's border."""
    grids = []

    def spy(x, grid):
        grids.append((x.shape[1], grid.detach()))
        return dysample_grid_sample(x, grid)
    model = _model(weights[1])
    for n in RANKS:
        grids.clear()
        with pytest.MonkeyPatch.context() as mp, torch.no_grad():
            mp.setattr(emcad, "dysample_grid_sample", spy)
            model(torch.from_numpy(_inputs(n)[0]))
        assert len(grids) == 3
        for H, grid in grids:
            rows = (grid[..., 1] + 1.0) * H / 2.0 - 0.5     # source rows
            hl, Ho = H // n, grid.shape[1]
            own = (torch.arange(Ho) // (Ho // n)).view(1, -1, 1, 1) * hl
            inside = (rows <= own - 2) | (rows >= own + hl + 1)
            assert inside.float().mean() > 0.05, (n, H)
            past = (rows < 0) | (rows > H - 1)
            assert 0 < past.float().mean() < 0.95, (n, H)


# the parent's forwards of the modules whose forward the routing changed,
# as they were before it: outside the context the model must compute
# exactly what they compute

def _parent_conv2d(self, x):
    b = None if self.bias is None else self.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                 self.stride, self.padding, self.dilation, self.groups)
    return y.permute(0, 2, 3, 1)


def _parent_custom_ffn(self, x):
    B, H, W, C = x.shape
    inck, incb = self.custom.composite(torch.float32)
    y = custom_ffn_fused(
        x.reshape(B, H * W, C), self.fc1.weight.t(), self.fc1.bias,
        self.dwconv.dwconv.weight.permute(2, 3, 1, 0),
        self.dwconv.dwconv.bias, inck, incb, self.fc2.weight.t(),
        self.fc2.bias, H, W, 3 * self.custom.g)
    return y.reshape(B, H, W, C)


def _parent_bilinear_upsample(x, scale):
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def _parent_gm_layer(self, x):
    xn = self.norm(x)
    zc = self.fc2(torch.relu(self.fc1(xn.mean(dim=(1, 2)))))
    affinity = torch.sigmoid(zc)[:, None, None, :]
    y = self.scan_groups(xn) * self.skip_scale.to(x.dtype) * xn
    return self.proj(self.norm(y * affinity))


def _parent_lgag(self, g, x):
    if not self.training:
        return lgag_gate(g, x, *self.folded())
    raise AssertionError("eval only here")


def _parent_cab(self, x):
    avg = x.mean(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    mn = x.amin(dim=(1, 2), keepdim=True)
    comb = torch.cat([self.conv1(avg), self.conv2_2(self.conv2_1(mx)),
                      self.conv3(mn)], dim=-1)
    return torch.sigmoid(self.fc(comb) + x)


def _parent_dysample(self, x):
    s, g = self.SCALE, self.GROUPS
    B, H, W, C = x.shape
    off = self.offset(x) / g + self.init_pos.to(x.dtype)
    off = off.reshape(B, H, W, 2, g, s, s)
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=x.device)
    bw = ar(W) + torch.sin(math.pi * (ar(W) + 1) / W)
    bh = ar(H) + torch.sin(math.pi * (ar(H) + 1) / H)
    cx = 2.0 * (bw[None, None, :, None, None, None] + off[..., 0, :, :, :]) \
        / W - 1.0
    cy = 2.0 * (bh[None, :, None, None, None, None] + off[..., 1, :, :, :]) \
        / H - 1.0
    shuffle = lambda c: c.permute(0, 1, 4, 2, 5, 3).reshape(
        B, H * s, W * s, g)
    grid = torch.stack([shuffle(cx), shuffle(cy)], dim=-1)
    return self.eu(emcad.dysample_grid_sample(x, grid))


def _logits_and_grads(model, x, y):
    logits = model(x)
    loss = losses.dice_ce_loss(logits, y, ce_weight=0.4, dc_weight=0.6)
    loss.backward()
    grads = [p.grad.clone() for p in model.parameters() if p.grad is not None]
    model.zero_grad(set_to_none=True)
    return logits.detach(), grads


def test_outside_the_context_the_model_is_the_parent_model(weights):
    """gm_test's logits and gradients outside the context equal bitwise
    those of the parent's forwards, and no exchange runs there."""
    model = _model(weights[1])
    x, y = [torch.from_numpy(a) for a in _inputs(2)]
    with pytest.MonkeyPatch.context() as mp:
        def refuse(*a, **kw):
            raise AssertionError("an exchange ran outside the context")
        for name in ("conv2d", "row_halo", "mean_hw", "amax_hw", "amin_hw",
                     "shard_rows", "sample_rows", "rows_with_halo",
                     "upsample_rows"):
            mp.setattr(sp_ops, name, refuse)
        got = _logits_and_grads(model, x, y.long())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.Conv2d, "forward", _parent_conv2d)
        mp.setattr(layers.CustomFfn, "forward", _parent_custom_ffn)
        mp.setattr(emcad, "bilinear_upsample", _parent_bilinear_upsample)
        mp.setattr(groupmamba.GroupMambaLayer, "forward", _parent_gm_layer)
        mp.setattr(emcad.LGAG, "forward", _parent_lgag)
        mp.setattr(emcad.MultiScaleCAB, "forward", _parent_cab)
        mp.setattr(emcad.DySample, "forward", _parent_dysample)
        want = _logits_and_grads(model, x, y.long())
    assert torch.equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_unsupported_cases_raise(weights, ranks):
    model = _model(weights[1])
    with pytest.raises(ValueError, match=r"2 shards do not divide stage 4's "
                       r"map H 3 x W 3 \(input 96x96\)"):
        sp_forward_stacked(model, torch.zeros(2, 1, 48, 96, 1))
    conv = layers.Conv2d(4, 4, 3, 2, 1)
    with sp_stacked(2), pytest.raises(
            ValueError, match=r"stride 2 does not divide the shard's H/n = "
                              r"3 \(H 6, n 2\)"):
        conv(torch.zeros(2, 3, 8, 4))
    with pytest.raises(RuntimeError, match="no process group"):
        sp_forward(model, torch.zeros(1, 32, 64, 1))
    with pytest.raises(RuntimeError, match="no process group"):
        sp_value_and_grad(model, torch.zeros(1, 32, 64, 1),
                          torch.zeros(1, 32, 64).long())
    quant = _model(weights[1], quant_scan=True)
    with pytest.raises(ValueError, match="quant_scan"):
        sp_forward_stacked(quant, torch.zeros(2, 1, 32, 64, 1))
    with pytest.raises(ValueError, match="training mode"):
        sp_forward_stacked(model.train(), torch.zeros(2, 1, 32, 64, 1))
    for n in RANKS:
        for r in ranks[n]:
            assert r["train"] is not None and "training mode" in r["train"]


def test_a_group_of_one_equals_one_stacked_shard(weights, tmp_path):
    """A gloo group of one in this process: ``sp_forward`` and the loss
    equal the 1-shard stacked forms bitwise (``chip_smoke.py`` phase 25 (d)
    on the card); the gradients differ in the last bits (the island's
    einsum and sums run with and without the stacked axis)."""
    model = _model(weights[1])
    x, y = [torch.from_numpy(a) for a in _inputs(2)]
    y = y.long()
    try:
        init_data_parallel(1, device="cpu", store_path=str(tmp_path / "s"))
        with torch.no_grad():
            got = sp_forward(model, x)
            want = sp_forward_stacked(model, x[None])[0]
        loss, grads = sp_value_and_grad(model, x, y)
        st_loss, st_grads = sp_value_and_grad_stacked(model, x[None], y[None])
    finally:
        torch.distributed.destroy_process_group()
    assert mesh.active_group() is None
    assert torch.equal(got, want)
    assert torch.equal(loss, st_loss)
    assert grads.keys() == st_grads.keys()
    for k, g in grads.items():
        _close_grad(g.numpy(), st_grads[k].numpy(), err_msg=k)


@pytest.mark.parametrize("n", RANKS)
def test_the_kernel_routes_shard_too(weights, n):
    """``dwconv="kernel"`` (the island's depthwise conv on its haloed rows)
    and ``dysample_grouped=False`` (the per-group sampler on the gathered
    source): the stacked form against the unsharded port."""
    model = _model(weights[1], dwconv="kernel", dysample_grouped=False)
    x = torch.from_numpy(_inputs(n)[0])
    with torch.no_grad():
        want = model(x)
        got = sp_forward_stacked(model, x.unflatten(1, (n, -1)).movedim(1, 0))
    _close(got.movedim(0, 1).flatten(1, 2).numpy(), want.numpy())
