"""The port's H-sharded legacy MSVM-UNet (``MSVMUNetLegacy``: the VMamba
encoder and the published decoder, whose SS2D scans four directions over
all channels; ``parallel/sp_ss2d.py`` ``ss2d_scan`` and the routing in
``models/ss2d.py`` and ``models/vmamba.py``) against the JAX package, on
the CPU.

The model is vssm_test with 9 classes, fp32, in eval mode. Its weights are
the port's seeded init with the biases, BatchNorm's statistics and ``Ds``
moved by seeded noise and every ``A_logs`` drawn from U(-6, 0.5), so that
some channels carry their state across the whole map (a decay within 3e-4
of 1 per step) and the ring's carry matters. They reach JAX through its
converter (``convert_msvm_legacy_state_dict``) and come back to the port
through ``convert/jax_import.py`` ``legacy_state_dict_from_jax``.

Cases: (2, 64, 64, 1) on 2 shards and (1, 128, 128, 1) on 4; every stage
divides n there (vssm_test's stage 4 is 2x2 at 64²). The reference is
JAX's own ``sp_forward`` and ``sp_value_and_grad`` over 2 and 4 of the 8
virtual devices of ``tests/conftest.py``, in two spawned processes
(``tests/sp_model_jax.py`` ``legacy_reference``); JAX leaves this model's
scans to GSPMD. The port's ranks are spawned gloo groups of 2 and 4
(``parallel/dryrun.py`` ``start``; task ``tests/torch_workers.py``
``sp_legacy_cases``, 120 s join timeout each), started while JAX compiles;
the stacked form runs in this process.

Tolerances: those of ``tests/test_torch_sp_model.py``: logits at
``LOGITS_TOL`` (rtol 1e-3, atol 1e-3); the loss at rtol 1e-5; each
parameter gradient at ``GRAD_TOL`` (rtol 2e-3, atol 2e-3 * max|JAX
grad|); the sharded port against the unsharded port and the stacked form
against the group at rtol 1e-5, atol 1e-5 * max|want|, and their parameter
gradients at ``_close_grad``'s rtol 2e-4.
"""
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import sp_model_jax
import torch_workers
from ceigm_unet_tpu.convert.vssm_import import convert_msvm_legacy_state_dict
from ceigm_unet_tpu_torch import losses
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.models import build_legacy_model, ss2d, vmamba
from ceigm_unet_tpu_torch.models.ss2d import SS2D
from ceigm_unet_tpu_torch.parallel import (dryrun, init_data_parallel, mesh,
                                           sp_forward, sp_forward_stacked,
                                           sp_ops, sp_value_and_grad,
                                           sp_value_and_grad_stacked)
from ceigm_unet_tpu_torch.parallel.sp_context import sp_stacked
from ceigm_unet_tpu_torch.parallel.sp_ss2d import ss2d_stacked
from test_torch_sp_model import GRAD_TOL, LOGITS_TOL, _close, _close_grad

torch.set_num_threads(1)

JOIN_S = 120.0
CASES = {2: (2, 64, 64), 4: (1, 128, 128)}        # n -> (B, H, W)
RANKS = tuple(CASES)
DEPTHS, DEC_DEPTHS = (1, 1, 1, 1), (2, 2, 2, 2)
BLOCK = (2, 16, 8, 16)                            # (B, H, W, C)
D_STATES = (1, 2)


def _weights(seed=21):
    """(JAX variables, the port's state dict): see the module
    docstring."""
    rng = np.random.default_rng(seed)
    sd = {k: t.numpy().copy() for k, t in build_legacy_model(
        enc_name="vssm_test", device="cpu", seed=seed).state_dict().items()}
    noise = lambda a, s: a + s * rng.standard_normal(a.shape).astype(
        np.float32)
    for k, a in sd.items():
        if k.endswith("running_var"):
            sd[k] = a + 0.3 * rng.random(a.shape).astype(np.float32)
        elif k.endswith("A_logs"):
            sd[k] = rng.uniform(-6.0, 0.5, a.shape).astype(np.float32)
        elif k.endswith(("bias", "running_mean", "Ds")):
            sd[k] = noise(a, 0.1)
    part = lambda pre: {k[len(pre):]: a for k, a in sd.items()
                        if k.startswith(pre)}
    variables = jax.tree_util.tree_map(
        np.asarray, convert_msvm_legacy_state_dict(
            part("encoder."), part("decoder."), DEPTHS, DEC_DEPTHS))
    return variables, jax_import.legacy_state_dict_from_jax(
        variables, DEPTHS, DEC_DEPTHS)


def _inputs(n):
    B, H, W = CASES[n]
    rng = np.random.default_rng(40 + n)
    x = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    return x, rng.integers(0, 9, (B, H, W)).astype(np.int32)


def _block_cases():
    """d_state -> (an SS2D's state dict, x, ct) at BLOCK's shape, with the
    z-gate (``v2``): weights of order one, ``A_logs`` from U(-6, 0.5), dt
    biases near softplus^-1(0.05)."""
    rng = np.random.default_rng(60)
    out = {}
    for N in D_STATES:
        op = SS2D(BLOCK[-1], d_state=N, forward_type="v2")
        sd = {}
        for k, p in op.state_dict().items():
            a = 0.3 * rng.standard_normal(p.shape)
            if k == "A_logs":
                a = rng.uniform(-6.0, 0.5, p.shape)
            elif k == "Ds":
                a = 1.0 + a
            elif k == "dt_projs_bias":
                a = -3.0 + a
            elif k.startswith("out_norm"):
                a = (1.0 if k.endswith("weight") else 0.0) + a
            sd[k] = a.astype(np.float32)
        x = rng.standard_normal(BLOCK).astype(np.float32)
        out[N] = sd, x, rng.standard_normal(BLOCK).astype(np.float32)
    return out


def _model(sd):
    model = build_legacy_model(enc_name="vssm_test", device="cpu")
    jax_import.load_numpy_state_dict(model, sd)
    return model


def _shards(t, n):
    """(B, H, ...) -> (n, B, H/n, ...)."""
    return t.unflatten(1, (n, -1)).movedim(1, 0)


def _image(t):
    return t.movedim(0, 1).flatten(1, 2)


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
    jobs = {n: pool.submit(sp_model_jax.legacy_reference, variables,
                           *_inputs(n), n) for n in RANKS}
    groups = {n: dryrun.start(n, torch_workers.sp_legacy_cases,
                              (sd, *_inputs(n), _block_cases()))
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
        sd = jax_import.legacy_state_dict_from_jax(
            {"params": grads, "batch_stats": variables["batch_stats"]},
            DEPTHS, DEC_DEPTHS)
        out[n] = logits, loss, sd
    return out


def _value_and_grads(model, x, y):
    logits = model(x)
    loss = losses.dice_ce_loss(logits, y, ce_weight=0.4, dc_weight=0.6)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return logits.detach(), loss.item(), {
        k: (torch.zeros_like(p) if g is None else g).numpy()
        for (k, p), g in zip(named, grads)}


@pytest.fixture(scope="module")
def port_side(weights):
    """n -> the unsharded port's and the stacked form's (logits, loss,
    grads)."""
    model = _model(weights[1])
    out = {}
    for n in RANKS:
        x, y = [torch.from_numpy(a) for a in _inputs(n)]
        y = y.long()
        logits, loss, grads = _value_and_grads(model, x, y)
        with torch.no_grad():
            st_logits = sp_forward_stacked(model, _shards(x, n))
        st_loss, st_grads = sp_value_and_grad_stacked(model, _shards(x, n),
                                                      _shards(y, n))
        out[n] = (logits.numpy(), loss, grads), (
            _image(st_logits).numpy(), st_loss.item(),
            {k: g.numpy() for k, g in st_grads.items()})
    return out


@pytest.mark.parametrize("n", RANKS)
def test_sp_forward_matches_jax_and_the_unsharded_port(jax_side, ranks,
                                                       port_side, n):
    got = np.concatenate([r["logits"] for r in ranks[n]], axis=1)
    want = jax_side[n][0]
    assert got.shape == (*CASES[n], 9) and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, **LOGITS_TOL)
    plain, stacked = port_side[n]
    _close(got, plain[0])
    _close(stacked[0], got)


@pytest.mark.parametrize("n", RANKS)
def test_sp_value_and_grad_matches_jax(jax_side, ranks, weights, n):
    _, want_loss, want = jax_side[n]
    first = ranks[n][0]
    np.testing.assert_allclose(first["loss"], want_loss, rtol=1e-5)
    assert set(first["grads"]) == {k for k, _ in _model(
        weights[1]).named_parameters()}
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


@pytest.mark.parametrize("n", RANKS)
def test_collectives_per_forward(ranks, n):
    """Per forward, per rank: 10 SS2Ds (4 encoder, 6 decoder), each with
    one ring-summary all-gather per direction and one all-to-all each way
    (the map to W-shards, the column-major sum back); no all-reduce. Halos:
    2 patch-embed convs, 3 downsamples, the 10 SS2Ds' depthwise convs, 5
    per decoder MS-MLP (3x3, 5x5, 7x7, 11x1, 5x1; the 1xk convs read no
    other row), 3 LKPEs and the FLKPE."""
    for r in ranks[n]:
        assert r["calls"] == {"all_gather": 40, "all_to_all_single": 20,
                              "batch_isend_irecv": 2 + 3 + 10 + 30 + 4}, \
            r["calls"]


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("d_state", D_STATES)
def test_ss2d_block_matches_the_unsharded_op(ranks, d_state, n):
    """An SS2D on n shards, on the ranks (``ss2d_sp``) and stacked
    (``ss2d_stacked``), against the unsharded op (K10's route at d_state
    1, cross scan + ``selective_scan`` at 2): the output, and the
    gradients of sum(out * ct) in x and in every parameter."""
    sd, x, ct = _block_cases()[d_state]
    op = SS2D(BLOCK[-1], d_state=d_state, forward_type="v2")
    jax_import.load_numpy_state_dict(op, sd)
    xt = torch.from_numpy(x).requires_grad_()
    want = op(xt)
    (want * torch.from_numpy(ct)).sum().backward()
    want_gp = {k: p.grad.numpy().copy() for k, p in op.named_parameters()}
    op.zero_grad(set_to_none=True)
    xs = _shards(torch.from_numpy(x), n).requires_grad_()
    got = ss2d_stacked(op, xs)
    (got * _shards(torch.from_numpy(ct), n)).sum().backward()
    hl = BLOCK[1] // n
    _close(_image(got.detach()).numpy(), want.detach().numpy())
    _close(_image(xs.grad).numpy(), xt.grad.numpy())
    for k, p in op.named_parameters():
        _close_grad(p.grad.numpy(), want_gp[k], err_msg=k)
        shares = sum(r["blocks"][d_state][2][k] for r in ranks[n])
        _close_grad(shares, want_gp[k], err_msg=k)
    for i, r in enumerate(ranks[n]):
        y, gx, _ = r["blocks"][d_state]
        rows = slice(i * hl, (i + 1) * hl)
        _close(y, want.detach().numpy()[:, rows])
        _close(gx, xt.grad.numpy()[:, rows])


def test_long_memory_logits_on_two_shards():
    """Every ``A_logs`` at -6 (a decay within 3e-4 of 1 per step, so each
    direction's state runs across the whole map): the logits of 2 stacked
    shards at 64² against the unsharded model. Scanning each shard alone
    misses by ~5e-3 here."""
    model = build_legacy_model(enc_name="vssm_test", device="cpu", seed=0)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k.endswith("A_logs"):
                p.fill_(-6.0)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, 64, 64, 1)).astype(np.float32))
        want = model(x)
        got = _image(sp_forward_stacked(model, _shards(x, 2)))
    assert np.abs(want.numpy()).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGITS_TOL)


def test_pos_embed_and_patch_merging_shard():
    """``VSSM`` with ``pos_embed`` (each shard adds its own rows) and the
    v1 downsample ``PatchMerging2D`` (each shard merges its row pairs), on
    2 and 4 stacked shards at 128²: every stage's features against the
    unsharded encoder."""
    enc = vmamba.VSSM(dims=(16, 32, 48, 64), depths=DEPTHS,
                      drop_path_rate=0.0, posembed=True, img_size=128,
                      downsample_version="v1").eval()
    vmamba.init_legacy_weights(enc, torch.Generator().manual_seed(3))
    with torch.no_grad():
        enc.pos_embed.normal_(0.0, 1.0,
                              generator=torch.Generator().manual_seed(4))
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (1, 128, 128, 3)).astype(np.float32))
        want = enc(x)
        for n in (2, 4):
            with sp_stacked(n):
                got = enc(_shards(x, n).flatten(0, 1))
            for w, g in zip(want, got):
                _close(_image(g.unflatten(0, (n, -1))).numpy(), w.numpy())


class _RowMix(nn.Module):
    """A module that reads across rows with no H-sharded route."""

    def forward(self, x):
        return x + x.mean(dim=1, keepdim=True)


def _unrouted(sd):
    model = _model(sd)
    model.decoder.layers[0].up.expand[2] = _RowMix()
    return model


@pytest.mark.parametrize("case", ["stage", "patch_merging", "width",
                                  "unrouted", "unrouted_grad",
                                  "not_a_model"])
def test_unsupported_cases_raise(weights, case):
    x = torch.zeros(2, 1, 32, 64, 1)
    if case == "stage":
        with pytest.raises(ValueError, match=r"4 shards do not divide stage "
                           r"4's map H 2 x W 2 \(input 64x64\)"):
            sp_forward_stacked(_model(weights[1]), torch.zeros(4, 1, 16, 64,
                                                               1))
    elif case == "patch_merging":
        with sp_stacked(2), pytest.raises(
                ValueError, match="the shard's H/n = 3 is odd"):
            vmamba.PatchMerging2D(4)(torch.zeros(2, 3, 8, 4))
    elif case == "width":
        with pytest.raises(ValueError, match=r"sharded SS2D: 2 shards do not "
                           r"divide W 5"):
            ss2d_stacked(SS2D(8), torch.zeros(2, 1, 4, 5, 8))
    elif case == "unrouted":
        with pytest.raises(ValueError, match=r"module decoder\.layers\.0\.up"
                           r"\.expand\.2 is a _RowMix, which has no "
                           r"H-sharded route"):
            sp_forward_stacked(_unrouted(weights[1]), x)
    elif case == "unrouted_grad":
        with pytest.raises(ValueError, match="_RowMix"):
            sp_value_and_grad_stacked(_unrouted(weights[1]), x,
                                      torch.zeros(2, 1, 32, 64).long())
    else:
        with pytest.raises(ValueError, match="takes an MSVMUNet or an "
                           "MSVMUNetLegacy, got VSSM"):
            sp_forward_stacked(_model(weights[1]).encoder, x)


def test_a_group_of_one_equals_one_stacked_shard(weights, tmp_path):
    """A gloo group of one in this process: ``sp_forward`` and the loss
    equal the 1-shard stacked forms bitwise (``chip_smoke.py`` phase 26
    (d) on the card), the gradients within ``_close_grad``; both group
    entries refuse a model with an unrouted module before any
    collective."""
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
        with mesh.watch_collectives() as calls:
            for fn in (lambda m: sp_forward(m, x),
                       lambda m: sp_value_and_grad(m, x, y)):
                with pytest.raises(ValueError, match="_RowMix"):
                    fn(_unrouted(weights[1]))
    finally:
        torch.distributed.destroy_process_group()
    assert mesh.active_group() is None and calls == {}
    assert torch.equal(got, want)
    assert torch.equal(loss, st_loss)
    assert grads.keys() == st_grads.keys()
    for k, g in grads.items():
        _close_grad(g.numpy(), st_grads[k].numpy(), err_msg=k)


# the parent's forwards of the modules whose forward the routing changed,
# as they were before it: outside the context the model must compute
# exactly what they compute

def _parent_ss2d(self, x):
    xz = self.in_proj(x)
    z = None
    if self.disable_z:
        xc = xz
    else:
        xc, z = xz.chunk(2, dim=-1)
        z = F.silu(z)
    if self.conv2d is not None:
        xc = self.conv2d(xc)
    xc = F.silu(xc)
    y = (self._scan_directions(xc) if self.d_state == 1
         else self._scan_cross(xc))
    y = self.out_norm(y).to(x.dtype)
    if z is not None:
        y = y * z
    return self.out_proj(y)


def _parent_vssm(self, x, generator=None):
    x = self.patch_embed(x)
    if self.pos_embed is not None:
        x = x + self.pos_embed.permute(0, 2, 3, 1).to(x.dtype)
    feats = []
    for i, layer in enumerate(self.layers):
        x = layer(x, generator)
        feats.append(x)
        if i < len(self.downsamples):
            x = self.downsamples[i](x)
    return feats


def test_outside_the_context_the_legacy_model_is_the_parent_model(weights):
    """vssm_test's logits and gradients outside the context equal bitwise
    those of the parent's forwards, and no exchange or ring scan runs
    there."""
    model = _model(weights[1])
    x, y = [torch.from_numpy(a) for a in _inputs(2)]
    with pytest.MonkeyPatch.context() as mp:
        def refuse(*a, **kw):
            raise AssertionError("an exchange ran outside the context")
        for name in ("conv2d", "row_halo", "shard_rows"):
            mp.setattr(sp_ops, name, refuse)
        mp.setattr(ss2d, "ss2d_scan", refuse)
        got = _value_and_grads(model, x, y.long())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ss2d.SS2D, "forward", _parent_ss2d)
        mp.setattr(vmamba.VSSM, "forward", _parent_vssm)
        want = _value_and_grads(model, x, y.long())
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert got[2].keys() == want[2].keys()
    assert all(np.array_equal(got[2][k], want[2][k]) for k in got[2])
