"""The port's H-sharded QuadGroupSS2D (``parallel/sp_ss2d.py``,
``parallel/sp_context.py``) against the JAX package, on the CPU.

The port's ranks are spawned processes joined in a gloo group
(``parallel/dryrun.py`` ``start``; their task is
``tests/torch_workers.py`` ``sp_cases``, which imports torch and the port
only). Two groups, of 2 and 4 ranks, are started once for the module and
run while the JAX side compiles; each join has its own 120 s timeout. JAX
runs ``quad_group_ss2d_sp`` under ``shard_map`` over 2 and 4 of the 8
virtual devices of ``tests/conftest.py``, and the unsharded module.

The block is ``QuadGroupSS2D(dim=C, scan_backend="assoc")`` at C 32 and 48
(group widths 8 and 12) on a (2, 32, 32, C) fp32 input, its JAX init moved
by seeded noise (projections scaled up, the LayerNorm, A, D and the conv
bias off their init values) so that the output is of order 1 and every
parameter's gradient is exercised; the port takes those weights through
``convert/jax_import.py`` ``quad_ss2d``. Tolerances are
tests/test_sp_ss2d.py's: the forward and the input gradient at rtol 2e-4,
atol 2e-4; each parameter gradient at rtol 2e-4, atol 2e-4 * max(1,
max|JAX grad|).

Parameter gradients are the sum over the ranks of each rank's gradient:
each rank's backward holds its shard's share of the gradient of the loss
summed over the whole image (the cotangent's exchanges carry the rest to
the rank that computed it), which is what ``shard_map`` computes for the
replicated parameters. ``mesh.reduce_gradients``' mean over the ranks is
the data-parallel convention and would be 1/n of it here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_workers
from ceigm_unet_tpu.models.ss2d import QuadGroupSS2D as JQuadGroupSS2D
from ceigm_unet_tpu.parallel.sp_ss2d import quad_group_ss2d_sp as jquad_sp
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.models import ss2d
from ceigm_unet_tpu_torch.models.groupmamba import GroupMambaLayer
from ceigm_unet_tpu_torch.models.msvm_unet import init_weights
from ceigm_unet_tpu_torch.models.ss2d import QuadGroupSS2D
from ceigm_unet_tpu_torch.parallel import dryrun, init_data_parallel, mesh
from ceigm_unet_tpu_torch.parallel.sp_context import active, sp_scan_island
from ceigm_unet_tpu_torch.parallel.sp_ss2d import (quad_group_ss2d_sp,
                                                   quad_group_ss2d_stacked)

torch.set_num_threads(1)

JOIN_S = 120.0
B, H, W = 2, 32, 32
WIDTHS = (32, 48)                       # group widths 8 and 12
RANKS = (2, 4)
TOL = dict(rtol=2e-4, atol=2e-4)


def _stacked_close(got, want, **kw):
    """The stacked form against the group form: the same arithmetic, with
    the GEMMs over n times the rows and each parameter's shares summed in
    another order (fp32 sums over B*H*W terms), at rtol 1e-5, atol 1e-5 *
    max|want|."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max(), **kw)


def _moved(params, rng):
    """JAX init moved by seeded noise (see the module docstring)."""
    noise = lambda a, s: a + s * rng.standard_normal(a.shape).astype(
        np.float32)
    p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    p["in_proj_weight"] *= 25.0
    p["out_proj_weight"] *= 25.0
    p["out_norm_scale"] = noise(p["out_norm_scale"], 0.3)
    p["out_norm_bias"] = noise(p["out_norm_bias"], 0.3)
    p["conv2d"]["bias"] = noise(p["conv2d"]["bias"], 0.3)
    p["ssm"]["A_logs"] = noise(p["ssm"]["A_logs"], 0.5)
    p["ssm"]["Ds"] = noise(p["ssm"]["Ds"], 0.3)
    return p


def _case(C):
    """(JAX params, the port's state dict, x, ct) for width C."""
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((B, H, W, C)) * 0.5).astype(np.float32)
    ct = rng.standard_normal((B, H, W, C)).astype(np.float32)
    m = JQuadGroupSS2D(dim=C, scan_backend="assoc")
    v = jax.jit(m.init)(jax.random.PRNGKey(C), jnp.zeros((1, 4, 4, C)))
    params = _moved(v["params"], rng)
    return params, jax_import.quad_ss2d(params), x, ct


CASES = {}


@pytest.fixture(scope="module")
def cases():
    if not CASES:
        CASES.update({C: _case(C) for C in WIDTHS})
    return CASES


@pytest.fixture(scope="module")
def launched(cases):
    """The two groups, started once; their ranks run while JAX
    compiles."""
    args = {C: (sd, x, ct) for C, (_, sd, x, ct) in cases.items()}
    groups = {n: dryrun.start(n, torch_workers.sp_cases, (args,))
              for n in RANKS}
    yield groups
    for g in groups.values():       # a group a failed test left running
        if any(p.is_alive() for p in g.procs):
            with pytest.raises(Exception):
                g.join(0.0)


@pytest.fixture(scope="module")
def jax_side(launched, cases):
    """JAX's output and gradients of sum(out * ct): the unsharded module
    per width, and ``quad_group_ss2d_sp`` under ``shard_map`` per width and
    number of shards, as numpy trees."""
    out = {}
    run = lambda loss, params, x: jax.tree_util.tree_map(np.asarray, jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, x))
    for C, (params, _, x, ct) in cases.items():
        m = JQuadGroupSS2D(dim=C, scan_backend="assoc")

        def loss_ref(p, xx):
            y = m.apply({"params": p}, xx)
            return jnp.sum(y * ct), y
        out[C] = run(loss_ref, params, x)
        for n in RANKS:
            f = shard_map(
                lambda pp, q: jquad_sp(pp, q, axis_name="sp"),
                mesh=Mesh(np.asarray(jax.devices()[:n]), ("sp",)),
                in_specs=(P(), P(None, "sp", None, None)),
                out_specs=P(None, "sp", None, None))

            def loss_sp(p, xx):
                y = f(p, xx)
                return jnp.sum(y * ct), y
            out[C, n] = run(loss_sp, params, x)
    return out


@pytest.fixture(scope="module")
def ranks(launched):
    return {n: launched[n].join(JOIN_S) for n in RANKS}


def _gathered(results, C, key):
    """The ranks' H-shards of ``key`` put back in one image."""
    return np.concatenate([r[C][key] for r in results], axis=1)


def _block(sd, **kw):
    """The port's block of ``sd``'s width with its weights."""
    m = QuadGroupSS2D(4 * sd["mamba_g1.in_proj.weight"].shape[1], **kw)
    jax_import.load_numpy_state_dict(m, sd)
    return m


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("n", RANKS)
def test_forward_matches_jax_shard_map_and_the_unsharded_module(
        jax_side, ranks, n, C):
    got = _gathered(ranks[n], C, "out")
    (_, want_sp), _ = jax_side[C, n]
    (_, want), _ = jax_side[C]
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want_sp, **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    # dwconv="kernel": the depthwise conv on the haloed rows, the middle
    # H/n rows kept
    np.testing.assert_allclose(_gathered(ranks[n], C, "kernel"), want, **TOL)


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("n", RANKS)
def test_input_and_summed_parameter_grads_match_jax(jax_side, ranks, n, C):
    _, (gp_sp, gx_sp) = jax_side[C, n]
    _, (gp_ref, _) = jax_side[C]
    np.testing.assert_allclose(_gathered(ranks[n], C, "gx"), gx_sp, **TOL)
    # JAX's gradient trees in the port's parameter names
    want_sp = jax_import.quad_ss2d(gp_sp)
    want_ref = jax_import.quad_ss2d(gp_ref)
    names = ranks[n][0][C]["gp"].keys()
    assert set(names) == set(want_sp)
    for k in names:
        got = sum(r[C]["gp"][k] for r in ranks[n])
        for w in (want_sp[k], want_ref[k]):
            atol = 2e-4 * max(1.0, np.abs(w).max())
            np.testing.assert_allclose(got, w, rtol=2e-4, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("n", RANKS)
def test_stacked_shards_equal_the_group(cases, ranks, n):
    for C, (_, sd, x, ct) in cases.items():
        m = _block(sd)
        xs = torch.from_numpy(x).unflatten(1, (n, H // n)).movedim(1, 0)
        xs.requires_grad_()
        y = quad_group_ss2d_stacked(m, xs)
        (y * torch.from_numpy(ct).unflatten(1, (n, H // n)).movedim(1, 0)
         ).sum().backward()
        unstack = lambda t: t.detach().movedim(0, 1).flatten(1, 2).numpy()
        _stacked_close(unstack(y), _gathered(ranks[n], C, "out"))
        _stacked_close(unstack(xs.grad), _gathered(ranks[n], C, "gx"))
        for k, p in m.named_parameters():
            _stacked_close(p.grad.numpy(),
                           sum(r[C]["gp"][k] for r in ranks[n]), err_msg=k)


@pytest.mark.parametrize("n", RANKS)
def test_module_under_the_context_is_the_functional_call(cases, jax_side,
                                                         ranks, n,
                                                         monkeypatch):
    for C in WIDTHS:
        for r in ranks[n]:
            assert np.array_equal(r[C]["module"], r[C]["functional"])
            assert np.array_equal(r[C]["module"], r[C]["out"])
    # outside the context the island is never entered: the unsharded block
    def refuse(*args, **kw):
        raise AssertionError("the island ran outside its context")
    monkeypatch.setattr(ss2d, "quad_group_ss2d_sp", refuse)
    for C, (_, sd, x, _) in cases.items():
        with torch.no_grad():
            got = _block(sd)(torch.from_numpy(x))
        (_, want), _ = jax_side[C]
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n", RANKS)
def test_quant_scan_and_an_undivided_w_raise_on_the_ranks(ranks, n):
    for r in ranks[n]:
        for C in WIDTHS:
            quant, width = r[C]["raises"]
            assert quant is not None and "quant_scan" in quant
            assert width == (f"quad_group_ss2d_sp: {n} shards do not divide "
                             f"W {8 * n + 1} (the column-major directions "
                             f"re-shard W)")


def test_no_group_raises_and_the_stacked_form_refuses_the_same(cases):
    assert mesh.active_group() is None and active() is None
    _, sd, x, _ = cases[32]
    m = _block(sd)
    with pytest.raises(RuntimeError, match="no process group"):
        with sp_scan_island():
            pass
    with pytest.raises(RuntimeError, match="no process group"):
        quad_group_ss2d_sp(m, torch.from_numpy(x))
    xs = torch.from_numpy(x).unflatten(1, (4, H // 4)).movedim(1, 0)
    with pytest.raises(ValueError, match="quant_scan"):
        quad_group_ss2d_stacked(_block(sd, quant_scan=True), xs)
    with pytest.raises(ValueError, match="3 shards do not divide W 32"):
        quad_group_ss2d_stacked(m, torch.zeros(3, B, 2, W, 32))


@pytest.mark.parametrize("n", RANKS)
def test_collectives_gather_only_the_ring_summaries(ranks, n):
    """One block's forward and backward: per direction one all-gather of
    the ring's (decay, state) summaries in the forward's scan and one in
    the backward's; the halo's row swap in each direction of autograd; the
    ring backward's two neighbour shifts per direction; one all-to-all
    there and back for each column-major direction, and their
    adjoints."""
    for r in ranks[n]:
        for C in WIDTHS:
            assert r[C]["calls"] == {"all_gather": 8,
                                     "batch_isend_irecv": 10,
                                     "all_to_all_single": 8}
            # (batch, group width, N = 1, 2) per shard: no H or L axis
            assert r[C]["gathered"] == [B * (C // 4) * 2] * 8


def test_a_group_of_one_equals_one_stacked_shard_and_nests(cases, tmp_path,
                                                           monkeypatch):
    """A gloo group of one in this process: the block under the context
    equals the 1-shard stacked block bitwise (chip_smoke.py phase 24 (b)
    on the card); a nested context routes over its own group and restores
    the outer one; GroupMambaLayer's scan, which calls ``scan_groups``
    rather than the block's forward, is routed too."""
    _, sd, x, _ = cases[48]
    m = _block(sd)
    xt = torch.from_numpy(x)
    layer = GroupMambaLayer(48)
    init_weights(layer, torch.Generator().manual_seed(0))
    with torch.no_grad():
        want_layer = layer(xt)
    routed = []
    island = ss2d.quad_group_ss2d_sp
    monkeypatch.setattr(ss2d, "quad_group_ss2d_sp",
                        lambda *a: routed.append(1) or island(*a))
    try:
        init_data_parallel(1, device="cpu", store_path=str(tmp_path / "s"))
        with torch.no_grad(), sp_scan_island():
            got_layer = layer(xt)
        assert routed == [1]
        np.testing.assert_allclose(got_layer.numpy(), want_layer.numpy(),
                                   **TOL)
        inner = torch.distributed.new_group([0])
        with torch.no_grad(), sp_scan_island():
            outer = active()
            got = m(xt)
            with sp_scan_island(inner):
                assert active() is inner
                assert torch.equal(m(xt), got)
            assert active() is outer
        assert active() is None
        with torch.no_grad():
            want = quad_group_ss2d_stacked(m, xt[None])[0]
        assert torch.equal(got, want)
    finally:
        torch.distributed.destroy_process_group()
    assert mesh.active_group() is None
