"""The port's legacy MSVM-UNet slice (VSSM encoder + published decoder) and
its scan ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs its Pallas kernels in interpret mode (``sscan_dir``,
``scan_pallas``, ``selective_scan_fused_n1``), as it does off the TPU, its
modules on ``scan_backend`` "pallas" or "assoc" and its whole model on the
sequential "ref" scan; the port runs the plain versions its ops take for
CPU tensors. The kernels themselves are held
against those plain versions on a card by tests/test_torch_cuda.py.

Tolerances (tests/test_torch_ops.py and tests/test_torch_model.py): ops and
modules fp32 rtol 2e-4 / atol 2e-4, bf16 rtol 3e-2 / atol 5e-2; encoder
stages rtol 1e-3 / atol 2e-4; logits rtol 1e-3 / atol 1e-3; the bf16
forward within 0.05 * max|fp32 logit|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceigm_unet_tpu.convert.vssm_import import convert_msvm_legacy_state_dict
from ceigm_unet_tpu.eval.volume import predict_volume as jpredict_volume
from ceigm_unet_tpu.models import ss2d as jss2d
from ceigm_unet_tpu.models import vmamba as jvm
from ceigm_unet_tpu.ops import cross_scan as jcs
from ceigm_unet_tpu.ops.quad_scan import sscan_dir as jsscan_dir
from ceigm_unet_tpu.ops.scan_pallas import (scan_pallas,
                                            selective_scan_fused_n1)
from ceigm_unet_tpu.ops.selective_scan import selective_scan as jselscan
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.eval.volume import predict_volume
from ceigm_unet_tpu_torch.models import build_legacy_model, vmamba
from ceigm_unet_tpu_torch.models.ss2d import SS2D
from ceigm_unet_tpu_torch.ops import cross_scan
from ceigm_unet_tpu_torch.ops.quad_scan import (scan_order, sscan_dir,
                                                sscan_dir_ref)
from ceigm_unet_tpu_torch.ops.selective_scan import (scan_rows, scan_rows_ref,
                                                     selective_scan,
                                                     selective_scan_n1)

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=5e-2)}
MODULE_TOL = TOL["float32"]
STAGE_TOL = dict(rtol=1e-3, atol=2e-4)
LOGITS_TOL = dict(rtol=1e-3, atol=1e-3)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VSSM_TEST_DEPTHS = (1, 1, 1, 1)
DEC_DEPTHS = (2, 2, 2, 2)


def _f32(a):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float32)


def _both(a, dtype="float32"):
    """numpy -> (jax array, torch tensor) with identical values."""
    j = jnp.asarray(a, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# --- K10: the directional d_state = 1 scan ------------------------------------

def _dir_inputs(B, H, W, D, K, seed):
    rng = np.random.default_rng(seed)
    L = H * W
    return dict(u=rng.standard_normal((B, L, D)),
                dt=rng.standard_normal((B, K, L, D)) * 0.5,
                Bs=rng.standard_normal((B, K, L)),
                Cs=rng.standard_normal((B, K, L)),
                A=-np.exp(rng.standard_normal((K, D)) * 0.5),
                bias=rng.standard_normal((K, D)) * 0.3,
                Dv=rng.standard_normal((K, D)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sscan_dir_matches_jax_per_direction(dtype):
    """All four directions in one call, u a stride-0 view over K (the four
    directions read the same activation), against the JAX op run once per
    direction (Pallas in interpret mode)."""
    B, H, W, D = 2, 5, 6, 12
    dirs = (1, 2, 3, 4)
    a = _dir_inputs(B, H, W, D, len(dirs), seed=D)
    act = {k: _both(a[k], dtype) for k in ("u", "dt", "Bs", "Cs")}
    prm = {k: _both(a[k]) for k in ("A", "bias", "Dv")}
    L = H * W
    u = act["u"][1][:, None].expand(B, 4, L, D)
    assert u.stride(1) == 0
    got = sscan_dir(u, act["dt"][1], act["Bs"][1], act["Cs"][1],
                    *[prm[k][1] for k in ("A", "bias", "Dv")], H, W, dirs)
    assert got.dtype == torch.float32 and got.shape == (B, 4, L, D)
    bc = lambda x, k: jnp.broadcast_to(x[:, k, :, None], (B, L, D))
    for k, d in enumerate(dirs):
        want = jsscan_dir(act["u"][0], act["dt"][0][:, k], bc(act["Bs"][0], k),
                          bc(act["Cs"][0], k),
                          *[prm[n][0][k] for n in ("A", "bias", "Dv")], H, W,
                          d)
        np.testing.assert_allclose(got[:, k].numpy(), _f32(want),
                                   **TOL[dtype])


def test_sscan_dir_strides_and_direction_order():
    """A strided dt view and permuted directions give what contiguous
    inputs scanned direction by direction give."""
    B, H, W, D = 2, 4, 7, 5
    dirs = (3, 1, 4, 2)
    t = {k: _t(v) for k, v in _dir_inputs(B, H, W, D, 4, seed=1).items()}
    u = t["u"][:, None].expand(B, 4, H * W, D)
    dt_blkd = t["dt"].permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    got = sscan_dir(u, dt_blkd, t["Bs"], t["Cs"], t["A"], t["bias"], t["Dv"],
                    H, W, dirs)
    for k, d in enumerate(dirs):
        one = sscan_dir_ref(u[:, k:k + 1].contiguous(), t["dt"][:, k:k + 1],
                            t["Bs"][:, k:k + 1], t["Cs"][:, k:k + 1],
                            *[t[n][k:k + 1] for n in ("A", "bias", "Dv")],
                            H, W, (d,))
        np.testing.assert_allclose(got[:, k].numpy(), one[:, 0].numpy(),
                                   rtol=1e-6, atol=1e-6)


def _sscan_dir_chunked(u, dt, Bs, Cs, A, bias, Dv, H, W, directions, chunk):
    """K10's recurrence in the chunked form its kernel runs, in plain fp32
    PyTorch: each direction's walk cut into chunks of ``chunk`` steps (the
    last one short where ``chunk`` does not divide H*W); per chunk, the
    running sum s of d = softplus(dt + bias), so the chunk's decay so far is
    P = exp(A*s), and the local state h_loc from h = 0; then each chunk's
    carry-in folded over the chunks before it (h_in = P_end*h_in +
    h_loc_end); y = C*(h_loc + P*h_in) + D*u, back in pixel order."""
    B, K, L, D = u.shape
    order = torch.stack([scan_order(H, W, d) for d in directions])
    idx4 = order.view(1, K, L, 1).expand(B, K, L, D)
    idx3 = order.view(1, K, L).expand(B, K, L)
    prm = lambda t: t.float().reshape(1, K, 1, D)
    x = torch.gather(dt.float(), 2, idx4) + prm(bias)
    d = x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))
    uf = torch.gather(u.float(), 2, idx4)
    Bf = torch.gather(Bs.float(), 2, idx3).unsqueeze(-1)
    Cf = torch.gather(Cs.float(), 2, idx3).unsqueeze(-1)
    n = -(-L // chunk)
    # steps past L: d = 0 (decay 1) and no drive
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, n * chunk - L))
    d, drive = pad(d), pad(d * uf * Bf)
    d = d.reshape(B, K, n, chunk, D)
    drive = drive.reshape(B, K, n, chunk, D)
    Af = A.float().reshape(1, K, 1, 1, D)
    P = torch.exp(Af * torch.cumsum(d, dim=3))
    a = torch.exp(Af * d)
    h_loc = torch.zeros_like(d)
    h = torch.zeros_like(d[:, :, :, 0])
    for j in range(chunk):
        h = a[:, :, :, j] * h + drive[:, :, :, j]
        h_loc[:, :, :, j] = h
    h_in = torch.zeros_like(h)
    carry = torch.zeros_like(h[:, :, 0])
    for i in range(n):
        h_in[:, :, i] = carry
        carry = P[:, :, i, -1] * carry + h_loc[:, :, i, -1]
    hs = (h_loc + P * h_in.unsqueeze(3)).reshape(B, K, n * chunk, D)[:, :, :L]
    y = Cf * hs + prm(Dv) * uf
    return torch.empty_like(y).scatter_(2, idx4, y)


@pytest.mark.parametrize("H,W", [(5, 9), (7, 7)])
def test_sscan_dir_chunked_recurrence_matches_ref_and_jax(H, W):
    """The chunked recurrence of csrc/sscan_dir.cu (chunk sums of d, local
    end states, the carry fold) gives sscan_dir_ref's y and the JAX
    sscan_dir's (Pallas in interpret mode), in all four directions, for
    chunks that divide H*W (45 by 5, 49 by 7) and that do not (16, and 7 or
    5), fp32."""
    B, D = 2, 6
    dirs = (1, 2, 3, 4)
    t = {k: _t(v) for k, v in _dir_inputs(B, H, W, D, 4, seed=H).items()}
    u = t["u"][:, None].expand(B, 4, H * W, D)
    prm = [t[n] for n in ("A", "bias", "Dv")]
    ref = sscan_dir_ref(u, t["dt"], t["Bs"], t["Cs"], *prm, H, W, dirs)
    bc = lambda x, k: jnp.asarray(x[:, k, :, None].expand(B, H * W, D)
                                  .numpy())
    want = [_f32(jsscan_dir(jnp.asarray(t["u"].numpy()),
                            jnp.asarray(t["dt"][:, k].numpy()),
                            bc(t["Bs"], k), bc(t["Cs"], k),
                            *[jnp.asarray(q[k].numpy()) for q in prm], H, W,
                            d)) for k, d in enumerate(dirs)]
    for chunk in (5, 7, 16):
        got = _sscan_dir_chunked(u, t["dt"], t["Bs"], t["Cs"], *prm, H, W,
                                 dirs, chunk)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
        for k in range(4):
            np.testing.assert_allclose(got[:, k].numpy(), want[k],
                                       **TOL["float32"])


# --- K11 and K12: the generic selective scan ----------------------------------

def test_scan_rows_matches_scan_pallas():
    rng = np.random.default_rng(2)
    shape = (3, 5, 300)             # 15 rows, L past one 256-element chunk
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape) * 2 - 2))
    b = rng.standard_normal(shape)
    ja, ta = _both(a)
    jb, tb = _both(b)
    got = scan_rows(ta, tb)
    np.testing.assert_allclose(got.numpy(), _f32(scan_pallas(ja, jb)),
                               **TOL["float32"])
    np.testing.assert_allclose(scan_rows_ref(ta, tb).numpy(), got.numpy(),
                               rtol=0, atol=0)


# (N, G, B/C 4-D, D, delta_bias, softplus, out_dtype, last state, in dtype)
SS_CASES = [
    (1, 1, False, True, True, True, "float32", False, "float32"),   # K12
    (1, 2, True, False, False, True, None, False, "float32"),      # K12
    (1, 2, True, True, True, True, "float32", False, "bfloat16"),  # K12
    (1, 1, False, True, True, False, None, False, "float32"),      # K11
    (1, 2, True, True, True, True, None, True, "float32"),         # K11
    (4, 1, False, True, True, True, "float32", False, "float32"),  # K11
    (4, 2, True, False, True, False, "float32", False, "float32"),  # K11
    (4, 2, True, True, False, True, None, True, "float32"),        # K11
    (4, 2, True, True, True, True, None, False, "bfloat16"),       # K11
]


def _ss_inputs(N, G, four_d, with_D, with_bias, dtype, seed):
    rng = np.random.default_rng(seed)
    batch, dim, L = 2, 8, 200
    bc_shape = (batch, G, N, L) if four_d else (batch, N, L)
    raw = dict(u=rng.standard_normal((batch, dim, L)),
               delta=np.abs(rng.standard_normal((batch, dim, L))) * 0.5,
               A=-np.exp(rng.standard_normal((dim, N)) * 0.5),
               B=rng.standard_normal(bc_shape), C=rng.standard_normal(bc_shape),
               D=rng.standard_normal(dim) if with_D else None,
               bias=rng.standard_normal(dim) * 0.3 if with_bias else None)
    low = ("u", "delta", "B", "C")
    return {k: (None, None) if v is None else
            _both(v, dtype if k in low else "float32")
            for k, v in raw.items()}


@pytest.mark.parametrize("case", SS_CASES)
def test_selective_scan_matches_jax(case):
    N, G, four_d, with_D, with_bias, softplus, out, last, dtype = case
    x = _ss_inputs(N, G, four_d, with_D, with_bias, dtype, seed=N * 10 + G)
    names = ("u", "delta", "A", "B", "C", "D", "bias")
    got = selective_scan(*[x[n][1] for n in names], delta_softplus=softplus,
                         return_last_state=last,
                         out_dtype=None if out is None else TDT[out])
    tol = TOL["float32"] if (dtype, out) != ("bfloat16", None) \
        else TOL["bfloat16"]
    for backend in ("pallas", "ref"):
        want = jselscan(*[x[n][0] for n in names], delta_softplus=softplus,
                        return_last_state=last, backend=backend,
                        out_dtype=None if out is None else JDT[out])
        y, w = (got[0], want[0]) if last else (got, want)
        assert y.dtype == (TDT[dtype] if out is None else TDT[out])
        np.testing.assert_allclose(_f32(y), _f32(w), **tol)
        if last:
            assert got[1].shape == (2, 8, N)
            np.testing.assert_allclose(_f32(got[1]), _f32(want[1]),
                                       **TOL["float32"])


def test_selective_scan_n1_is_the_general_scan_at_n1():
    """The fused N = 1 op equals the unfused route (softplus applied by the
    caller) for grouped B/C."""
    x = _ss_inputs(1, 2, True, True, True, "float32", seed=3)
    u, delta, A, B, C, D, bias = [x[n][1] for n in ("u", "delta", "A", "B",
                                                   "C", "D", "bias")]
    fused = selective_scan_n1(u, delta, A, B, C, D, bias)
    sp = torch.nn.functional.softplus(delta + bias[:, None])
    plain = selective_scan(u, sp, A, B, C, D)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_selective_scan_n1_matches_fused_n1_across_l_blocks(dtype):
    """The port's fused N = 1 op (its plain version on the CPU) against the
    JAX kernel in interpret mode at L 2304, which the JAX kernel walks as 3
    L-blocks of 768 with its scratch carry: A = -exp(-8) and a delta bias
    near -2 keep each step's decay within 1e-4 of 1, so the state crosses
    both block boundaries."""
    rng = np.random.default_rng(13)
    batch, dim, G, L = 2, 8, 2, 2304
    M, dg = batch * dim, dim // G
    raw = dict(u=rng.standard_normal((batch, dim, L)),
               delta=rng.standard_normal((batch, dim, L)) * 0.5,
               B=rng.standard_normal((batch, G, 1, L)),
               C=rng.standard_normal((batch, G, 1, L)))
    x = {k: _both(v, dtype) for k, v in raw.items()}
    A = np.full((dim, 1), -np.exp(-8.0))
    D, bias = rng.standard_normal(dim), rng.standard_normal(dim) * 0.3 - 2
    got = selective_scan_n1(*[x[k][1] for k in ("u", "delta")], _t(A),
                            x["B"][1], x["C"][1], _t(D), _t(bias),
                            torch.float32)
    rows = lambda bc: jnp.repeat(bc[:, :, 0], dg, axis=1).reshape(M, L)
    want = selective_scan_fused_n1(
        x["u"][0].reshape(M, L), x["delta"][0].reshape(M, L),
        jnp.tile(jnp.asarray(A[:, 0], jnp.float32), batch),
        rows(x["B"][0]), rows(x["C"][0]),
        jnp.tile(jnp.asarray(D, jnp.float32), batch),
        jnp.tile(jnp.asarray(bias, jnp.float32), batch),
        out_dtype=jnp.float32, interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _f32(want).reshape(batch, dim, L),
                               **TOL[dtype])


def test_selective_scan_n1_refuses_constants_of_another_width():
    """D and delta_bias must be (dim,): the kernel reads dim of each."""
    u, bc, A = torch.zeros(2, 4, 9), torch.zeros(2, 1, 9), -torch.ones(4, 1)
    for opt in ({"D": torch.ones(3)}, {"delta_bias": torch.ones(4, 1)}):
        with pytest.raises(ValueError, match="selective_scan_n1"):
            selective_scan_n1(u, u, A, bc, bc, **opt)


def test_scan_wrappers_refuse_devices_without_kernels():
    m = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sscan_dir(m(1, 4, 6, 8), m(1, 4, 6, 8), m(1, 4, 6), m(1, 4, 6),
                  m(4, 8), m(4, 8), m(4, 8), 2, 3, (1, 2, 3, 4))
    with pytest.raises(ValueError, match="no kernel"):
        scan_rows(m(3, 7), m(3, 7))
    with pytest.raises(ValueError, match="no kernel"):
        selective_scan_n1(m(1, 4, 7), m(1, 4, 7), m(4, 1), m(1, 1, 7),
                          m(1, 1, 7))


# --- cross scan ---------------------------------------------------------------

def test_cross_scan_and_merge_match_jax():
    x = np.random.default_rng(4).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for d in (1, 2, 3, 4):
        xs = cross_scan.cross_scan_1d(tx, d)
        np.testing.assert_array_equal(xs.numpy(),
                                      np.asarray(jcs.cross_scan_1d(jx, d)))
        np.testing.assert_array_equal(
            cross_scan.cross_merge_1d(xs, d, 3, 5).numpy(), x)
    ys = cross_scan.cross_scan_4d(tx)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jcs.cross_scan_4d(jx)))
    np.testing.assert_allclose(cross_scan.cross_merge_4d(ys, 3, 5).numpy(),
                               np.asarray(jcs.cross_merge_4d(
                                   jnp.asarray(ys.numpy()), 3, 5)),
                               rtol=1e-6, atol=1e-6)


# --- modules ------------------------------------------------------------------

def _init(module, seed, *args):
    """Seeded numpy values for every leaf of the module's variable tree,
    at the scales of a trained net (the tree from jax.eval_shape: a jitted
    flax init would compile the forward a second time)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def fill(path, s):
        name, shape = path[-1].key, s.shape
        n = lambda scale: rng.standard_normal(shape) * scale
        if name == "var":
            a = 1.0 + rng.random(shape) * 0.3
        elif name in ("scale", "Ds"):
            a = 1.0 + n(0.1)
        elif name == "A_logs":
            a = n(0.5)
        elif name in ("kernel", "x_proj_weight", "dt_projs_weight"):
            fan_in = (shape[-1] if name != "kernel"
                      else int(np.prod(shape[:-1])))
            a = n(fan_in ** -0.5)
        else:                        # biases, dt bias, BN means
            a = n(0.3)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port(module, sd):
    jax_import.load_numpy_state_dict(module, sd)
    return module.eval()


def _check_module(jm, m, sd_fn, x, seed):
    v = _init(jm, seed, jnp.asarray(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    _port(m, sd_fn(v))
    with torch.no_grad():
        got = m(_t(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


# (d_state, forward type, JAX scan backend, bias): d_state 1 on "pallas"
# takes the JAX package's quad route (sscan_dir), on "assoc" the generic
# cross-scan route; d_state 4 always the generic route
SS2D_CASES = [(1, "v2", "pallas", True), (1, "v2", "assoc", False),
              (1, "v05_noz", "pallas", False), (4, "v2", "pallas", False),
              (4, "v05_noz", "assoc", True)]


@pytest.mark.parametrize("case", SS2D_CASES)
def test_ss2d_matches_jax(case):
    d_state, ftype, backend, bias = case
    x = np.random.default_rng(5).standard_normal((2, 5, 6, 16)).astype(
        np.float32)
    jm = jss2d.SS2D(d_model=16, d_state=d_state, forward_type=ftype,
                    bias=bias, scan_backend=backend)
    m = SS2D(16, d_state=d_state, forward_type=ftype, bias=bias)
    _check_module(jm, m, lambda v: jax_import.vssm_ss2d(v["params"]), x, 5)


@pytest.mark.parametrize("mlp_type,post_norm", [("ms", False),
                                                ("plain", True)])
def test_vss_block_matches_jax(mlp_type, post_norm):
    x = np.random.default_rng(6).standard_normal((2, 6, 5, 16)).astype(
        np.float32)
    jm = jvm.VSSBlock(dim=16, mlp_type=mlp_type, post_norm=post_norm,
                      scan_backend="assoc")
    m = vmamba.VSSBlock(16, mlp_type=mlp_type, post_norm=post_norm)
    _check_module(jm, m, lambda v: jax_import.vss_block(v["params"]), x, 6)


def test_lkpe_matches_jax():
    x = np.random.default_rng(7).standard_normal((2, 5, 6, 16)).astype(
        np.float32)
    _check_module(jvm.LKPE(dim=16), vmamba.LKPE(16),
                  lambda v: jax_import.lkpe(v["params"], v["batch_stats"]),
                  x, 7)


def test_flkpe_matches_jax():
    x = np.random.default_rng(8).standard_normal((2, 4, 5, 8)).astype(
        np.float32)
    _check_module(jvm.FLKPE(dim=8, num_classes=9), vmamba.FLKPE(8, 9),
                  lambda v: jax_import.lkpe(v["params"], v["batch_stats"]),
                  x, 8)


def test_patch_merging_odd_sizes_matches_jax():
    x = np.random.default_rng(9).standard_normal((2, 5, 7, 8)).astype(
        np.float32)

    def sd(v):
        p = v["params"]
        return {**jax_import._put({}, "norm", jax_import.layer_norm(
            p["norm"])), **jax_import._put({}, "reduction", jax_import.dense(
                p["reduction"]))}
    _check_module(jvm.PatchMerging2D(), vmamba.PatchMerging2D(8), sd, x, 9)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_vssm_patch_embed_downsample_and_pos_embed_match_jax(version):
    """Patch embed and downsample v1 (PatchMerging2D) or v2, with
    pos_embed, at two stages (the live v2/v3 run in the legacy model)."""
    x = np.random.default_rng(12).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    kw = dict(dims=(16, 32), depths=(1, 1), drop_path_rate=0.0,
              patchembed_version=version, downsample_version=version,
              posembed=True)
    jm = jvm.VSSM(scan_backend="assoc", **kw)
    p = _init(jm, 12, jnp.asarray(x))["params"]
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(x))
    J = jax_import
    sd = {"pos_embed": p["pos_embed"].transpose(0, 3, 1, 2)}
    J._put(sd, "patch_embed.0", J.conv(p["patch_embed0"]))
    J._put(sd, "patch_embed.2", J.layer_norm(p["patch_norm0"]))
    if version == "v2":
        J._put(sd, "patch_embed.5", J.conv(p["patch_embed1"]))
        J._put(sd, "patch_embed.7", J.layer_norm(p["patch_norm1"]))
        J._put(sd, "downsamples.0.1", J.conv(p["downsample0_conv"]))
        J._put(sd, "downsamples.0.3", J.layer_norm(p["downsample0_norm"]))
    else:
        J._put(sd, "downsamples.0.norm", J.layer_norm(
            p["downsample0"]["norm"]))
        J._put(sd, "downsamples.0.reduction", J.dense(
            p["downsample0"]["reduction"]))
    for i in range(2):
        J._put(sd, f"layers.{i}.blocks.0", J.vss_block(p[f"layer{i}_block0"]))
    m = _port(vmamba.VSSM(img_size=32, **kw), sd)
    with torch.no_grad():
        got = m(_t(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STAGE_TOL)


# --- the whole legacy model on vssm_test ---------------------------------------

def _split(sd, convert=lambda a: a):
    """Port state_dict -> (encoder part, decoder part), prefixes dropped."""
    part = lambda pre: {k[len(pre):]: convert(a) for k, a in sd.items()
                        if k.startswith(pre)}
    return part("encoder."), part("decoder.")


PERTURBED = ("bias", "running_mean", "A_logs", "Ds")


@pytest.fixture(scope="module")
def legacy():
    """JAX MSVMUNetLegacy(vssm_test) at 64x64, B=2, on its sequential
    ``ref`` scan (the quickest to compile): variables, input, logits and
    encoder features; and the port loaded with the same weights through
    legacy_state_dict_from_jax. The variables come from a seeded port model
    through the JAX package's own converter (with biases, BN statistics,
    A_logs and Ds moved off their init values): a jitted flax init of the
    model costs a minute of compile on one core."""
    x = np.random.default_rng(10).standard_normal((2, 64, 64, 1)).astype(
        np.float32)
    jm = jvm.MSVMUNetLegacy(num_classes=9, enc_name="vssm_test",
                            scan_backend="ref")
    rng = np.random.default_rng(10)
    sd = {k: t.numpy().copy() for k, t in build_legacy_model(
        enc_name="vssm_test", device="cpu", seed=10).state_dict().items()}
    for k, a in sd.items():
        if k.endswith("running_var"):
            sd[k] = a + rng.random(a.shape).astype(np.float32) * 0.3
        elif k.endswith(PERTURBED):
            sd[k] = a + rng.standard_normal(a.shape).astype(np.float32) * .1
    v = convert_msvm_legacy_state_dict(*_split(sd), VSSM_TEST_DEPTHS,
                                       DEC_DEPTHS)
    # a complete tree of the JAX model
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    assert jax.tree_util.tree_map(np.shape, v) == \
        jax.tree_util.tree_map(lambda s: s.shape, shapes)
    apply = jax.jit(lambda v, x: jm.apply(
        v, x, capture_intermediates=lambda mdl, _: mdl.name == "encoder",
        mutable=["intermediates"]))
    logits, inter = apply(v, jnp.asarray(x))
    feats = inter["intermediates"]["encoder"]["__call__"][0]
    model = build_legacy_model(enc_name="vssm_test", device="cpu")
    jax_import.load_numpy_state_dict(model, jax_import.legacy_state_dict_from_jax(
        v, VSSM_TEST_DEPTHS, DEC_DEPTHS))
    return dict(x=x, v=v, jm=jm, logits=np.asarray(logits),
                feats=[np.asarray(f) for f in feats], model=model)


def test_legacy_weight_bridge_round_trip(legacy):
    """JAX variables -> legacy_state_dict_from_jax ->
    convert_msvm_legacy_state_dict gives back every leaf exactly."""
    v = legacy["v"]
    sd = jax_import.legacy_state_dict_from_jax(v, VSSM_TEST_DEPTHS,
                                               DEC_DEPTHS)
    back = convert_msvm_legacy_state_dict(*_split(sd), VSSM_TEST_DEPTHS,
                                          DEC_DEPTHS)
    want = jax.tree_util.tree_leaves_with_path(v)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_tiny_0230s_keys_are_the_reference_keys():
    """The port's tiny_0230s state_dict has exactly the keys and shapes the
    JAX tree maps to, and ``convert_msvm_legacy_state_dict`` reads it into
    the JAX package's tree (shapes from jax.eval_shape: no full-size
    init)."""
    jm = jvm.MSVMUNetLegacy(num_classes=9, enc_name="tiny_0230s",
                            scan_backend="assoc")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 1)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    want = {k: a.shape for k, a in jax_import.legacy_state_dict_from_jax(
        zeros).items()}
    sd = vmamba.MSVMUNetLegacy(num_classes=9).state_dict()
    assert {k: tuple(t.shape) for k, t in sd.items()} == want
    tree = convert_msvm_legacy_state_dict(*_split(sd))
    got = jax.tree_util.tree_map(np.shape, tree)
    assert got == jax.tree_util.tree_map(lambda s: s.shape, shapes)
    for k in ("encoder.patch_embed.7.weight", "encoder.downsamples.2.1.weight",
              "encoder.layers.2.blocks.7.op.A_logs",
              "decoder.layers.0.up.expand.1.running_var",
              "decoder.layers.2.vss_layer.blocks.1.mlp.multiscale_conv."
              "dwconv_h.0.weight", "decoder.out_layers.0.out.weight"):
        assert k in sd


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_vssm_stage_matches_jax(legacy, stage):
    with torch.no_grad():
        feats = legacy["model"].encoder(
            _t(legacy["x"]).expand(-1, -1, -1, 3).contiguous())
    np.testing.assert_allclose(feats[stage].numpy(), legacy["feats"][stage],
                               **STAGE_TOL)


def test_legacy_logits_match_jax(legacy):
    with torch.no_grad():
        got = legacy["model"](_t(legacy["x"]))
    assert got.shape == (2, 64, 64, 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), legacy["logits"], **LOGITS_TOL)


def test_legacy_bf16_forward_close_to_fp32(legacy):
    model, x = legacy["model"], _t(legacy["x"])
    with torch.no_grad():
        ref = model(x)
        model.dtype = torch.bfloat16
        bf = model(x)
        model.dtype = torch.float32
    assert bf.dtype == torch.bfloat16
    assert (bf.float() - ref).abs().max().item() <= \
        0.05 * ref.abs().max().item()


def test_predict_volume_legacy_matches_jax(legacy):
    vol = np.random.default_rng(11).random((3, 80, 80)).astype(np.float32)
    want = jpredict_volume(legacy["jm"].apply, legacy["v"], vol, (64, 64),
                           batch_size=2)
    got = predict_volume(legacy["model"], vol, (64, 64), batch_size=2)
    assert got.shape == (3, 80, 80) and got.min() >= 0 and got.max() < 9
    assert (got == want).mean() >= 0.999


def test_legacy_entry_on_cpu():
    from ceigm_unet_tpu_torch.entry import legacy_entry
    model, x = legacy_entry(device="cpu")
    assert not model.training and x.shape == (1, 224, 224, 1)
    assert {len(layer.blocks) for layer in model.encoder.layers} == {2, 8}
    n_ss2d = sum(isinstance(m, SS2D) for m in model.modules())
    assert n_ss2d == 20 and all(m.d_state == 1 for m in model.modules()
                                if isinstance(m, SS2D))
