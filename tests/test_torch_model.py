"""Port modules and the whole MSVM-UNet against the JAX package, on the
CPU, in fp32. The JAX side runs the generic ``scan_backend="assoc"`` path;
its variables reach the port through ``state_dict_from_jax`` and a strict
``load_state_dict``. Inputs and perturbed BatchNorm statistics are made with
numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceigm_unet_tpu.convert.torch_import import convert_msvm_unet_state_dict
from ceigm_unet_tpu.eval.volume import predict_volume as jpredict_volume
from ceigm_unet_tpu.models import build_model as jbuild_model
from ceigm_unet_tpu.models import emcad as jemcad
from ceigm_unet_tpu.models.layers import CustomFfn as JCustomFfn
from ceigm_unet_tpu.models.ss2d import QuadGroupSS2D as JQuadGroupSS2D
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.eval.volume import predict_volume
from ceigm_unet_tpu_torch.models import build_model
from ceigm_unet_tpu_torch.models.emcad import LGAG, DySample
from ceigm_unet_tpu_torch.models.layers import CustomFfn
from ceigm_unet_tpu_torch.models.ss2d import QuadGroupSS2D

torch.set_num_threads(1)

MODULE_TOL = dict(rtol=2e-4, atol=2e-4)
# tests/test_torch_parity.py's stage and logits tolerances
STAGE_TOL = dict(rtol=1e-3, atol=2e-4)
LOGITS_TOL = dict(rtol=1e-3, atol=1e-3)
GM_TEST_DEPTHS = (1, 1, 1, 1)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _perturb(tree, rng):
    """Move BN statistics and zero-initialised biases off their init values
    so that folding and bias paths are exercised."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k == "mean":
            tree[k] = v + rng.standard_normal(v.shape).astype(np.float32) * .1
        elif k == "var":
            tree[k] = v + rng.random(v.shape).astype(np.float32) * 0.3
        elif k in ("bias", "mix"):
            tree[k] = v + rng.standard_normal(v.shape).astype(np.float32) * .05
    return tree


def _init(module, seed, *args, **kw):
    rng = np.random.default_rng(seed)
    v = _numpy_tree(jax.jit(module.init)(jax.random.PRNGKey(seed), *args,
                                         **kw))
    return {k: _perturb(t, rng) for k, t in v.items()}


def _port(module, sd):
    jax_import.load_numpy_state_dict(module, sd)
    return module.eval()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# --- modules ------------------------------------------------------------------

def test_quad_group_ss2d_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 6, 10, 32)).astype(
        np.float32)
    jm = JQuadGroupSS2D(dim=32, scan_backend="assoc")
    v = _init(jm, 0, jnp.asarray(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    m = _port(QuadGroupSS2D(32), jax_import.quad_ss2d(v["params"]))
    with torch.no_grad():
        got = m(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def test_custom_ffn_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 7, 9, 16)).astype(
        np.float32)
    jm = JCustomFfn(hidden=64)
    v = _init(jm, 1, jnp.asarray(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    m = _port(CustomFfn(16, 64), jax_import.custom_ffn(v["params"]))
    with torch.no_grad():
        got = m(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def test_dysample_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 6, 7, 32)).astype(
        np.float32)
    jm = jemcad.DySample(in_channels=32, out_channels=16)
    v = _init(jm, 2, jnp.asarray(x))
    # DySample-sized learned offsets (a trained net's are O(1e-2) px)
    v["params"]["offset1"]["kernel"] = np.random.default_rng(3).standard_normal(
        v["params"]["offset1"]["kernel"].shape).astype(np.float32) * 0.05
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    m = _port(DySample(32, 16), jax_import.dysample(v["params"],
                                                    v["batch_stats"]))
    with torch.no_grad():
        got = m(_t(x))
    assert got.shape == (2, 12, 14, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def test_lgag_eval_matches_jax():
    rng = np.random.default_rng(4)
    g = rng.standard_normal((2, 6, 9, 16)).astype(np.float32)
    x = rng.standard_normal((2, 6, 9, 16)).astype(np.float32)
    jm = jemcad.LGAG(f_int=8, groups=8)
    v = _init(jm, 4, jnp.asarray(g), jnp.asarray(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(g), jnp.asarray(x))  # XLA path
    m = _port(LGAG(8), jax_import.lgag(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = m(_t(g), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


# --- whole model on gm_test ---------------------------------------------------

@pytest.fixture(scope="module")
def gm_test():
    """JAX gm_test model at 64x64, B=2: variables, input, logits and the
    encoder's feature pyramid; and the port loaded with the same weights."""
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 1)).astype(
        np.float32)
    jm = jbuild_model(enc_name="gm_test", scan_backend="assoc")
    rng = np.random.default_rng(6)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {k: _perturb(t, rng) for k, t in _numpy_tree(v).items()}
    apply = jax.jit(lambda v, x: jm.apply(
        v, x, capture_intermediates=lambda mdl, _: mdl.name == "encoder",
        mutable=["intermediates"]))
    logits, inter = apply(v, jnp.asarray(x))
    feats = inter["intermediates"]["encoder"]["__call__"][0]
    model = build_model(enc_name="gm_test")
    jax_import.load_numpy_state_dict(model, jax_import.state_dict_from_jax(
        v, depths=GM_TEST_DEPTHS))
    return dict(x=x, v=v, jm=jm, logits=np.asarray(logits),
                feats=[np.asarray(f) for f in feats], model=model)


def test_weight_bridge_round_trip(gm_test):
    v = gm_test["v"]
    back = convert_msvm_unet_state_dict(
        jax_import.state_dict_from_jax(v, depths=GM_TEST_DEPTHS),
        depths=GM_TEST_DEPTHS)
    want = jax.tree_util.tree_leaves_with_path(v)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_port_state_dict_keys_are_reference_keys(gm_test):
    keys = set(gm_test["model"].state_dict())
    for k in ("encoder.gm_encoder.block1.0.attn.mamba_g1.in_proj.weight",
              "decoder.lgag3.psi.0.weight", "decoder.para4.x",
              "decoder.f1.cm_layer.blocks.0.mlp.custom.dwconv_3x3.weight"):
        assert k in keys


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_encoder_stage_matches_jax(gm_test, stage):
    with torch.no_grad():
        feats = gm_test["model"].encoder.gm_encoder(
            _t(gm_test["x"]).expand(-1, -1, -1, 3))
    np.testing.assert_allclose(feats[stage].numpy(),
                               gm_test["feats"][stage], **STAGE_TOL)


def test_logits_match_jax(gm_test):
    with torch.no_grad():
        got = gm_test["model"](_t(gm_test["x"]))
    assert got.shape == (2, 64, 64, 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), gm_test["logits"], **LOGITS_TOL)


def test_bf16_forward_close_to_fp32(gm_test):
    """The bf16 compute path returns bf16 logits that stay close to fp32
    (bf16 rounding through ~20 layers)."""
    model = gm_test["model"]
    x = _t(gm_test["x"])
    with torch.no_grad():
        ref = model(x)
        model.dtype = torch.bfloat16
        bf = model(x)
        model.dtype = torch.float32
    assert bf.dtype == torch.bfloat16
    err = (bf.float() - ref).abs().max().item()
    assert err <= 0.05 * ref.abs().max().item()


def test_predict_volume_matches_jax(gm_test):
    vol = np.random.default_rng(7).random((3, 80, 80)).astype(np.float32)
    jm, v = gm_test["jm"], gm_test["v"]
    want = jpredict_volume(jm.apply, v, vol, (64, 64), batch_size=2)
    got = predict_volume(gm_test["model"], vol, (64, 64), batch_size=2)
    assert got.shape == (3, 80, 80) and got.min() >= 0 and got.max() < 9
    assert (got == want).mean() >= 0.999
