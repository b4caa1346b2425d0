"""The legacy encoder's pretrained loader (``convert/vssm_import.py``)
against the JAX package's ``convert_vssm_state_dict`` /
``convert_msvm_legacy_state_dict``, on the CPU.

A VSSM checkpoint is built from a seeded port model (vssm_test, biases, BN
statistics, A_logs and Ds moved off their init values), saved the way
VMamba releases them (under ``"model"``, with the classifier's keys); JAX
converts the same tensors. Tolerances (tests/test_torch_vmamba.py): logits
rtol 1e-3 / atol 1e-3, encoder stages rtol 1e-3 / atol 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ceigm_unet_tpu.convert.vssm_import import (convert_msvm_legacy_state_dict,
                                                convert_vssm_state_dict)
from ceigm_unet_tpu.models import vmamba as jvm
from ceigm_unet_tpu_torch.convert.vssm_import import (
    load_msvm_legacy_state_dict, load_vssm_encoder, vssm_encoder_state_dict)
from ceigm_unet_tpu_torch.models import build_legacy_model, vmamba

torch.set_num_threads(1)

LOGITS_TOL = dict(rtol=1e-3, atol=1e-3)
STAGE_TOL = dict(rtol=1e-3, atol=2e-4)
VSSM_TEST_DEPTHS = (1, 1, 1, 1)
DEC_DEPTHS = (2, 2, 2, 2)
PERTURBED = ("bias", "running_mean", "A_logs", "Ds")


def _perturbed(model, seed):
    rng = np.random.default_rng(seed)
    sd = {k: t.numpy().copy() for k, t in model.state_dict().items()}
    for k, a in sd.items():
        if k.endswith("running_var"):
            sd[k] = a + rng.random(a.shape).astype(np.float32) * 0.3
        elif k.endswith(PERTURBED):
            sd[k] = a + rng.standard_normal(a.shape).astype(np.float32) * .1
    return sd


def _part(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _classifier(dim, rng):
    """VMamba's classification head keys (norm and head of a 1000-way
    classifier)."""
    return {"classifier.norm.weight": np.ones(dim, np.float32),
            "classifier.norm.bias": np.zeros(dim, np.float32),
            "classifier.head.weight": rng.standard_normal(
                (1000, dim)).astype(np.float32),
            "classifier.head.bias": np.zeros(1000, np.float32)}


def test_legacy_model_loads_what_jax_converts(tmp_path):
    x = np.random.default_rng(10).standard_normal((2, 32, 32, 1)).astype(
        np.float32)
    sd = _perturbed(build_legacy_model(enc_name="vssm_test", device="cpu",
                                       seed=10), 10)
    enc, dec = _part(sd, "encoder."), _part(sd, "decoder.")
    jm = jvm.MSVMUNetLegacy(num_classes=9, enc_name="vssm_test",
                            scan_backend="ref")
    v = convert_msvm_legacy_state_dict(enc, dec, VSSM_TEST_DEPTHS,
                                       DEC_DEPTHS)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))

    ckpt = {"model": {**{k: torch.from_numpy(a) for k, a in enc.items()},
                      **{k: torch.from_numpy(a) for k, a in _classifier(
                          64, np.random.default_rng(0)).items()}}}
    path = str(tmp_path / "vssm_test.pth")
    torch.save(ckpt, path)
    # the encoder from the file, the decoder from its own state_dict
    model = build_legacy_model(enc_name="vssm_test", device="cpu", seed=99)
    load_vssm_encoder(model, path)
    model.decoder.load_state_dict({k: torch.from_numpy(a)
                                   for k, a in dec.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **LOGITS_TOL)
    # the (encoder, decoder) pair loader, from the wrapped checkpoint
    pair = build_legacy_model(enc_name="vssm_test", device="cpu", seed=98)
    load_msvm_legacy_state_dict(pair, ckpt, {k: torch.from_numpy(a)
                                             for k, a in dec.items()})
    for k, t in pair.state_dict().items():
        assert torch.equal(t, model.state_dict()[k]), k


def test_checkpoint_unwrapping_classifier_and_strict_keys():
    rng = np.random.default_rng(1)
    enc = {k: torch.from_numpy(a) for k, a in _part(_perturbed(
        build_legacy_model(enc_name="vssm_test", device="cpu"), 1),
        "encoder.").items()}
    head = {k: torch.from_numpy(a) for k, a in _classifier(64, rng).items()}
    for ckpt in ({"model": {**enc, **head}}, {"state_dict": {**enc, **head}},
                 {**enc, **head}):
        assert vssm_encoder_state_dict(ckpt).keys() == enc.keys()
    model = build_legacy_model(enc_name="vssm_test", device="cpu", seed=5)
    dec0 = {k: t.clone() for k, t in model.decoder.state_dict().items()}
    load_vssm_encoder(model, {"model": {**enc, **head}})
    for k, t in model.encoder.state_dict().items():
        assert torch.equal(t, enc[k]), k
    for k, t in model.decoder.state_dict().items():
        assert torch.equal(t, dec0[k]), k
    # a key the encoder lacks, and one the file lacks, are refused
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_vssm_encoder(model, {**enc, "layers.0.blocks.0.extra":
                                  torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Unexpected key.*pos_embed"):
        load_vssm_encoder(model, {**enc, "pos_embed": torch.zeros(
            1, 16, 8, 8)})
    short = dict(enc)
    del short["layers.0.blocks.0.op.A_logs"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_vssm_encoder(model, short)


class _Encoder(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.encoder = vmamba.VSSM(**kw)


def test_pos_embed_stays_channel_first_and_matches_jax():
    """A VSSM with ``pos_embed`` (two stages): the loader keeps its (1, C,
    H, W) storage, which JAX's converter transposes; the stages agree."""
    kw = dict(dims=(16, 32), depths=(1, 1), drop_path_rate=0.0,
              posembed=True)
    src = _Encoder(img_size=32, **kw)
    vmamba.init_legacy_weights(src, torch.Generator().manual_seed(3))
    sd = _perturbed(src.encoder, 3)
    sd["pos_embed"] = sd["pos_embed"] + np.random.default_rng(
        3).standard_normal(sd["pos_embed"].shape).astype(np.float32) * 0.1
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jm = jvm.VSSM(scan_backend="ref", **kw)
    params = convert_vssm_state_dict(sd, depths=(1, 1))
    assert params["pos_embed"].shape == (1, 8, 8, 16)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    model = _Encoder(img_size=32, **kw)
    load_vssm_encoder(model, {"model": {
        **{k: torch.from_numpy(a) for k, a in sd.items()},
        **{k: torch.from_numpy(a) for k, a in _classifier(
            32, np.random.default_rng(5)).items()}}})
    assert tuple(model.encoder.pos_embed.shape) == (1, 16, 8, 8)
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STAGE_TOL)
    # a checkpoint without pos_embed does not fill a model that has one
    with pytest.raises(RuntimeError, match="Missing key.*pos_embed"):
        load_vssm_encoder(model, {k: torch.from_numpy(a)
                                  for k, a in sd.items() if k != "pos_embed"})
