"""JAX variables -> port ``state_dict``: the exact inverse of
``ceigm_unet_tpu/convert/torch_import.py`` ``convert_msvm_unet_state_dict``
(:func:`state_dict_from_jax`) and of ``convert/vssm_import.py``
``convert_msvm_legacy_state_dict`` (:func:`legacy_state_dict_from_jax`).

Layouts: flax Dense kernel (in, out) -> Linear (out, in); flax Conv kernel
(kh, kw, in/g, out) -> Conv2d (out, in/g, kh, kw); stacked QuadGroupSS2D
arrays -> per-group ``mamba_g1..g4``; BatchNorm params scale/bias + stats
mean/var -> weight/bias/running_mean/running_var. Works on numpy arrays
(anything ``np.asarray`` takes) and returns numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

SD = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.array(x, copy=True)


def _put(sd: SD, prefix: str, part: Mapping[str, Any]) -> SD:
    for k, v in part.items():
        sd[f"{prefix}.{k}" if prefix else k] = v
    return sd


def dense(p) -> SD:
    out = {"weight": _a(p["kernel"]).T.copy()}
    if "bias" in p:
        out["bias"] = _a(p["bias"])
    return out


def conv(p) -> SD:
    out = {"weight": _a(p["kernel"]).transpose(3, 2, 0, 1).copy()}
    if "bias" in p:
        out["bias"] = _a(p["bias"])
    return out


def layer_norm(p) -> SD:
    return {"weight": _a(p["scale"]), "bias": _a(p["bias"])}


def batch_norm(p, s) -> SD:
    return {"weight": _a(p["scale"]), "bias": _a(p["bias"]),
            "running_mean": _a(s["mean"]), "running_var": _a(s["var"]),
            "num_batches_tracked": np.array(0, np.int64)}


def quad_ss2d(p) -> SD:
    """Stacked QuadGroupSS2D params -> ``mamba_g{1..4}.*``."""
    ssm = p["ssm"]
    conv_k, conv_b = _a(p["conv2d"]["kernel"]), _a(p["conv2d"]["bias"])
    K = _a(p["in_proj_weight"]).shape[0]
    D = conv_b.shape[0] // K
    sd: SD = {}
    for k in range(K):
        c = slice(k * D, (k + 1) * D)
        _put(sd, f"mamba_g{k + 1}", {
            "in_proj.weight": _a(p["in_proj_weight"][k]).T.copy(),
            "conv2d.weight": conv_k[..., c].transpose(3, 2, 0, 1).copy(),
            "conv2d.bias": conv_b[c],
            "x_proj_weight": _a(ssm["x_proj_weight"][k:k + 1]),
            "dt_projs_weight": _a(ssm["dt_projs_weight"][k:k + 1]),
            "dt_projs_bias": _a(ssm["dt_projs_bias"][k:k + 1]),
            "A_logs": _a(ssm["A_logs"])[c],
            "Ds": _a(ssm["Ds"])[c],
            "out_norm.weight": _a(p["out_norm_scale"][k]),
            "out_norm.bias": _a(p["out_norm_bias"][k]),
            "out_proj.weight": _a(p["out_proj_weight"][k]).T.copy(),
        })
    return sd


def gm_layer(p) -> SD:
    sd = quad_ss2d(p["mamba"])
    for name, fn in (("norm", layer_norm), ("fc1", dense), ("fc2", dense),
                     ("proj", dense)):
        _put(sd, name, fn(p[name]))
    sd["skip_scale"] = _a(p["skip_scale"])
    return sd


def pvt2_ffn(p) -> SD:
    sd = _put({}, "fc1", dense(p["fc1"]))
    _put(sd, "dwconv.dwconv", conv(p["dwconv"]))
    return _put(sd, "fc2", dense(p["fc2"]))


def custom_ffn(p) -> SD:
    sd = pvt2_ffn(p)
    for k in (3, 5, 7):
        _put(sd, f"custom.dwconv_{k}x{k}", conv(p["custom"][f"dw{k}"]))
    return sd


def block_mamba(p, custom: bool) -> SD:
    sd = _put({}, "attn", gm_layer(p["attn"]))
    _put(sd, "norm2", layer_norm(p["norm2"]))
    return _put(sd, "mlp", (custom_ffn if custom else pvt2_ffn)(p["mlp"]))


def groupmamba(params, stats, depths: Sequence[int]) -> SD:
    pe, st = params["patch_embed1"], stats["patch_embed1"]
    sd: SD = {}
    for i, n in enumerate(("1", "2", "3")):
        _put(sd, f"patch_embed1.conv.{3 * i}", conv(pe[f"conv{n}"]))
        _put(sd, f"patch_embed1.conv.{3 * i + 1}",
             batch_norm(pe[f"bn{n}"], st[f"bn{n}"]))
    _put(sd, "patch_embed1.proj", conv(pe["proj"]))
    _put(sd, "patch_embed1.norm", layer_norm(pe["norm"]))
    for i in range(1, 4):
        _put(sd, f"patch_embed{i + 1}.proj",
             conv(params[f"patch_embed{i + 1}"]["proj"]))
        _put(sd, f"patch_embed{i + 1}.norm",
             layer_norm(params[f"patch_embed{i + 1}"]["norm"]))
    for i, depth in enumerate(depths):
        for j in range(depth):
            _put(sd, f"block{i + 1}.{j}",
                 block_mamba(params[f"block{i + 1}_{j}"], custom=False))
        _put(sd, f"norm{i + 1}", layer_norm(params[f"norm{i + 1}"]))
    return sd


def lgag(p, s) -> SD:
    sd: SD = {}
    for a in ("g", "x"):
        for k in (1, 3, 5):
            _put(sd, f"W_{a}_{k}", conv(p[f"W_{a}_{k}"]))
    _put(sd, "bn", batch_norm(p["bn"], s["bn"]))
    _put(sd, "psi.0", conv(p["psi_conv"]))
    return _put(sd, "psi.1", batch_norm(p["psi_bn"], s["psi_bn"]))


def dysample(p, s) -> SD:
    sd = _put({}, "offset.0", conv(p["offset0"]))
    _put(sd, "offset.1", conv(p["offset1"]))
    _put(sd, "eu.up_dwc.0", conv(p["eu"]["up_dwc"]))
    _put(sd, "eu.up_dwc.1", batch_norm(p["eu"]["bn"], s["eu"]["bn"]))
    return _put(sd, "eu.pwc.0", conv(p["eu"]["pwc"]))


def emcad(params, stats, front_depths: Sequence[int]) -> SD:
    sd: SD = {}
    for idx in (1, 2, 3, 4):
        _put(sd, f"cc{idx}.cw", conv(params[f"cc{idx}"]["cw"]))
        pa = params[f"para{idx}"]
        ca, sa = pa["channel_attention"], pa["spatial_attention"]
        pre = f"para{idx}.channel_attention"
        for n in ("conv1", "conv2_1", "conv2_2", "conv3"):
            _put(sd, f"{pre}.{n}", conv(ca[n]))
        _put(sd, f"{pre}.fc.0", conv(ca["fc"]))
        for n in ("conv3", "conv7", "conv11"):
            _put(sd, f"para{idx}.spatial_attention.{n}", conv(sa[n]))
        sd[f"para{idx}.x"] = _a(pa["mix"]).reshape(1)
        _put(sd, f"para{idx}.final_conv", conv(pa["final_conv"]))
    for idx in (1, 2, 3):
        _put(sd, f"lgag{idx}", lgag(params[f"lgag{idx}"],
                                    stats[f"lgag{idx}"]))
        _put(sd, f"eucb{idx}", dysample(params[f"eucb{idx}"],
                                        stats[f"eucb{idx}"]))
    for fi, depth in enumerate(front_depths):
        for i in range(depth):
            _put(sd, f"f{fi + 1}.cm_layer.blocks.{i}",
                 block_mamba(params[f"f{fi + 1}"][f"block{i}"], custom=True))
    return _put(sd, "out_head1", conv(params["out_head1"]))


def state_dict_from_jax(variables: Mapping[str, Any],
                        depths: Sequence[int] = (3, 4, 9, 3),
                        front_depths: Sequence[int] = (3, 2, 2)) -> SD:
    """JAX MSVMUNet ``{"params", "batch_stats"}`` -> the port's (and the
    reference torch model's) ``state_dict`` as numpy arrays."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd = _put({}, "encoder.gm_encoder", groupmamba(
        p["encoder"], s.get("encoder", {}), depths))
    return _put(sd, "decoder", emcad(p["decoder"], s.get("decoder", {}),
                                     front_depths))


# --- the legacy MSVM-UNet (VSSM encoder + legacy decoder) --------------------
# the exact inverse of ceigm_unet_tpu/convert/vssm_import.py: flax trees
# -> the reference torch keys (the SSM arrays sit directly under ``op.``)

MS_MLP_CONVS = (("hw3", "dwconv_hw.0"), ("hw5", "dwconv_hw.1"),
                ("hw7", "dwconv_hw.2"), ("w11", "dwconv_w.0"),
                ("w5", "dwconv_w.1"), ("h11", "dwconv_h.0"),
                ("h5", "dwconv_h.1"))


def vssm_ss2d(p) -> SD:
    """flax SS2D tree -> ``in_proj, conv2d, x_proj_weight, ..., out_proj``."""
    sd = _put({}, "in_proj", dense(p["in_proj"]))
    _put(sd, "conv2d", conv(p["conv2d"]))
    sd.update({k: _a(v) for k, v in p["ssm"].items()})
    _put(sd, "out_norm", layer_norm(p["out_norm"]))
    return _put(sd, "out_proj", dense(p["out_proj"]))


def vss_block(p) -> SD:
    """VSSBlock: ``norm, op, norm2, mlp`` (MS_MLP or the plain MLP)."""
    sd = _put({}, "norm", layer_norm(p["norm"]))
    _put(sd, "op", vssm_ss2d(p["op"]))
    _put(sd, "norm2", layer_norm(p["norm2"]))
    m = p["mlp"]
    _put(sd, "mlp.fc1", dense(m["fc1"]))
    for name, key in MS_MLP_CONVS if "multiscale_conv" in m else ():
        _put(sd, f"mlp.multiscale_conv.{key}",
             conv(m["multiscale_conv"][name]))
    return _put(sd, "mlp.fc2", dense(m["fc2"]))


def lkpe(p, s) -> SD:
    """LKPE / FLKPE: ``expand.{0,1,3}``, ``norm`` (and FLKPE's ``out``)."""
    sd = _put({}, "expand.0", conv(p["expand0"]))
    _put(sd, "expand.1", batch_norm(p["bn"], s["bn"]))
    _put(sd, "expand.3", conv(p["expand1"]))
    _put(sd, "norm", layer_norm(p["norm"]))
    if "out" in p:
        _put(sd, "out", conv(p["out"]))
    return sd


def vssm(p, depths: Sequence[int]) -> SD:
    """flax VSSM tree (patch embed v2, downsample v2/v3) ->
    ``patch_embed.{0,2,5,7}``, ``layers.{i}.blocks.{j}.*``,
    ``downsamples.{i}.{1,3}`` (and ``pos_embed``, channel-first)."""
    sd: SD = {}
    for name, idx, fn in (("patch_embed0", 0, conv), ("patch_norm0", 2,
                                                      layer_norm),
                          ("patch_embed1", 5, conv), ("patch_norm1", 7,
                                                      layer_norm)):
        _put(sd, f"patch_embed.{idx}", fn(p[name]))
    if "pos_embed" in p:
        sd["pos_embed"] = _a(p["pos_embed"]).transpose(0, 3, 1, 2).copy()
    for i, depth in enumerate(depths):
        for j in range(depth):
            _put(sd, f"layers.{i}.blocks.{j}",
                 vss_block(p[f"layer{i}_block{j}"]))
        if i < len(depths) - 1:
            _put(sd, f"downsamples.{i}.1", conv(p[f"downsample{i}_conv"]))
            _put(sd, f"downsamples.{i}.3",
                 layer_norm(p[f"downsample{i}_norm"]))
    return sd


def legacy_decoder(params, stats, depths: Sequence[int]) -> SD:
    sd: SD = {}
    for i in range(len(depths) - 1):
        p, s = params[f"layer{i}"], stats[f"layer{i}"]
        _put(sd, f"layers.{i}.up", lkpe(p["up"], s["up"]))
        _put(sd, f"layers.{i}.concat_layer", dense(p["concat_layer"]))
        for j in range(depths[i + 1]):
            _put(sd, f"layers.{i}.vss_layer.blocks.{j}",
                 vss_block(p["vss_layer"][f"block{j}"]))
    return _put(sd, "out_layers.0", lkpe(params["out_layer"],
                                         stats["out_layer"]))


def legacy_state_dict_from_jax(variables: Mapping[str, Any],
                               enc_depths: Sequence[int] = (2, 2, 8, 2),
                               dec_depths: Sequence[int] = (2, 2, 2, 2)
                               ) -> SD:
    """JAX MSVMUNetLegacy ``{"params", "batch_stats"}`` -> the port's (and
    the reference torch model's) ``state_dict`` as numpy arrays; the
    inverse of ``convert_msvm_legacy_state_dict``."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd = _put({}, "encoder", vssm(p["encoder"], enc_depths))
    return _put(sd, "decoder", legacy_decoder(p["decoder"],
                                              s.get("decoder", {}),
                                              dec_depths))


def load_numpy_state_dict(module: torch.nn.Module, sd: SD) -> None:
    """``module.load_state_dict`` of numpy arrays, strict."""
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in sd.items()}, strict=True)
