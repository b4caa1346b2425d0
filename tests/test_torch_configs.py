"""The GroupMamba configurations no other test builds, ``gm_small`` and
``gm_base`` (``models/groupmamba.py`` GROUPMAMBA_CONFIGS), against the JAX
package's, on the CPU: every parameter's and buffer's shape, through the
weight bridge's names, equals what the JAX model's ``jax.eval_shape`` gives
(no full-size init on either side), and every quad block's per-group width
stays within K1's ``kMaxD`` (``csrc/quad_scan_ln.cu``)."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ceigm_unet_tpu.models import msvm_unet as jmsvm
from ceigm_unet_tpu_torch.convert import jax_import
from ceigm_unet_tpu_torch.models.groupmamba import GROUPMAMBA_CONFIGS
from ceigm_unet_tpu_torch.models.msvm_unet import MSVMUNet
from ceigm_unet_tpu_torch.models.ss2d import QuadGroupSS2D

CSRC = Path(__file__).resolve().parents[1] / "ceigm_unet_tpu_torch" / "csrc"


@pytest.mark.parametrize("enc_name", ["gm_small", "gm_base"])
def test_config_shapes_match_jax_and_fit_k1(enc_name):
    cfg = GROUPMAMBA_CONFIGS[enc_name]
    jm = jmsvm.build_model(num_classes=9, enc_name=enc_name,
                           scan_backend="assoc")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 1)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    want = {k: a.shape for k, a in jax_import.state_dict_from_jax(
        zeros, depths=cfg["depths"]).items()}
    model = MSVMUNet(num_classes=9, enc_name=enc_name)
    got = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == want
    k_max_d = int(re.search(r"constexpr int kMaxD = (\d+);",
                            (CSRC / "quad_scan_ln.cu").read_text()).group(1))
    widths = {m.groups()[0].d_inner for m in model.modules()
              if isinstance(m, QuadGroupSS2D)}
    assert max(widths) <= k_max_d == 128
    assert max(widths) == {"gm_small": 128, "gm_base": 128}[enc_name]
    assert {"gm_small": 87, "gm_base": 106}[enc_name] in widths
