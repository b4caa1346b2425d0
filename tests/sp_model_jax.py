"""The JAX side of tests/test_torch_sp_model.py and
tests/test_torch_sp_legacy.py: JAX's own ``sp_forward`` and
``sp_value_and_grad`` of the gm_test model and of the legacy vssm_test
model on one mesh. The tests run it in a spawned process per mesh, so that
their compiles overlap; the process inherits the test session's
environment (``tests/conftest.py``: the CPU platform with 8 virtual
devices)."""
import jax
import numpy as np
from jax.sharding import Mesh

from ceigm_unet_tpu.models import MSVMUNetLegacy, build_model
from ceigm_unet_tpu.parallel.sp_model import sp_forward, sp_value_and_grad


def reference(variables, x, labels, n):
    """(logits, loss, grads) of JAX's H-sharded gm_test (4 classes, its
    ``assoc`` scan outside the island) over n of the virtual devices, as
    numpy."""
    model = build_model(num_classes=4, enc_name="gm_test",
                        scan_backend="assoc")
    return _run(model, variables, x, labels, n)


def legacy_reference(variables, x, labels, n):
    """(logits, loss, grads) of JAX's H-sharded legacy MSVM-UNet (vssm_test,
    9 classes, its ``assoc`` scan, which GSPMD partitions) over n of the
    virtual devices, as numpy."""
    model = MSVMUNetLegacy(num_classes=9, enc_name="vssm_test",
                           scan_backend="assoc")
    return _run(model, variables, x, labels, n)


def _run(model, variables, x, labels, n):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    logits = sp_forward(model, variables, x, mesh)
    loss, grads = sp_value_and_grad(model, variables, x, labels, mesh)
    return (np.asarray(logits), float(loss),
            jax.tree_util.tree_map(np.asarray, grads))
