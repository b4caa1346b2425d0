from ceigm_unet_tpu_torch.models.msvm_unet import MSVMUNet, build_model
from ceigm_unet_tpu_torch.models.vmamba import (MSVMUNetLegacy,
                                                build_legacy_model)

__all__ = ["MSVMUNet", "build_model", "MSVMUNetLegacy", "build_legacy_model"]
