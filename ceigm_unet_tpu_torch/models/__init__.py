from ceigm_unet_tpu_torch.models.msvm_unet import MSVMUNet, build_model

__all__ = ["MSVMUNet", "build_model"]
