"""Debug guards (counterpart of ``ceigm_unet_tpu/utils``)."""
