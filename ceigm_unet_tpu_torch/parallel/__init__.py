"""Data parallelism over a ``torch.distributed`` group, the
sequence-parallel ring scan, and the H-sharded model: its context, its
exchanges, the QuadGroupSS2D scan island and the whole model's forward and
gradients (``sp_context``, ``sp_ops``, ``sp_ss2d``, ``sp_model``);
counterpart of ``ceigm_unet_tpu/parallel``."""
from ceigm_unet_tpu_torch.parallel.mesh import (init_data_parallel,
                                                shard_batch)
from ceigm_unet_tpu_torch.parallel.ring_scan import (selective_scan_sp,
                                                     sequence_parallel_scan,
                                                     stacked_ring_scan)
from ceigm_unet_tpu_torch.parallel.sp_context import sp_scan_island, sp_stacked
from ceigm_unet_tpu_torch.parallel.sp_model import (sp_forward,
                                                    sp_forward_stacked,
                                                    sp_value_and_grad,
                                                    sp_value_and_grad_stacked)

__all__ = ["init_data_parallel", "shard_batch", "sequence_parallel_scan",
           "stacked_ring_scan", "selective_scan_sp", "sp_scan_island",
           "sp_stacked", "sp_forward", "sp_forward_stacked",
           "sp_value_and_grad", "sp_value_and_grad_stacked"]
