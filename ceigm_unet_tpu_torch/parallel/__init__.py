"""Data parallelism over a ``torch.distributed`` group and the
sequence-parallel ring scan (counterpart of ``ceigm_unet_tpu/parallel``)."""
from ceigm_unet_tpu_torch.parallel.mesh import (init_data_parallel,
                                                shard_batch)
from ceigm_unet_tpu_torch.parallel.ring_scan import (selective_scan_sp,
                                                     sequence_parallel_scan,
                                                     stacked_ring_scan)

__all__ = ["init_data_parallel", "shard_batch", "sequence_parallel_scan",
           "stacked_ring_scan", "selective_scan_sp"]
