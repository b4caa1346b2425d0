"""The plain per-volume loop that ``predict_volume`` is held to in
tests/test_torch_eval.py (CPU) and tests/test_torch_cuda.py (card): the
volume padded with zero slices to whole batches on the host, each batch
zoomed, normalised, run, argmaxed and zoomed back, the maps joined and cut
to the volume's depth. Imports torch and the port only."""
import numpy as np
import torch

from ceigm_unet_tpu_torch.ops.resize import zoom_slices, zoom_slices_nearest


@torch.no_grad()
def plain_predict_volume(model, volume, patch, batch):
    device = next(model.parameters()).device
    D, H, W = volume.shape
    pad = (-D) % batch
    vol = np.concatenate([volume, np.zeros((pad, H, W), volume.dtype)])
    maps = []
    for i in range(0, len(vol), batch):
        x = zoom_slices(torch.from_numpy(np.ascontiguousarray(
            vol[i:i + batch], np.float32)).to(device), patch, order=3)
        logits = model(((x - 0.5) / 0.5)[..., None])
        maps.append(zoom_slices_nearest(torch.argmax(logits, -1),
                                        (H, W)).cpu().numpy())
    return np.concatenate(maps)[:D]
