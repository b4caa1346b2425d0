"""The benchmark's own tests: run from the repository's root with
``python -m pytest benchmark/tests``; those marked ``cuda`` skip without a
card."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# gm_test's sizes: the served package's test-only miniature
TINY_CONFIG = {"name": "gm_test", "enc_name": "gm_test",
               "stem_hidden_dim": 8, "embed_dims": [16, 32, 48, 64],
               "mlp_ratios": [2, 2, 2, 2], "depths": [1, 1, 1, 1],
               "decoder_front_depths": [3, 2, 2], "num_classes": 9,
               "img_size": 32}
TINY_VOLUMES = {"kind": "volumes", "dtype": "float32", "batch": 4,
                "patch": [32, 32], "slice_hw": [48, 48], "depth_low": 3,
                "depth_high": 7, "depth_count": 3, "pool_slices": 24,
                "sample_volumes": 2, "trace_volumes": 2}
TINY_TRAIN = {"kind": "train_steps", "dtype": "float32", "batch": 4,
              "img": 32, "batches": 4, "checked_steps": 3,
              "window_check_step": 5, "trace_steps": 2,
              "recipe": {"lr": 0.0005, "weight_decay": 0.001,
                         "eta_min": 1e-06, "t_max": 300,
                         "steps_per_epoch": 46, "ce_weight": 0.4,
                         "dc_weight": 0.6, "drop_path_rate": 0.2}}


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
