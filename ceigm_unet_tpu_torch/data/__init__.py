"""Training and evaluation data: the Synapse and ACDC readers, the host
augmentation policy, the batch loader and the on-device augmentation."""
