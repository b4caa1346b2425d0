"""Weights in and out: the bridge from the JAX package's variables,
Lightning checkpoints, and pretrained encoder checkpoints."""
