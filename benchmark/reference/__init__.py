"""Plain PyTorch reference of what the benchmark's cells run; it imports
neither JAX nor the served package."""
