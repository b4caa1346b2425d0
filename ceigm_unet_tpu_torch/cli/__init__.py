"""Command-line tools: training (Synapse, ACDC), test-set inference and the
parameter count."""
