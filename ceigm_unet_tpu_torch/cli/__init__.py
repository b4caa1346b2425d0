"""Command-line tools: test-set inference and the parameter count."""
