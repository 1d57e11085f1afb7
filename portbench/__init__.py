"""The port's benchmark: one harness, cells found by name (README.md)."""
