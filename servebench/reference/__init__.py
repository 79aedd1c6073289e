"""The plain reference of the benchmark's served models (PyTorch only)."""
