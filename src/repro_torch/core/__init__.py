"""The EnGN layer, its models and the prepared plan (PyTorch)."""
