"""Fault tolerance for the training loop, and int8 compression with
error feedback (gradients and streamed tile values)."""
