"""Atomic, versioned, keep-k checkpoints."""
