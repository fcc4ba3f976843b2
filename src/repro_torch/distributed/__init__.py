"""Fault tolerance for the training loop."""
