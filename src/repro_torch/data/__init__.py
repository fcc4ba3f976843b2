"""Deterministic, resumable data streams."""
