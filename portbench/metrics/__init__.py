"""One reader per per-layer metric, `metrics/<metric>.py`, each with a
`read(ctx)` that returns the metric's value or None where its cell has
nothing to read."""
