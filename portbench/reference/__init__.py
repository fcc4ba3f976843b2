"""Plain PyTorch references, one module per model, that the check holds
the port against.  They import nothing of the port."""
