"""Optimizers of the port (``optim``): plain functions on dicts of tensors."""
