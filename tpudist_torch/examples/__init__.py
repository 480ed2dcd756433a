"""The port's example entry points (``python -m
tpudist_torch.examples.demo``), counterparts of the JAX package's
``examples/``."""
