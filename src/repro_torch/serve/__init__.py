"""Batched LM serving (the port's counterpart of the JAX package's
``repro.serve``)."""
from repro_torch.serve.engine import ServeEngine  # noqa: F401
