"""Example programs of the port, each runnable as ``python -m
cfdsim_tpu_torch.examples.<name>`` (the JAX package's ``examples/``)."""
