"""End-to-end scripts of the port (counterparts of the repository's
``examples/``): ``python -m repro_torch.examples.<name>``."""
