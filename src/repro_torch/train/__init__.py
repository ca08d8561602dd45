"""Checkpointing and the restartable training loop (counterpart of
``repro.train``)."""
