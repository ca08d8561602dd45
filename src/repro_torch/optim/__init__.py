"""Optimizer and learning-rate schedules (counterpart of ``repro.optim``)."""
