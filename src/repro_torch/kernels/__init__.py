"""Kernel wrappers, plans, and their plain PyTorch versions."""
