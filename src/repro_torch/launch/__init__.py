"""Step factories driven by the serving engine."""
