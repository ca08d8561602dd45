"""Serving: engine, config, offline parameter preparation."""
