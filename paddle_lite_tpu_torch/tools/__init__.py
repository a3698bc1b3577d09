"""Optimization entry point (opt)."""
