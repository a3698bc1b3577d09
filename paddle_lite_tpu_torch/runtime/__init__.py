"""Inference runtime (Predictor)."""
