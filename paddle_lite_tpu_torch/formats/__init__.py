"""Graph formats."""
