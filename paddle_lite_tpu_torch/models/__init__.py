"""Model zoo."""
