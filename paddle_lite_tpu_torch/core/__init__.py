"""Core IR, builder, registry, passes framework and executor."""
