"""The yardstick: what the harness does the same way for every cell."""
