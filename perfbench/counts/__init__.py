"""Frozen operation and byte counts that the rooflines and mfu read."""
