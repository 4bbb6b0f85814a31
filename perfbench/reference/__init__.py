"""Plain PyTorch references of what the timed path produces; nothing of the port is imported here."""
