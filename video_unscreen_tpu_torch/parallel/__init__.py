"""Training of the port (one device)."""
