"""Checkpoint reading and device selection."""
