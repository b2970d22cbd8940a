"""Data pipelines of the port (numpy, no device)."""
