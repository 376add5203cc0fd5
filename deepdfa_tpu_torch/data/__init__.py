"""Data sources."""
