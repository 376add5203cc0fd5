"""Readers of the reference pipeline's cache artifacts."""
