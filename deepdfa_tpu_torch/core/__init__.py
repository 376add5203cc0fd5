"""Configuration, device resolution and serving metrics."""
