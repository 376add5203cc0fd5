"""Static-shape graph batching and segment ops."""
