"""Training (port of ``deepdfa_tpu/train``)."""
