"""FlowGNN, parameter conversion from the JAX package, and inference."""
