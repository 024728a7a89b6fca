"""Process models on stacked ``(nx, ...)`` tensors."""
