"""Card-side measurement drivers of the port (each needs a CUDA device)."""
