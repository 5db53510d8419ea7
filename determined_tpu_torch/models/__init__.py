"""Model definitions (GPT-2) in PyTorch, in the JAX package's layouts."""
