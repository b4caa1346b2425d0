"""Weight bridges between the JAX package's variables and the port."""
