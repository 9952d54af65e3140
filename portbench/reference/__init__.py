"""The plain reference the benchmark judges the program by. It imports
nothing of the program, of the JAX package or of JAX."""
