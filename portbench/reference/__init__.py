"""Plain references that decide ``correct``: NumPy, the standard library
and plain PyTorch. They import nothing of the program, of the JAX package
or of JAX, and take nothing the program made: they work out again, from
the inputs the benchmark made, what the program derived."""
