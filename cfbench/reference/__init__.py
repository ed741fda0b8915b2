"""The plain reference of cfbench: NumPy and plain PyTorch only.

Nothing here imports ``jax``, the JAX package or anything of the
program: the reference works out again, from the log, the configuration
and the seed, whatever the program derives from them (the chunks, the
epoch's visit order, the negatives' random bits and the initial tables)
and runs the same epoch in plain PyTorch.
"""
