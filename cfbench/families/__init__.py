"""The program's side of each model family: how the benchmark builds the
port's model through its registry, reads its public tables, and which of
the port's functions it wraps from outside (``README.md``)."""
