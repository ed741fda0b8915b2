"""Command-line programs of the port."""
