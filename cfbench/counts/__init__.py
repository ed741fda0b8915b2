"""Each family's useful work of one epoch, counted from the cell's
inputs alone (never from the program's plan, order or padding)."""
