"""Plain references of what the program computes: plain ``torch`` and
NumPy, nothing of the program."""
