"""The plain reference: float64 PyTorch, importing nothing of the program."""
