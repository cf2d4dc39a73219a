"""The plain reference: float32 PyTorch, apart from the program."""
