"""The benchmark's references: plain numpy and PyTorch, importing nothing
of the program under test."""
