"""The benchmark's plain reference (plain PyTorch, none of the program)."""
