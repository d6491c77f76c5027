"""The plain PyTorch reference of the served program; it imports nothing
of the program under test."""
