"""Plain float32 PyTorch references of what the benchmark's cells serve
and train. They import nothing of the program."""
