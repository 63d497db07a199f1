"""Plain float32 PyTorch references: no kernel, no cache, no batching, and
nothing of the program under test."""
