"""The benchmark's plain references (float32 PyTorch, no program code)."""
