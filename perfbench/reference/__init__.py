"""The plain reference of the benchmark: exact fixed-pattern matching in
plain PyTorch. It imports nothing of the program under test."""
