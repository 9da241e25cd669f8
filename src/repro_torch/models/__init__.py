"""CNN model zoo and the float32 oracle; the dense LM layers, stacks and
Model."""
