"""CNN model zoo and the float32 oracle; the LM layers (dense and
Mamba-2), stacks and Model."""
