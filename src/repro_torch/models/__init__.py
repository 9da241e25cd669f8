"""CNN model zoo and the float32 oracle."""
