"""The training data pipeline (numpy only): :mod:`.pipeline`."""
