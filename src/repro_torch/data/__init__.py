"""The synthetic training data pipeline (``pipeline``)."""
