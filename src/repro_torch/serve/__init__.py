"""Serving executors, the single-lane lane pool and the streaming session."""
