"""The fit engine."""
