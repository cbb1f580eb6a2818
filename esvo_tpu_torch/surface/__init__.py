"""The time-surface engine."""
