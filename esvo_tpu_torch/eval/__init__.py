"""Trajectory evaluation (ATE / RPE) and TUM export."""
