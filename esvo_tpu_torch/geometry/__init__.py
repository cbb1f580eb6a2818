"""Geometry: SE(3)/SO(3) helpers and camera models."""
