"""Event framing and the synthetic stereo scene (numpy only)."""
