"""Debug-map rendering."""
