"""Host-side utilities: ids and errors."""
