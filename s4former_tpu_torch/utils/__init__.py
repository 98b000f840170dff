"""Host utilities: logging."""
