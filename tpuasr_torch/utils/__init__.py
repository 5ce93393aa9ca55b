"""Host utilities: the native host runtime (`native`)."""
