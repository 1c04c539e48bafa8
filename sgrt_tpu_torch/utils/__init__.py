"""Host utilities: .obj parsing, PNG/GIF writers, device selection."""
