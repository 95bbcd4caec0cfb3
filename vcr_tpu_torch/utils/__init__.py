"""Training-loop helpers: logging, step timing and tracing, sample display."""
