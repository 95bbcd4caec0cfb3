"""Plain float32 references, one module per model family, named by the
family's ``arch``; none imports the program."""
