"""Caption files, the tokenizer and the host-side batch pipeline."""
