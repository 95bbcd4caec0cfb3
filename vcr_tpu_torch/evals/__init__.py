"""Caption quality metrics and the Porter stemmer they use."""
