"""Offline corpus preparation: captions, GloVe, CNN and YOLO features."""
