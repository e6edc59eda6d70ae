"""Text elements (reference text/)."""
