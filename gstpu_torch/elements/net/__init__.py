"""Network elements (reference net/)."""
