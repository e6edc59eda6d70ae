"""Analytics elements (reference analytics/)."""
