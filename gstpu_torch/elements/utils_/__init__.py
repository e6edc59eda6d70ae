"""Supervision/utility elements (reference utils/)."""
