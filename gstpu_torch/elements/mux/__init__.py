"""Mux elements of the port: copies of gstpu/elements/mux/."""
