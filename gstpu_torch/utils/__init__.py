"""Utilities: logging, tracing, config (SURVEY.md §5)."""
