"""Generic plumbing elements (reference generic/ + core equivalents)."""
