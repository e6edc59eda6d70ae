"""Core dataflow model: the L1'/L2' capability layer (SURVEY.md §2.1)."""
