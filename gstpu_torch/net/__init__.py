"""Network protocol stacks (reference net/): sans-IO cores + elements."""
