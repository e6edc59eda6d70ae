"""Audio elements (reference audio/, SURVEY.md §2.2)."""
