"""Video elements (reference video/, SURVEY.md §2.3)."""
