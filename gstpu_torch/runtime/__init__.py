"""Runtime: cooperative scheduler and its IO reactor (L2')."""
