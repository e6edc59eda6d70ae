"""Network elements (reference net/): only what the port's analytics
converters need."""
