"""Operation and byte counts of each family's work, from its shapes."""
