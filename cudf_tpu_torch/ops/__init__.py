"""Column operations: the groupby and join tiers, sorting, row operators,
compaction and copying."""
