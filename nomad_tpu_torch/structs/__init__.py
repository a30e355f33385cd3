"""Host data model subset used by the placement slice."""
