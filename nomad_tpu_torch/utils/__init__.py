"""Host utilities copied from the reference package."""
