"""Multi-level weight cache (pure Python and numpy, as in the reference)."""
