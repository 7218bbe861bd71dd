"""Token data pipeline (numpy)."""
