"""Relations held outside the query plan (device cache)."""
