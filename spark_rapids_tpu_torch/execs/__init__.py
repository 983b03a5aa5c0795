"""Physical operators on torch batches."""
