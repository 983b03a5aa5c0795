"""Columnar data: torch column vectors and batches."""
