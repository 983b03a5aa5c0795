"""Shuffle: hash partitioning, the device-resident exchange and its block
catalog."""
