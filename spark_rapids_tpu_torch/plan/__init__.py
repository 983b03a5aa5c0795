"""Logical plan and planner."""
