"""Expressions evaluated eagerly on torch tensors."""
