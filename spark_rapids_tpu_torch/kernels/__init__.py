"""Kernel layer: plain PyTorch steps and the hand-written Hopper kernels."""
