"""The optimizer of training and its compressed data-parallel step."""
