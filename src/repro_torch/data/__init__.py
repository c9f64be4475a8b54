"""The synthetic token pipeline of training."""
