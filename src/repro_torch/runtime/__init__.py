"""Runtime support: checkpoints and integrity errors."""
