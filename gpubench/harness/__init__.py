"""The benchmark's harness: set-up, window, check and yardstick."""
