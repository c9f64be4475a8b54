"""MIRAGE core: the paper's algorithm (host-exact + device)."""
