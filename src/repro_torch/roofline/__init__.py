"""Roofline tools of the port: the card's peaks, a per-rank step cost counter, the roofline report."""
