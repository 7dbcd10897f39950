"""Object tracks and their tracker (host-side, numpy)."""
