"""The static fused frame step and its builder."""
