"""Inputs: the numpy synthetic scene renderer."""
