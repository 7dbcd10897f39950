"""Offline outputs of a map: meshes and headless renders."""
