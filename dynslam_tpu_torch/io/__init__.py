"""Inputs: the numpy synthetic scene renderer, segmentation masks,
calibration, LIDAR scans and dataset layouts."""
