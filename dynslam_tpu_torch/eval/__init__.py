"""LIDAR depth evaluation of the fused pipelines and its CSV records."""
