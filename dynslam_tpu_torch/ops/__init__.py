"""Per-frame operators: stereo, features, egomotion, ICP, TSDF map, kernels."""
