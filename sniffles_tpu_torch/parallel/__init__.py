"""Device combine: packers, replay and host-vectorized segmentation."""
