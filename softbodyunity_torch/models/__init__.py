"""Named workload presets."""
