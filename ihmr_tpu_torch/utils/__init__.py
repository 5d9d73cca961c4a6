"""Host-side helpers (port of ihmr_tpu/utils/): file IO. The renderers,
visualizer and dashboard are not ported yet."""
