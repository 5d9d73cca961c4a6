"""Host-side helpers (port of ihmr_tpu/utils/): file IO (``io_utils``), the
mesh renderer (``vis``), the training panels (``train_visuals``), the
gallery and loss curves (``visualizer``) and the live training monitor
(``live_dashboard``)."""
