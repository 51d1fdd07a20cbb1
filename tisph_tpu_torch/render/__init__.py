"""Render / export: frame export with the device-to-host copy off the
step's critical path (the counterpart of ``tisph_tpu.render``)."""
