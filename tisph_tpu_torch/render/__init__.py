"""Render / export (the counterpart of ``tisph_tpu.render``): frame export
with the device-to-host copy off the step's critical path, 2D ball
pivoting, the 3D surface guards, the matplotlib viewers and GIF assembly;
all of it reads a state through the host."""
