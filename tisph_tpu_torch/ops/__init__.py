"""Device-side ops: smoothing kernels, EOS, grid binning, the plain
sweeps, and the CUDA kernels' wrappers (``ops.cuda``).  Re-exports the
names of ``tisph_tpu.ops``."""

from tisph_tpu_torch.ops.kernels import cubic_kernel, cubic_kernel_grad, cubic_kernel_sigma
from tisph_tpu_torch.ops.eos import tait_pressure
