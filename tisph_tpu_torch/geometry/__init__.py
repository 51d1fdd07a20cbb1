"""Scene geometry: lattice samplers, mesh loading and voxelization,
``build_state`` and the emitters (numpy on the host, the state shipped to
the device once).  Re-exports the names of ``tisph_tpu.geometry``."""

from tisph_tpu_torch.geometry.sampler import cube_lattice
from tisph_tpu_torch.geometry.builder import build_state
from tisph_tpu_torch.geometry.mesh import TriMesh, load_obj
from tisph_tpu_torch.geometry.voxelize import voxelize_points
