"""tisph_tpu_torch: the WCSPH solver of ``tisph_tpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It imports torch and numpy and never jax or ``tisph_tpu``; the JAX
package is the reference it is tested against.  Module tree (each module
mirrors the ``tisph_tpu`` module of the same path):

- ``version``            ``__version__``
- ``config``             scene schema, SolverParams
- ``geometry``           lattice sampler, meshes, voxelizer, ``build_state``,
                         emitters
- ``checkpoint``         npz checkpoints, the files of ``tisph_tpu.checkpoint``
- ``models``             SimState, SolverBase, WCSPH, rigid bodies, WCSPHRigid,
                         WCSPHLegacy (the reference's V1 physics)
- ``ops``                kernels, EOS, grid, per-particle phases, plain sweeps
- ``ops.cuda``           kernel wrappers and the nvcc build
- ``csrc``               the CUDA sources
- ``parallel``           the 1-D sharded solver (``ShardedWCSPH``, ``make_mesh``)
- ``render``             frame export (``FrameExporter``, ``load_frame``), 2D
                         ball pivoting (``bpa2d``), 3D surface guards
                         (``bpa3d``), the viewers (``viewer``, ``orbit``), GIFs
                         (``video``)
- ``utils``              union-find clustering, wireframe lines, state
                         validation (``debug``), timers and traces (``profiling``)
- ``native``             the C++ host library of clustering and 2D BPA (ctypes)
- ``run_scene``, ``run_sharded``, ``demo``, ``bench``, ``bench_ladder``  entry
                         points (``python -m tisph_tpu_torch.<name>``)
- ``tools``              the long-run measurements: ``soak``, ``compare_resort``,
                         ``compare_compat`` (``python -m
                         tisph_tpu_torch.tools.<name>``)
"""

from tisph_tpu_torch.version import __version__
from tisph_tpu_torch.config import SceneConfig, SolverParams, load_scene, scene_from_dict
from tisph_tpu_torch.geometry.builder import build_state
from tisph_tpu_torch.geometry.emitter import EmitterState, make_emitter_state
from tisph_tpu_torch.models.rigid import RigidState, rigid_from_host, rigid_to_host
from tisph_tpu_torch.models.state import SimState, state_from_host, state_to_host
from tisph_tpu_torch.models.wcsph import WCSPH
from tisph_tpu_torch.models.wcsph_legacy import WCSPHLegacy
from tisph_tpu_torch.models.wcsph_rigid import WCSPHRigid, advance, make_solver

__all__ = [
    "__version__",
    "SceneConfig",
    "SolverParams",
    "load_scene",
    "scene_from_dict",
    "build_state",
    "EmitterState",
    "make_emitter_state",
    "SimState",
    "state_from_host",
    "state_to_host",
    "WCSPH",
    "WCSPHLegacy",
    "RigidState",
    "rigid_from_host",
    "rigid_to_host",
    "WCSPHRigid",
    "make_solver",
    "advance",
]
