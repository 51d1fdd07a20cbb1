"""Port geometry parity: the mesh loader, transforms and voxelizer give
tisph_tpu's vertices, faces and particle sets exactly, and build_state of
the rigid scene (bodies first, then fluid) gives its arrays exactly."""

import os

import numpy as np
import pytest
import torch

import jax
import tisph_tpu as tt
from tisph_tpu.geometry import builder as jbuilder
from tisph_tpu.geometry import mesh as jmesh
from tisph_tpu.geometry import voxelize as jvox
from tisph_tpu.geometry.sampler import count_cube_particles as jcount

import tisph_tpu_torch as pt
from tisph_tpu_torch.geometry import builder, mesh, voxelize
from tisph_tpu_torch.geometry.sampler import count_cube_particles, cube_lattice

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
RIGID = os.path.join(SCENES, "bench_3d_rigid.json")
SPHERE = os.path.join(SCENES, "assets", "sphere.obj")
FIELDS = ("x", "v", "density", "pressure", "mass", "volume", "material",
          "color", "object_id")


def test_load_obj_matches_jax():
    got, ref = mesh.load_obj(SPHERE), jmesh.load_obj(SPHERE)
    assert got.vertices.dtype == ref.vertices.dtype and got.faces.dtype == ref.faces.dtype
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.faces, ref.faces)
    assert len(got.faces) > 0


def test_transforms_and_obj_round_trip_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    angle, axis = float(rng.uniform(0, 360)), rng.normal(size=3)
    np.testing.assert_array_equal(mesh.rotation_matrix(np.deg2rad(angle), axis),
                                  jmesh.rotation_matrix(np.deg2rad(angle), axis))
    got = mesh.sphere_mesh((0.1, 0.2, 0.3), 0.5, subdiv=2)
    ref = jmesh.sphere_mesh((0.1, 0.2, 0.3), 0.5, subdiv=2)
    for m in (got, ref):
        m.apply_scale((1.0, 2.0, 0.5)).apply_rotation(angle, axis).apply_translation((1, 0, 2))
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.faces, ref.faces)
    mesh.save_obj(got, tmp_path / "m.obj")
    back = jmesh.load_obj(tmp_path / "m.obj")  # written by the port, read by tisph_tpu
    np.testing.assert_allclose(back.vertices, got.vertices, rtol=1e-12)
    np.testing.assert_array_equal(back.faces, got.faces)


@pytest.mark.parametrize("which", ["sphere_obj", "box"])
def test_voxelize_points_match_jax(which):
    """The sphere of bench_3d_rigid.json at its transform and pitch, and a
    box mesh: the same float32 particle set, in the same order."""
    if which == "sphere_obj":
        scene = pt.load_scene(RIGID)
        got = builder.load_rigid_points(scene.rigid_bodies[0], scene)
        jscene = tt.load_scene(RIGID)
        ref = jbuilder.load_rigid_points(jscene.rigid_bodies[0], jscene)
        assert got.shape == (666, 3)
    else:
        got = voxelize.voxelize_points(mesh.box_mesh((0.42, 0.5, 0.42), (0.58, 0.62, 0.58)), 0.04)
        ref = jvox.voxelize_points(jmesh.box_mesh((0.42, 0.5, 0.42), (0.58, 0.62, 0.58)), 0.04)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_build_state_rigid_scene_matches_jax():
    got = pt.build_state(pt.load_scene(RIGID), device="cpu")
    ref = jax.device_get(tt.build_state(tt.load_scene(RIGID)))
    assert (got.num_active, got.capacity) == (60_858, 60_864) == (int(ref.num_active),
                                                                   ref.capacity)
    assert int(got.boundary_mask.sum()) == 666 and int(got.fluid_mask.sum()) == 60_192
    assert torch.equal(got.object_id[:666], torch.zeros(666, dtype=torch.int32))
    for k in FIELDS:  # whole capacity, padding included
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(SCENES) if f.endswith(".json")))
def test_build_state_matches_jax_on_every_scene(name):
    """Capacity (the emitters' pool included), num_active and every field
    over the whole capacity equal tisph_tpu's build_state."""
    path = os.path.join(SCENES, name)
    got = pt.build_state(pt.load_scene(path), device="cpu")
    ref = jax.device_get(tt.build_state(tt.load_scene(path)))
    assert (got.num_active, got.capacity) == (int(ref.num_active), ref.capacity)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)


def _scene_blocks():
    """Every scene's fluid blocks as (start, end, spacing), spacing as
    build_state takes it."""
    out = []
    for name in sorted(f for f in os.listdir(SCENES) if f.endswith(".json")):
        sc = pt.load_scene(os.path.join(SCENES, name))
        out += [(b.start, b.end, b.spacing or sc.particle_radius) for b in sc.fluid_blocks]
    return out


@pytest.mark.parametrize("start,end,spacing", [
    ([0.3, 0.1, 0.7], [1.0, 1.0, 1.0], 0.01),  # tests/test_geometry.py's blocks
    ([0.0, 0.0], [0.1, 0.1], 0.05),
    ([0.0, 0.0], [0.2, 0.2], 0.05),
] + _scene_blocks())
def test_count_cube_particles_matches_jax(start, end, spacing):
    """The exact lattice count equals tisph_tpu's and the lattice's rows."""
    got = count_cube_particles(start, end, spacing)
    assert type(got) is int
    assert got == jcount(start, end, spacing) == cube_lattice(start, end, spacing).shape[0]
