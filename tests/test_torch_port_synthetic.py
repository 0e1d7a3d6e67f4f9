"""Port parity for ROADMAP item 15, the rest of synthetic.py: the seeded
sphere scenes (random_spheres), the lattice hard scene (its segments,
palette and field), ground-truth images of the fixed, a seeded and the
lattice scene, the seeded forward-facing poses, the dataset generator's
scene check, and the `python -m tinynerf_tpu_torch.synthetic` writer, on
the CPU against the JAX package's functions.

Images: 4 poses of 16x16 at 64 samples, the sphere scenes within 1e-5,
the lattice within 1e-4: one ulp of a sample point (5e-7 at depth 6)
moves d/r by 1.4e-5 at a strut's radius, its sigmoid of sharpness 24 and
density 60 turn that into up to 5e-3 of sigma, and an edge pixel moves by
up to 1e-4. The points differ by such ulps: XLA computes jnp.linspace as
i * (1 / (n - 1)) and contracts `ro + rd * z` inside lax.map into a fused
multiply-add, where torch.linspace and eager torch round otherwise. The
lattice field at the same points: sigma and rgb rtol 1e-5.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu import data as jdata
from tinynerf_tpu import synthetic as jsyn
from tinynerf_tpu_torch import data, synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1, 2, 123])
def test_random_spheres_bit_identical(seed):
    got = synthetic.random_spheres(seed)
    assert got.dtype == np.float32 and got.shape == (8, 8)
    np.testing.assert_array_equal(got, jsyn.random_spheres(seed))
    np.testing.assert_array_equal(synthetic.random_spheres(seed, 5), jsyn.random_spheres(seed, 5))


def test_lattice_tables_bit_identical():
    np.testing.assert_array_equal(synthetic._LAT_A, jsyn._LAT_A)
    np.testing.assert_array_equal(synthetic._LAT_B, jsyn._LAT_B)
    np.testing.assert_array_equal(synthetic._LAT_COLORS, jsyn._LAT_COLORS)
    assert synthetic._LAT_A.shape == (15, 3)


def test_field_lattice_matches_jax():
    """20,000 points in the scene's box and 20,000 within a few strut radii
    of a strut: sigma and rgb rtol 1e-5 (atol 1e-6 for values near 0)."""
    rng = np.random.RandomState(0)
    box = rng.uniform(-0.8, 0.8, (20000, 3))
    k = rng.randint(0, 15, 20000)
    a, b = synthetic._LAT_A[k], synthetic._LAT_B[k]
    near = a + rng.rand(20000, 1) * (b - a) + rng.randn(20000, 3) * 0.03
    pts = np.concatenate([box, near]).astype(np.float32)
    jr, js = jsyn.field_lattice(jnp.asarray(pts))
    tr, ts = synthetic.field_lattice(torch.from_numpy(pts))
    assert tr.shape == (40000, 3) and ts.shape == (40000, 1)
    assert float((ts > 1.0).float().mean()) > 0.3  # the struts, ball and slab are hit
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scene,seed", [("spheres", None), ("spheres", 3), ("lattice", None)])
def test_ground_truth_images_match_jax(scene, seed):
    """4 hemisphere poses of 16x16 at 64 samples: the fixed cluster and the
    cluster of seed 3 within 1e-5, the lattice within 1e-4 (module
    docstring)."""
    spheres = jsyn._SPHERES if seed is None else jsyn.random_spheres(seed)
    for pose in synthetic.hemisphere_poses(8)[::2]:
        want = np.asarray(jsyn.render_ground_truth(jnp.asarray(pose), n_samples=64, h=16, w=16,
                                                   spheres=jnp.asarray(spheres), scene=scene))
        got = synthetic.render_ground_truth(torch.from_numpy(pose), n_samples=64, h=16, w=16,
                                            spheres=None if seed is None else spheres,
                                            scene=scene, chunk=100).numpy()
        assert got.shape == (16, 16, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 if scene == "lattice" else 1e-5)


def test_generate_seeded_forward_facing_and_scene_check():
    """generate_synthetic_dataset(seed=, forward_facing=, scene=): the
    poses of the JAX package's (forward-facing ones seeded by `seed`), a
    seeded scene distinct from the fixed one, the lattice mostly white
    (the hard scene's background share); an unknown scene refused."""
    kw = dict(n_poses=2, h=8, w=8)
    for seed, ff in ((None, False), (5, True), (None, True)):
        got = synthetic.generate_synthetic_dataset(seed=seed, forward_facing=ff, **kw)
        want = jsyn.generate_synthetic_dataset(seed=seed, forward_facing=ff, **kw)
        np.testing.assert_array_equal(got["poses"], want["poses"])
        np.testing.assert_allclose(got["images"], want["images"], atol=1e-5)
        assert got["focal"] == want["focal"] and got["focal"].dtype == np.float32
    fixed = synthetic.generate_synthetic_dataset(**kw)["images"]
    assert np.abs(synthetic.generate_synthetic_dataset(seed=1, **kw)["images"] - fixed).max() > 0.05
    lattice = synthetic.generate_synthetic_dataset(n_poses=2, h=24, w=24, scene="lattice")
    white = float((lattice["images"].min(axis=-1) > 0.99).mean())
    assert 0.5 < white < 0.95, white
    with pytest.raises(ValueError, match="expected 'spheres'|'lattice'"):
        synthetic.generate_synthetic_dataset(scene="cube", **kw)


def test_cli_writes_an_npz_both_loaders_read(tmp_path):
    """`python -m tinynerf_tpu_torch.synthetic --scene lattice --device cpu`
    writes the npz schema, which the JAX package's loader and the port's
    read alike; its images are generate_synthetic_dataset's."""
    out = tmp_path / "sub" / "hard.npz"
    cmd = [sys.executable, "-m", "tinynerf_tpu_torch.synthetic", "--out", str(out), "--scene",
           "lattice", "--n-poses", "2", "--h", "10", "--w", "12", "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[synthetic] wrote" in proc.stdout and "scene=lattice" in proc.stdout
    j, t = jdata.load_tiny_nerf_npz(str(out)), data.load_tiny_nerf_npz(str(out))
    assert sorted(j) == sorted(t) == ["focal", "images", "poses"]
    for k in j:
        np.testing.assert_array_equal(np.asarray(j[k]), t[k])
    assert t["images"].shape == (2, 10, 12, 3) and t["images"].dtype == np.float32
    want = synthetic.generate_synthetic_dataset(n_poses=2, h=10, w=12, scene="lattice")
    np.testing.assert_array_equal(t["images"], want["images"])
    cfg = synthetic.GenConfig()
    assert (cfg.out, cfg.scene, cfg.n_poses, cfg.h, cfg.w, cfg.forward_facing, cfg.device) == (
        "data/synthetic.npz", "spheres", 106, 100, 100, False, "cuda")
