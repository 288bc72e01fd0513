"""The port's public surface against the JAX package's.

- The last public names, each against its JAX counterpart on the same numpy
  inputs: the MinMax normaliser (1e-6), `axis_mask_from_bits` (exact),
  `find_latest_run` (equal), and the numpy copies of the native host
  helpers against `geometry_rl_tpu.native` (`edges_from_faces` exact,
  `polygon_sdf` 1e-6, `diag_kl_project` 1e-5).
- A surface test: every top-level name of every JAX module has a
  counterpart in the port's module of the same path (or the module the map
  below names), defined or re-exported there, or is an explicitly listed
  rename, private helper or TPU layout workaround; every name a JAX package
  `__init__.py` re-exports, the port's re-exports too.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu import native as jax_native
from geometry_rl_tpu.rl import normalizer as jax_normalizer
from geometry_rl_tpu.sim.types import axis_mask_from_bits as jax_axis_mask_from_bits
from geometry_rl_tpu.train.play import find_latest_run as jax_find_latest_run
from geometry_rl_torch import native
from geometry_rl_torch.rl import minmax_init, minmax_normalize, minmax_update
from geometry_rl_torch.sim import axis_mask_from_bits
from geometry_rl_torch.train.play import find_latest_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = os.path.join(REPO, "geometry_rl_tpu"), os.path.join(REPO, "geometry_rl_torch")

# JAX module -> the port's module of another path
MODULES = {
    "sim/pallas_cloth.py": "sim/cloth_solve.py",
    "native/__init__.py": "native.py",
}

# (JAX module, name) -> (the port's module, the name that stands in for it)
RENAMED = {
    # one entry for both Pallas kernels: cloth_position_solve(kernel="tiled")
    ("sim/pallas_cloth.py", "cloth_position_solve_tiled"): ("sim/cloth_solve.py", "cloth_position_solve"),
    ("graphs/rigid.py", "knn_edges_np"): ("graphs/rigid.py", "knn_edges"),
    # the native kNN graph's numpy twin lives with its consumer
    ("native/__init__.py", "knn_graph"): ("graphs/rigid.py", "knn_edges"),
    ("native/__init__.py", "knn_graph_batch"): ("graphs/rigid.py", "knn_graph_batch"),
    # the device mesh and shardings -> torch.distributed's process group and row blocks
    ("parallel/mesh.py", "ENV_AXIS"): ("parallel/mesh.py", "DataParallel"),
    ("parallel/mesh.py", "make_mesh"): ("parallel/mesh.py", "DataParallel"),
    ("parallel/mesh.py", "env_sharding"): ("parallel/mesh.py", "env_rows"),
    ("parallel/mesh.py", "replicated"): ("parallel/mesh.py", "replicate"),
    ("parallel/mesh.py", "replicate_pytree"): ("parallel/mesh.py", "replicate"),
    ("parallel/mesh.py", "shard_env_pytree"): ("parallel/mesh.py", "shard_env_state"),
}

# top-level names with no counterpart by design
UNPORTED = {
    # TPU layout workarounds: one-hot matmul gathers and the Pallas kernel bodies
    ("models/common.py", "MATMUL_GATHER_MAX_NODES"),
    ("models/common.py", "_one_hot"),
    ("sim/pallas_cloth.py", "_one_hot_rows"),
    ("sim/pallas_cloth.py", "_kernel"),
    ("sim/pallas_cloth.py", "_kernel_tiled"),
    ("sim/pallas_cloth.py", "_solve_env"),
    ("sim/pallas_cloth.py", "_solve_tile"),
    # lazy package roots (PEP 562) that defer JAX's backend start
    ("__init__.py", "_LAZY"), ("__init__.py", "__getattr__"), ("__init__.py", "__dir__"),
    ("train/__init__.py", "_LAZY"), ("train/__init__.py", "__getattr__"), ("train/__init__.py", "__dir__"),
    # the native library's build and ctypes binding (the port's copies are numpy)
    ("native/__init__.py", "HAVE_NATIVE"), ("native/__init__.py", "_DIR"), ("native/__init__.py", "_LIB"),
    ("native/__init__.py", "_SRC"), ("native/__init__.py", "_lib"), ("native/__init__.py", "_build"),
    ("native/__init__.py", "_load"), ("native/__init__.py", "_ptr"), ("native/__init__.py", "_f32"),
    ("native/__init__.py", "_i32"),
    # private helpers whose work the port does inline or through torch
    ("parallel/mesh.py", "_is_env_batched"), ("parallel/mesh.py", "_put_global"),
    ("train/checkpoint.py", "_manager"),  # orbax's CheckpointManager
    ("train/render.py", "_collect_frames"),  # public there: collect_frames
    ("models/calibration.py", "_walk_and_scale"),
    ("models/meshgraphnet.py", "_mlp"),
    ("rl/projections/fullcov.py", "_scalar_tangent_solve"),
    ("rl/projections/kl.py", "_bwd"), ("rl/projections/kl.py", "_forward"), ("rl/projections/kl.py", "_fwd"),
    ("rl/projections/kl.py", "_kl_diag_cov_projection"),  # custom_vjp's parts: a torch.autograd.Function
    ("rl/projections/papi.py", "_tree_get"), ("rl/projections/papi.py", "_tree_set"),
}


def _top_level(path, with_imports):
    """Names a module defines at top level (and, `with_imports`, imports)."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def _reexports(path):
    return {a.asname or a.name for node in ast.parse(open(path).read()).body
            if isinstance(node, ast.ImportFrom) for a in node.names}


def _jax_modules():
    for root, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), JAX_PKG)


def test_port_surface_covers_the_jax_package():
    missing, stale = [], []
    for rel in _jax_modules():
        port_rel = MODULES.get(rel, rel)
        port_path = os.path.join(PORT_PKG, port_rel)
        have = _top_level(port_path, with_imports=True) if os.path.exists(port_path) else set()
        for name in sorted(_top_level(os.path.join(JAX_PKG, rel), with_imports=False)):
            if name in have or (rel, name) in UNPORTED:
                continue
            target = RENAMED.get((rel, name))
            if target is None:
                missing.append(f"{rel}:{name}")
            elif target[1] not in _top_level(os.path.join(PORT_PKG, target[0]), with_imports=True):
                stale.append(f"{rel}:{name} -> {target}")
        if port_rel.endswith("__init__.py") and os.path.exists(port_path):
            missing += [f"{rel} re-exports {n}" for n in sorted(_reexports(os.path.join(JAX_PKG, rel)) - _reexports(port_path))
                        if n not in {name for _, name in RENAMED}]
    assert not missing, f"JAX names with no counterpart in the port: {missing}"
    assert not stale, f"renamed counterparts that are gone: {stale}"
    # every listed exception still names something of the JAX package
    jax_names = {(rel, n) for rel in _jax_modules() for n in _top_level(os.path.join(JAX_PKG, rel), with_imports=False)}
    assert set(RENAMED) | UNPORTED <= jax_names


@pytest.mark.parametrize("package", ["ops", "sim", "graphs", "rl", "utils", "parallel", "models", "train"])
def test_port_package_exports_import(package):
    """The port's `__init__` re-exports resolve, and the ops namespace hands
    out the functions where they live."""
    import importlib

    mod = importlib.import_module(f"geometry_rl_torch.{package}")
    for name in _reexports(os.path.join(PORT_PKG, package, "__init__.py")):
        assert getattr(mod, name) is not None, name
    if package == "ops":
        from geometry_rl_torch.models.common import scatter_sum
        from geometry_rl_torch.sim.cloth_solve import cloth_position_solve

        assert mod.cloth_position_solve is cloth_position_solve and mod.scatter_sum is scatter_sum
        assert len(_reexports(os.path.join(PORT_PKG, "ops", "__init__.py"))) == 8
        assert _reexports(os.path.join(PORT_PKG, "ops", "__init__.py")) == _reexports(os.path.join(JAX_PKG, "ops", "__init__.py"))


@pytest.mark.parametrize("case", ["test_rl", "rows", "batched"])
def test_minmax_matches_jax(case):
    rng = np.random.default_rng(7)
    if case == "test_rl":  # tests/test_rl.py::test_minmax_norm's input
        stat, batches = (2,), [np.array([[0.0, 5.0], [10.0, -5.0]], np.float32)]
    elif case == "rows":
        stat, batches = (3,), [rng.normal(size=(16, 3)).astype(np.float32) * s for s in (1.0, 4.0, 0.5)]
    else:
        stat, batches = (5, 3), [rng.normal(size=(4, 6, 5, 3)).astype(np.float32) for _ in range(2)]
    js, ts = jax_normalizer.minmax_init(stat), minmax_init(stat)
    for x in batches:
        js, ts = jax_normalizer.minmax_update(js, jnp.asarray(x)), minmax_update(ts, torch.as_tensor(x))
    for field in ("min", "max", "count"):
        np.testing.assert_allclose(getattr(ts, field).numpy(), np.asarray(getattr(js, field)), rtol=1e-6, atol=1e-6)
    for lo, hi in ((-1.0, 1.0), (0.0, 5.0)):
        got = minmax_normalize(ts, torch.as_tensor(batches[-1]), lo, hi).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_normalizer.minmax_normalize(js, jnp.asarray(batches[-1]), lo, hi)),
                                   rtol=1e-6, atol=1e-6)
    if case == "test_rl":
        assert got.max() <= 5.0 + 1e-6 and got.min() >= -1e-6
    # a zero range hits the 1e-8 guard in both
    flat = minmax_update(minmax_init((2,)), torch.ones(3, 2))
    jflat = jax_normalizer.minmax_update(jax_normalizer.minmax_init((2,)), jnp.ones((3, 2)))
    np.testing.assert_allclose(minmax_normalize(flat, torch.ones(1, 2)).numpy(),
                               np.asarray(jax_normalizer.minmax_normalize(jflat, jnp.ones((1, 2)))), rtol=1e-6)


def test_axis_mask_from_bits_matches_jax():
    for bits in range(8):
        got = axis_mask_from_bits(bits, device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_axis_mask_from_bits(bits)))


def test_find_latest_run_matches_jax(tmp_path):
    for name in ("rigid_insertion_hepi_trpl_26_01_02-10_00_00", "rigid_insertion_hepi_trpl_26_01_02-09_59_59",
                 "rigid_insertion_hepi_trpl_25_12_31-23_00_00", "rope_closing_hepi_trpl_26_02_01-00_00_00"):
        (tmp_path / name).mkdir()
    for prefix in ("rigid_insertion_hepi_trpl", "rope_closing", "", "rigid"):
        assert find_latest_run(str(tmp_path), prefix) == jax_find_latest_run(str(tmp_path), prefix)
    for fn in (find_latest_run, jax_find_latest_run):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path), "cloth_hanging")


needs_native = pytest.mark.skipif(not jax_native.HAVE_NATIVE, reason="the JAX package's native library did not build")


@needs_native
def test_edges_from_faces_matches_native():
    rng = np.random.default_rng(0)
    for faces in (rng.integers(0, 40, size=(60, 3)), np.array([[0, 1, 2], [2, 1, 3], [3, 1, 0]]),
                  np.array([[5, 5, 2]]), np.zeros((0, 3), np.int64)):
        got, ref = native.edges_from_faces(faces), jax_native.edges_from_faces(faces)
        assert got.dtype == ref.dtype == np.int32 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


@needs_native
def test_polygon_sdf_matches_native():
    rng = np.random.default_rng(3)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
    star = np.stack([np.cos(ang), np.sin(ang)], 1) * np.where(np.arange(9) % 2, 0.4, 1.0)[:, None]
    square = np.asarray([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)
    padded = np.concatenate([star, star[:1], star[:1]]).astype(np.float32)  # padded by repeating the first vertex
    q = rng.uniform(-2, 2, size=(256, 2)).astype(np.float32)
    q[:4] = [[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]  # on edges and vertices of the square
    for verts in (square, star.astype(np.float32), padded):
        got, ref = native.polygon_sdf(verts, q), jax_native.polygon_sdf(verts, q)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        assert ((got < 0) == (ref < 0)).all()


@needs_native
def test_diag_kl_project_matches_native():
    rng = np.random.default_rng(2)
    var = np.exp(rng.normal(size=(32, 6))).astype(np.float32)
    old_var = np.exp(rng.normal(size=(32, 6))).astype(np.float32)
    for eps in (0.0025, rng.uniform(1e-4, 2.0, size=32).astype(np.float32)):
        got, ref = native.diag_kl_project(var, old_var, eps), jax_native.diag_kl_project(var, old_var, eps)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # rows already inside the ball come back unchanged
    np.testing.assert_array_equal(native.diag_kl_project(var, var, 0.01), var)
