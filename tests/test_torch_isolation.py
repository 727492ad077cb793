"""The port stands alone: geomesa_tpu_torch (and chip_smoke.py and
scripts/torch_count_ab.py) import torch
and numpy, never jax and nothing of geomesa_tpu, and its entry points refuse
to fall back to the CPU when no device is given.

No numeric tolerances here: these are import and behaviour checks.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "geomesa_tpu_torch"


def _is_reference(mod: str) -> bool:
    return mod == "jax" or mod.startswith("jax.") or mod == "geomesa_tpu" or mod.startswith(
        "geomesa_tpu."
    )


def test_import_loads_torch_and_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import geomesa_tpu_torch\n"
        "for m in pkgutil.walk_packages(geomesa_tpu_torch.__path__, 'geomesa_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'torch' in sys.modules\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'geomesa_tpu' or m.startswith('geomesa_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('geomesa_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) >= 20  # every submodule was imported


def test_density_and_knn_modules_stand_alone():
    """The density and KNN slice's modules are among those the scans above
    cover, and import cleanly without jax in a fresh interpreter."""
    mods = ["ops/density.py", "ops/step.py", "store/reduce.py", "process/knn.py",
            "process/processes.py"]
    assert all((PKG / m).exists() for m in mods)
    code = (
        "import sys\n"
        + "".join(f"import geomesa_tpu_torch.{m[:-3].replace('/', '.')}\n" for m in mods)
        + "from geomesa_tpu_torch.parallel.query import batched_density_step, batched_knn_step\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'geomesa_tpu.'))\n"
        "       or m == 'geomesa_tpu']\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_join_modules_stand_alone():
    """The join slice's modules (the geometry copies, ops/join.py,
    process/join.py) are among those the scans above cover, and import
    cleanly without jax in a fresh interpreter."""
    mods = ["geometry/types.py", "geometry/predicates.py", "ops/join.py", "process/join.py"]
    assert all((PKG / m).exists() for m in mods)
    code = (
        "import sys\n"
        + "".join(f"import geomesa_tpu_torch.{m[:-3].replace('/', '.')}\n" for m in mods)
        + "from geomesa_tpu_torch.parallel.query import block_join_step, block_bbox_gather_step\n"
        "from geomesa_tpu_torch.ops.kernels import polygon_join, polygon_join_plain\n"
        "from geomesa_tpu_torch.workload import join_polygons\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'geomesa_tpu.'))\n"
        "       or m == 'geomesa_tpu']\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_track_and_extended_modules_stand_alone():
    """The track statistics slice's modules (trajectory/state.py, the
    track_stats kernel's wrapper, process/tracks.py) and the extended
    stores' density reduce and overlap fold are among those the scans above
    cover, and import cleanly without jax in a fresh interpreter."""
    mods = ["trajectory/state.py", "process/tracks.py", "store/reduce.py", "ops/kernels.py",
            "parallel/query.py"]
    assert all((PKG / m).exists() for m in mods)
    assert (PKG / "csrc" / "track_stats.cu").exists()
    code = (
        "import sys\n"
        + "".join(f"import geomesa_tpu_torch.{m[:-3].replace('/', '.')}\n" for m in mods)
        + "from geomesa_tpu_torch.trajectory import TrackState, build_track_state, track_stats\n"
        "from geomesa_tpu_torch.process.tracks import track_label\n"
        "from geomesa_tpu_torch.ops.kernels import (grouped_agg_overlap, track_stats_plain,\n"
        "    grouped_agg_overlap_plain)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'geomesa_tpu.'))\n"
        "       or m == 'geomesa_tpu']\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            mods += [a.value for a in node.args if isinstance(a, ast.Constant)]
    return mods


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_count_ab.py",
                                 ROOT / "scripts" / "torch_write_memory.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_reference_imports(path):
    bad = [m for m in _imports(path) if _is_reference(m)]
    assert not bad, f"{path} imports {bad}"


def test_native_sources_stand_alone_and_are_bound():
    """Every C++ and CUDA source of the port includes only its own headers
    under csrc/ and system headers (nothing of the reference's
    geomesa_tpu/native), and every ``extern "C"`` entry point it defines is
    bound by the port: ``ops.kernels._ENTRY_POINTS`` for the kernels,
    ``curve.zranges`` for the z-range planner."""
    import re

    from geomesa_tpu_torch.ops import kernels

    csrc = PKG / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cpp"))
    assert {p.name for p in sources} >= {"grouped_agg.cu", "zranges.cpp", "batched_density.cu",
                                         "batched_knn.cu", "polygon_join.cu", "track_stats.cu"}
    local = {p.name for p in csrc.glob("*.cuh")}
    bound = set(kernels._ENTRY_POINTS) | {"geomesa_zranges"}
    defined = set()
    zranges_py = (PKG / "curve" / "zranges.py").read_text()
    for path in sources + sorted(csrc.glob("*.cuh")):
        text = path.read_text()
        for inc in re.findall(r'#include\s+"([^"]+)"', text):
            assert inc in local, f"{path.name} includes {inc}"
        for name in re.findall(r'^(?:extern "C" )?(?:int|long) (geomesa_\w+)\(', text, re.M):
            assert name in bound, f"{path.name}: {name} has no binding"
            stem = kernels._ENTRY_POINTS.get(name, (path.stem,))[0]
            assert stem == path.stem, f"{name} is bound to {stem}, defined in {path.name}"
            defined.add(name)
    assert defined == bound  # and every binding names a defined entry point
    assert "geomesa_zranges" in zranges_py and "zranges.cpp" in zranges_py


def test_datastore_without_cuda_raises(monkeypatch):
    from geomesa_tpu_torch.store.datastore import DataStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataStore()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        DataStore(device="cuda")
    assert DataStore(device="cpu").device.type == "cpu"


def test_kernel_wrapper_rejects_bad_inputs():
    from geomesa_tpu_torch.ops.kernels import batched_count

    cols = [torch.zeros(10, dtype=torch.int32) for _ in range(4)]
    boxes = torch.zeros((2, 1, 4), dtype=torch.int32)
    times = torch.zeros((2, 1, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        batched_count(cols[0].long(), *cols[1:], 0, 10, boxes, times)
    with pytest.raises(ValueError):
        batched_count(*cols[:3], torch.zeros(9, dtype=torch.int32), 0, 10, boxes, times)
    with pytest.raises(ValueError):
        batched_count(*cols, 0, 10, boxes, times[:1])
    with pytest.raises(ValueError):
        strided = torch.zeros((2, 4, 2), dtype=torch.int32).transpose(1, 2)
        batched_count(*cols, 0, 10, strided, times)
