"""The port stands alone: sejonggo_torch and chip_smoke.py import no JAX,
flax, msgpack or sejonggo_tpu, nor h5py at import time (the card's
machine has none of them; io.h5data imports h5py when it is called), the
CUDA sources include no PyTorch header (they build with plain nvcc), and
chip_smoke.py refuses to run without a card or without the package."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "sejonggo_torch"

BLOCKER = r'''
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "sejonggo_tpu", "h5py")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
'''


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _run(code, cwd=REPO, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_and_smoke_import_without_jax():
    mods = _modules() + ["chip_smoke"]
    assert "sejonggo_torch.search.mcts" in mods
    assert {"sejonggo_torch.search.michi", "sejonggo_torch.search.heuristics",
            "sejonggo_torch.search.patterns", "sejonggo_torch.search.pattern_lut",
            "sejonggo_torch.search.rollout", "sejonggo_torch.learn.duel",
            "sejonggo_torch.learn.duel_michi"} <= set(mods)
    assert {"sejonggo_torch.parallel", "sejonggo_torch.parallel.dist",
            "sejonggo_torch.parallel.mesh", "sejonggo_torch.parallel.launch",
            "sejonggo_torch.parallel.dryrun"} <= set(mods)
    code = BLOCKER + f'''
import importlib
for m in {mods!r}:
    importlib.import_module(m)
import chip_smoke
from sejonggo_torch.goenv.positions import random_positions
s, sd, a = random_positions(9, 2, 5, 0, contact=0.9)
assert s.shape == (10, 9, 9) and a.shape == (10,)
s, sd, a = chip_smoke.positions(9, 2, 4, 0, "cpu")
assert s.shape == (8, 9, 9)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("ISOLATED")
'''
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED" in proc.stdout


def test_cuda_sources_include_no_torch_header():
    sources = sorted(PKG.glob("csrc/*.cu")) + sorted(PKG.glob("csrc/*.cuh"))
    assert {p.name for p in sources} >= {"gostep.cu", "flood.cu"}
    for path in sources:
        for line in path.read_text().splitlines():
            if line.strip().startswith("#include"):
                assert "torch" not in line and "ATen" not in line, (path, line)
    py = "\n".join(p.read_text() for p in PKG.rglob("*.py"))
    assert "cpp_extension" not in py


def test_build_is_one_plain_nvcc_call(monkeypatch):
    from sejonggo_torch.ops import _build

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    cmd = _build.nvcc_command(os.path.join(_build.BUILD_DIR, _build.LIB_NAME))
    assert cmd[:13] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "--threads", "0", "-Xptxas",
                        "-v", "-shared", "-Xcompiler", "-fPIC", "-o"]
    assert cmd[13].endswith("sejonggo_torch/build/libsejonggo_kernels.so")
    assert sorted(os.path.basename(c) for c in cmd[14:]) == ["flood.cu", "gostep.cu"]


def test_smoke_refuses_without_card_or_package(tmp_path):
    if shutil.which("nvidia-smi"):
        pytest.skip("this checks the refusal on a machine without a card")
    for cwd in (REPO, tmp_path):
        script = REPO / "chip_smoke.py"
        if cwd == tmp_path:
            shutil.copy(script, tmp_path / "chip_smoke.py")
            script = tmp_path / "chip_smoke.py"
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
