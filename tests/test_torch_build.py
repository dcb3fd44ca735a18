"""The kernels' build (``ops/cuda/_build.py``) without nvcc: a stand-in
compiler that writes empty objects, prints a ptxas-like line per source and
links an empty library with g++, so the steps around nvcc run on the CPU."""
import shutil
import sys

import pytest

from bcosification_tpu_torch.ops.cuda import _build

FAKE_NVCC = """#!{python}
import subprocess, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    open(out, "w").close()
    print("ptxas info    : Used 42 registers, 0 bytes spill stores")
else:
    subprocess.run(["{gxx}", "-shared", "-o", out, "-x", "c", "/dev/null"], check=True)
"""


def test_build_log_survives_a_cached_load(tmp_path, monkeypatch):
    """A process that finds the library built still gets nvcc's log (the
    registers and spills that chip_smoke.py prints)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to link the stand-in library")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, gxx=gxx))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build_log", "")
    _build.load()
    built = _build.build_log
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert built.count("Used 42 registers") == len(sources) > 0
    assert all(f"== {src.name}" in built for src in sources)

    monkeypatch.setattr(_build, "_lib", None)  # a new process: the library is cached
    monkeypatch.setattr(_build, "build_log", "")
    _build.load()
    assert _build.build_log == built
    assert len(list((tmp_path / "build").glob("libbcos_kernels_*.so"))) == 1
