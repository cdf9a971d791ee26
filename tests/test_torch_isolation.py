"""sparse_tpu_torch stands alone: no jax, no sparse_tpu, no silent CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sparse_tpu_torch as st

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if not k.startswith("SPARSE_TPU_TORCH_")}
    env["PYTHONPATH"] = ROOT
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine that has one
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)


def test_import_pulls_in_neither_jax_nor_sparse_tpu():
    code = (
        "import sys\n"
        "import sparse_tpu_torch, sparse_tpu_torch.linalg, sparse_tpu_torch.io\n"
        "import sparse_tpu_torch.kernels.cg_dia, sparse_tpu_torch.kernels.dia_spmv\n"
        "import sparse_tpu_torch.interop, sparse_tpu_torch.plan_cache\n"
        "import sparse_tpu_torch.kernels.sell_spmv, sparse_tpu_torch.batch\n"
        "import sparse_tpu_torch.kernels._build, sparse_tpu_torch.ops.spmv\n"
        "import sparse_tpu_torch.batch.krylov, sparse_tpu_torch.batch.operator\n"
        "import sparse_tpu_torch.models, sparse_tpu_torch.models.poisson\n"
        "import sparse_tpu_torch.native, sparse_tpu_torch.hostsync, sparse_tpu_torch.module\n"
        "import sparse_tpu_torch.ops.spgemm, sparse_tpu_torch.ops.elementwise\n"
        "import sparse_tpu_torch.ops.reduce, sparse_tpu_torch.ops.sddmm\n"
        "import sparse_tpu_torch.ops.tropical, sparse_tpu_torch.ops.coords\n"
        "import sparse_tpu_torch._eigen, sparse_tpu_torch._laplacian, sparse_tpu_torch._direct\n"
        "import sparse_tpu_torch.linalg.isolve, sparse_tpu_torch.linalg.dsolve\n"
        "import sparse_tpu_torch.linalg.eigen, sparse_tpu_torch.linalg.interface\n"
        "import sparse_tpu_torch.linalg.matfuncs\n"
        "import sparse_tpu_torch.bsr, sparse_tpu_torch.dok, sparse_tpu_torch.lil\n"
        "import sparse_tpu_torch.csgraph, sparse_tpu_torch.integrate, sparse_tpu_torch.quantum\n"
        "import sparse_tpu_torch.spatial, sparse_tpu_torch.coverage, sparse_tpu_torch._bdf\n"
        "import sparse_tpu_torch._radau, sparse_tpu_torch.dop853_coefficients\n"
        "from sparse_tpu_torch import bsr_array, dok_array, lil_array, csgraph, integrate\n"
        "from sparse_tpu_torch import quantum, spatial, coverage_report\n"
        "from sparse_tpu_torch.linalg.isolve import cg\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sparse_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_linalg_surface_is_the_references():
    """Every name of sparse_tpu.linalg.__all__ resolves in the port but
    ir / batched_ir (ROADMAP queue 1 item 7: mixed/), and the port's
    __all__ names only what exists; the legacy namespaces hold the same
    objects."""
    import sparse_tpu.linalg as jlinalg

    from sparse_tpu_torch import linalg

    want = [n for n in jlinalg.__all__ if n not in ("ir", "batched_ir")]
    assert [n for n in want if not hasattr(linalg, n)] == []
    assert sorted(linalg.__all__) == sorted(want)
    for ns in ("isolve", "dsolve", "eigen", "interface", "matfuncs"):
        mod, ref = getattr(linalg, ns), getattr(jlinalg, ns)
        names = sorted(n for n in vars(ref) if not n.startswith("_"))
        assert sorted(n for n in vars(mod) if not n.startswith("_")) == names
        assert all(getattr(mod, n) is getattr(linalg, n) for n in names)


def test_coverage_report_is_the_references():
    """The port implements the same scipy.sparse names as the reference,
    the *_matrix aliases and sparray included, and its classes the same
    methods of scipy's."""
    import sparse_tpu

    mine, ref = st.coverage_report(), sparse_tpu.coverage_report()
    assert mine["implemented"] == ref["implemented"]
    for name in ("bsr_array", "bsr_matrix", "coo_matrix", "csc_matrix", "csr_matrix",
                 "dia_matrix", "dok_array", "dok_matrix", "lil_array", "lil_matrix", "sparray"):
        assert name in mine["implemented"]
    assert mine["classes"] == ref["classes"] and mine["missing"] == ref["missing"]


def test_native_library_builds_only_the_ports_own_source():
    """The host library compiles sparse_tpu_torch/csrc/host_native.cc and
    nothing under sparse_tpu/."""
    from sparse_tpu_torch import native

    src = native._SRC.resolve()
    assert src.parent == (Path(ROOT) / "sparse_tpu_torch" / "csrc").resolve()
    assert "sparse_tpu" + os.sep + "src" not in str(src)
    if native.lib() is not None:
        assert native._BUILD_DIR.resolve().is_relative_to((Path(ROOT) / "build").resolve())


def test_chip_smoke_imports_neither_and_refuses_without_cuda():
    """chip_smoke.py needs a card: with none visible it exits non-zero with
    no result line, without importing jax or sparse_tpu."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['chip_smoke.py']\n"
        "try:\n"
        f"    runpy.run_path({os.path.join(ROOT, 'chip_smoke.py')!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sparse_tpu'))\n"
        "print('rc', rc, 'bad', bad)\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "rc 2 bad []"
    assert '"ok"' not in out.stdout


def test_cuda_request_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    old = st.settings.device
    try:
        st.settings.device = "cuda"  # the package default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            st.diags([1.0, 2.0], [0, 1], shape=(3, 3))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            st.io.mmread(os.path.join(ROOT, "testdata", "small.mtx"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            st.csr_array(np.eye(3))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            st.linalg.cg(st.linalg.IdentityOperator((3, 3)), np.ones(3))
        st.settings.device = "cpu"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            st.diags([1.0, 2.0], [0, 1], shape=(3, 3), device="cuda")
        A = st.diags([1.0, 2.0], [0, 1], shape=(3, 3))  # asks for the CPU: runs
        assert A.device.type == "cpu"
    finally:
        st.settings.device = old


def test_default_device_is_cuda():
    from sparse_tpu_torch.config import Settings

    env = os.environ.pop("SPARSE_TPU_TORCH_DEVICE", None)
    try:
        assert Settings().device == "cuda"
    finally:
        if env is not None:
            os.environ["SPARSE_TPU_TORCH_DEVICE"] = env
