"""Guards of the port's boundaries: it imports no JAX (nor the JAX
package, nor ml_dtypes, which the machine with the card need not have),
asking for a card that is absent raises instead of running on the
CPU, the kernel build module imports on a machine with no nvcc, and
chip_smoke.py fails without a card or without the repository."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dsabeamformer_tpu_torch.config import TINY
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.ops import quantize
from dsabeamformer_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dsabeamformer_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        if "build" in path.relative_to(PORT).parts:
            continue
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _run(code_or_args, cwd=REPO, env_extra=None, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env.update(env_extra or {})
    args = code_or_args if isinstance(code_or_args, list) else \
        ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "dsabeamformer_tpu_torch.ops.gemm" in mods and len(mods) >= 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dsabeamformer_tpu', 'ml_dtypes'))\n"
        "print('LOADED', len(sys.modules), 'BAD', bad)\n"
        "assert not bad, bad\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names none of jax, the JAX package or ml_dtypes in an
    import (it cannot be imported here: it needs a card)."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert "dsabeamformer_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "dsabeamformer_tpu", "ml_dtypes"}


def test_build_module_imports_without_nvcc(tmp_path):
    code = (
        "import dsabeamformer_tpu_torch.ops._build as b\n"
        "import dsabeamformer_tpu_torch.ops.gemm\n"
        "try:\n"
        "    b.find_nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('NO NVCC:', e)\n"
        "try:\n"
        "    b.load_library('detect_power')\n"
        "except RuntimeError as e:\n"
        "    print('NO BUILD:', e)\n"
    )
    proc = _run(code, env_extra={"PATH": str(tmp_path),
                                 "CUDA_HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert "NO NVCC: nvcc not found" in proc.stdout
    assert "NO BUILD: nvcc not found" in proc.stdout


def test_kernel_sources_hold_one_design_each():
    """Every CUDA source the wrappers build is one design: no preprocessor
    switch at all, nothing read from the environment, exactly the two GEMM
    sources of ``gemm.KERNEL_SOURCES`` (``detect_power.cu`` and
    ``beam_voltages.cu``) and the dedispersion bank's
    (``dedisperse.KERNEL_SOURCE``) with no other ``.cu`` beside them, no
    GEMM left on the CUDA cores (``__dp4a`` products, ``fmaf``,
    ``float_gemm.cuh``), and both GEMM kernels issuing ``wgmma`` through
    ``mma_gemm.cuh``."""
    from dsabeamformer_tpu_torch.ops import dedisperse, gemm

    csrc = PORT / "csrc"
    for path in sorted(csrc.glob("*.cu*")):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            where = f"{path.name}:{n}: {line.strip()}"
            assert not re.match(r"\s*#\s*(if|ifdef|ifndef|elif)\b", line), \
                where
            assert "getenv" not in line and "environ" not in line, where
            assert "fmaf(" not in line.replace("__fmaf_rn(", ""), where
            # __dp4a is left only in the incoherent sum's masked power.
            if "__dp4a" in line:
                assert path.name == "detect_epilogue.cuh", where
    assert sorted(p.stem for p in csrc.glob("*.cu")) \
        == sorted(gemm.KERNEL_SOURCES + (dedisperse.KERNEL_SOURCE,)) \
        == ["beam_voltages", "dedisperse", "detect_power"]
    assert not (csrc / "float_gemm.cuh").exists()
    for name in gemm.KERNEL_SOURCES:
        text = (csrc / f"{name}.cu").read_text()
        assert '#include "mma_gemm.cuh"' in text and "tile_product(" in text
    assert "wgmma.mma_async" in (csrc / "mma_gemm.cuh").read_text()


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_weights(TINY, device="cuda")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        quantize.quant_weights_from_numpy([np.zeros((1, 2, 2), np.int8)],
                                          np.ones((1, 1), np.float32),
                                          device="cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Named no device, the entry points ask for CUDA: with no card they
    raise instead of returning CPU tensors."""
    from dsabeamformer_tpu_torch.ingest.sigproc import FilterbankSink
    from dsabeamformer_tpu_torch.ops.cplx import CVec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.savez(tmp_path / "w.npz", scales=np.ones((1, 1), np.float32),
             term0=np.zeros((1, 2, 2), np.int8))
    calls = [
        lambda: make_weights(TINY),
        lambda: quantize.quant_weights_from_numpy(
            [np.zeros((1, 2, 2), np.int8)], np.ones((1, 1), np.float32)),
        lambda: quantize.load_quant_weights(str(tmp_path / "w.npz")),
        lambda: CVec.from_numpy(np.ones((2, 3), np.complex64)),
        lambda: FilterbankSink(tmp_path / "fil", TINY, nbits=8,
                               scale=1.0).fused_quant8_scales(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
    assert make_weights(TINY, device="cpu").device == torch.device("cpu")


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    env = {"CUDA_VISIBLE_DEVICES": ""}
    for cwd, extra in ((tmp_path, {"PYTHONPATH": ""}), (REPO, {})):
        proc = _run([str(alone if cwd == tmp_path else REPO / "chip_smoke.py")],
                    cwd=cwd, env_extra={**env, **extra}, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
