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


def _imported_packages(path) -> set:
    import ast

    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    return names


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names none of jax, the JAX package or ml_dtypes in an
    import (it cannot be imported here: it needs a card)."""
    names = _imported_packages(REPO / "chip_smoke.py")
    assert "dsabeamformer_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "dsabeamformer_tpu", "ml_dtypes"}


def test_multihost_worker_imports_no_jax():
    """The multi-process worker the port's tests spawn (on the CPU and on
    the card) names none of them either, and the scale-out modules are
    among those ``test_port_imports_no_jax`` walks."""
    names = _imported_packages(REPO / "tests" / "torch_multihost_worker.py")
    assert "dsabeamformer_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "dsabeamformer_tpu", "ml_dtypes"}
    assert {"dsabeamformer_tpu_torch.parallel",
            "dsabeamformer_tpu_torch.parallel.sharding",
            "dsabeamformer_tpu_torch.parallel.tensor",
            "dsabeamformer_tpu_torch.parallel.multihost"} \
        <= set(_port_modules())


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
        assert '#include "mma_gemm.cuh"' in text \
            and re.search(r"\btile_product(<\w+>)?\(", text)
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



def test_chip_smoke_stops_every_process_it_starts(tmp_path):
    """chip_smoke.py's sweep, on a failing run: a spawned capture process
    still waiting, and an orphan in a session of its own (as ``launch``'s
    children are when ``launch`` ends first), are stopped and reported;
    the resource tracker ends before the script does; nothing started is
    left running after it exits."""
    marker = f"chipsmoke-orphan-{os.getpid()}"
    script = tmp_path / "sweep.py"
    script.write_text(f"""
import multiprocessing, subprocess, sys
import chip_smoke

def wait(ev):
    ev.wait(120)

if __name__ == "__main__":
    chip_smoke.adopt_descendants()
    ctx = multiprocessing.get_context("spawn")
    ev = ctx.Event()
    ctx.Process(target=wait, args=(ev,), daemon=True).start()
    subprocess.run([sys.executable, "-c", "import subprocess, sys; "
                    "subprocess.Popen([sys.executable, '-c', "
                    "'import time; time.sleep(120)', '{marker}'], "
                    "start_new_session=True)"], check=True)
    try:
        raise RuntimeError("a phase failed")
    finally:
        stray = chip_smoke.stop_descendants(grace_s=10)
        print(sorted(stray.values()))
        print(chip_smoke.child_processes())
        print(multiprocessing.resource_tracker._resource_tracker._pid)
""")
    proc = _run([str(script)], timeout=120)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 1 and "a phase failed" in proc.stderr
    assert "leaked" not in proc.stderr and "Exception ignored" not in \
        proc.stderr
    stray, after, tracker = [eval(line) for line in lines[-3:]]
    assert len(stray) == 2 and any(marker in cmd for cmd in stray)
    assert any("spawn_main" in cmd for cmd in stray)
    # Only the tracker is left until the script's exit, and not after it.
    assert list(after) == [tracker]
    assert b"resource_tracker" not in _cmdline(Path(f"/proc/{tracker}"))
    assert not [d for d in Path("/proc").iterdir() if d.name.isdigit()
                and marker.encode() in _cmdline(d)]


def _cmdline(proc_dir) -> bytes:
    try:
        return (proc_dir / "cmdline").read_bytes()
    except OSError:
        return b""

def test_cli_and_its_children_import_no_jax(tmp_path):
    """``dsabf-torch``'s subcommands, run to their end, and the ``run``
    children that ``launch`` spawns import no JAX: with packages named
    jax, jaxlib, ml_dtypes and dsabeamformer_tpu that raise on import
    placed first on PYTHONPATH (which the children inherit), every command
    still exits 0."""
    poison = tmp_path / "poison"
    for name in ("jax", "jaxlib", "ml_dtypes", "dsabeamformer_tpu"):
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(
            f"raise ImportError('the port imported {name}')\n")
    from dsabeamformer_tpu_torch.ingest.generator import make_noise_block

    width = TINY.n_chan // 2
    for i in range(2):
        (tmp_path / f"cap{i}.raw").write_bytes(make_noise_block(
            TINY.subband(i * width, width), rms=2.0, seed=i).tobytes())
    t = str(tmp_path)
    commands = [
        ["info", "--config", "tiny"],
        ["weights", "--config", "tiny", "--out", f"{t}/w.npz", "--device",
         "cpu"],
        ["selftest", "--device", "cpu"],
        ["simulate", "--config", "tiny", "--blocks", "2", "--out-file",
         f"{t}/cap.dada"],
        ["run", "--config", "tiny", "--input-file", f"{t}/cap.dada",
         "--fil-dir", f"{t}/fil", "--fil-bits", "8", "--rfi-auto",
         "--incoherent-file", f"{t}/inco.dada", "--search-dm-max", "10",
         "--device", "cpu"],
        ["run", "--config", "tiny", "--input-file", f"{t}/cap.dada",
         "--mesh", "2", "--device", "cpu", "--output-file",
         f"{t}/mesh.dada", "--rfi-auto", "--incoherent-file",
         f"{t}/mesh-inco.dada"],
        ["fil", f"{t}/fil/beam0000.fil"],
        ["splice", f"{t}/fil/beam0000.fil", "--out", f"{t}/merged.fil"],
        ["levels", "--config", "tiny", "--input-file", f"{t}/cap.dada",
         "--device", "cpu"],
        ["rfi", "--config", "tiny", "--input-file", f"{t}/cap.dada",
         "--device", "cpu"],
        ["launch", "--subbands", "2", "--devices", "cpu,cpu", "--",
         "--config", "tiny", "--input-file", t + "/cap{i}.raw",
         "--output-file", t + "/out{i}.dat"],
        ["search", f"{t}/fil/beam0000.fil", f"{t}/fil/beam0001.fil",
         "--dm-max", "10", "--cand", f"{t}/s.cand", "--device", "cpu"],
        ["search", f"{t}/inco.dada", "--stream", "--beam", "incoherent",
         "--dm-max", "10", "--device", "cpu"],
        ["waterfall", f"{t}/fil/beam0000.fil", "--rows", "4", "--cols",
         "4"],
        ["fold", f"{t}/inco.dada", "--period",
         str(4 * TINY.sample_period_s * TINY.navg_time)],
        ["trace", "--config", "tiny", "--blocks", "1", "--out",
         f"{t}/trace", "--device", "cpu"],
        ["beampattern", "--config", "tiny", "--out", f"{t}/beams.png",
         "--sweep", "32", "--device", "cpu"],
        ["calibrate", "--config", "tiny", "--input-file", f"{t}/cap.dada",
         "--angle", "0", "--out", f"{t}/cal.npz", "--device", "cpu"],
        ["weights", "--config", "tiny", "--cal", f"{t}/cal.npz", "--out",
         f"{t}/wcal.npz", "--device", "cpu"],
        ["bench", "--config", "tiny", "--blocks", "2", "--device", "cpu"],
        ["bench", "--config", "tiny", "--blocks", "2", "--bench-mode",
         "stream", "--device", "cpu"],
    ]
    code = (
        "import sys\n"
        "from dsabeamformer_tpu_torch.cli import main\n"
        f"for argv in {commands!r}:\n"
        "    rc = main(argv)\n"
        "    assert rc == 0, (argv, rc)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dsabeamformer_tpu', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
    )
    proc = _run(code, env_extra={"PYTHONPATH": f"{poison}:{REPO}"},
                timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert '"ok": true' in proc.stdout      # launch's aggregate report
