"""Compare the SASS of two checkouts' CUDA libraries, kernel by kernel, on a
machine with the CUDA toolkit:

    python3 -m dsabeamformer_tpu_torch.utils.sass_compare PARENT_DIR TREE_DIR

Builds ``detect_power`` and ``beam_voltages`` in each checkout (its own
``ops/_build.py``, all four builds at once) and prints, for every kernel of
the first checkout's libraries, whether the second's kernel of the same
name has the same SASS (``cuobjdump -sass``), then the kernels only the
second has, and last ``SASS_DIFFERENT=<count>``.  The anonymous namespace's
hash in a kernel's name changes with the file's text, and the listing's
column widths with its longest line, so both are normalized away.  Used to
show that a change leaves the presets' instantiations as they were.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

LIBRARIES = ("detect_power", "beam_voltages")


def build(tree: str, name: str) -> str:
    """The path of ``tree``'s library ``name``, built by its own
    ``_build`` module in a process of its own."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from dsabeamformer_tpu_torch.ops._build import build; "
            "print(build(%r))" % (tree, name))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tree, check=True)
    return out.stdout.strip().splitlines()[-1]


def _norm(text: str) -> str:
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__X_", text)
    return " ".join(text.split())


def sass(library: str) -> dict:
    """Kernel name -> its SASS lines, normalized."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", library],
                         capture_output=True, text=True, check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _norm(m.group(1))
            kernels[name] = []
        elif name and line.strip():
            kernels[name].append(_norm(line))
    return kernels


def main(argv=None) -> int:
    parent, tree = (argv or sys.argv[1:])[:2]
    with ThreadPoolExecutor(2 * len(LIBRARIES)) as ex:
        libs = {(t, n): ex.submit(build, t, n)
                for t in (parent, tree) for n in LIBRARIES}
        libs = {k: f.result() for k, f in libs.items()}
    different = 0
    for n in LIBRARIES:
        a, b = sass(libs[(parent, n)]), sass(libs[(tree, n)])
        print(f"{n}: {len(a)} kernels in {parent}, {len(b)} in {tree}")
        for name, lines in a.items():
            same = b.get(name) == lines
            different += not same
            print(f"  {'SAME' if same else 'DIFFERENT'} {len(lines)} lines "
                  f"{name}")
        print(f"  only in {tree}: {sorted(set(b) - set(a))}")
    print(f"SASS_DIFFERENT={different}")
    return 1 if different else 0


if __name__ == "__main__":
    sys.exit(main())
