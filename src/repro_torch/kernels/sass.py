"""Instruction counts of built kernels from their SASS, on a host with the CUDA toolkit.

``python -m repro_torch.kernels.sass`` builds the BEHAV (K1, K2),
table-GEMV (K4, K5) and AxO matmul (K6) libraries and prints, for each of
their kernels named in
``KERNELS``, its SASS instruction count and its loop bodies, largest first,
each as its size and the shared-memory loads (``LDS``) in it, from
``cuobjdump -sass``.  A loop body runs from a backward branch's target to the
branch, 16 bytes an instruction; an outer loop's body holds its inner loops.
The kernel headers in ``csrc/`` quote these figures; nothing else reads
them.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

from . import build

__all__ = ["KERNELS", "loops", "main"]

# library -> substrings of the mangled names of the kernels to read: K1's
# and K2's two designs (the walks at a group of 64 codes; K1 at 4 configs a
# thread, K2 at 4 and at 1), K4's staged route at 8 bits and its gather
# route, K5's two designs (the redesign at 8 bits), K6's small-M route at
# rank 8 (8 rows x 256 and 512 columns, 16 rows x 256 and 512) and the GEMV
# it replaced at 4 and 8 rows a block
KERNELS = {
    "char_kernels": ("behav_stats_table_first_kernel", "behav_stats_walk_kernelILi6ELi4ELb0E",
                     "behav_stats_entry_first_kernel", "behav_stats_walk_kernelILi6ELi4ELb1E",
                     "behav_stats_walk_kernelILi6ELi1ELb1E"),
    "app_kernels": ("table_gemv_staged_kernelILi8E", "table_gemv_kernel",
                    "entry_gemv_staged_kernelILi8E", "entry_gemv_first_kernel"),
    "axo_matmul": ("axo_small_kernelILi1ELi4ELi9ELi1ELi2EE",
                   "axo_small_kernelILi1ELi8ELi9ELi1ELi2EE",
                   "axo_small_kernelILi2ELi4ELi9ELi4ELi1EE",
                   "axo_small_kernelILi2ELi8ELi9ELi4ELi1EE",
                   "axo_gemv_kernelILi4EE", "axo_gemv_kernelILi8EE"),
}

_INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")
_LDS = re.compile(r"\bLDS\b")
_BRANCH = re.compile(r"\bBRA(?:\.\w+)*\s+(?:`\()?(?:0x)?([0-9a-f]+)")


def loops(lib_path: Path, kernels) -> dict[str, tuple[int, list[tuple[int, int]]]]:
    """{kernel: (SASS instructions, loop bodies as (instructions, shared-memory
    loads), largest first)}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        key = next((k for k in kernels if k in name), None)
        if key is None:
            continue
        count, bodies, lds = 0, [], []
        for line in part.splitlines():
            ins = _INSTR.match(line)
            if not ins:
                continue
            count += 1
            at = int(ins.group(1), 16)
            lds += [at] if _LDS.search(ins.group(2)) else []
            br = _BRANCH.search(ins.group(2))
            if br and int(br.group(1), 16) < at:
                top = int(br.group(1), 16)
                bodies.append(((at - top) // 16 + 1, sum(top <= x <= at for x in lds)))
        out[key] = (count, sorted(bodies, reverse=True))
    missing = set(kernels) - set(out)
    if missing:
        raise RuntimeError(f"no SASS for {sorted(missing)} in {lib_path}")
    return out


def main() -> None:
    built = build.build_all(tuple(KERNELS))
    for lib, kernels in KERNELS.items():
        for name, (count, bodies) in loops(built[lib], kernels).items():
            print(f"{lib} {name}: {count} instructions, loop bodies (instructions, "
                  f"shared-memory loads) {bodies}")


if __name__ == "__main__":
    main()
