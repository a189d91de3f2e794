"""Compare the machine code (SASS) of one CUDA source's kernels in two
trees of the repository.

    python3 tools/sass_compare.py OLD_TREE NEW_TREE [--source bvh_winner_kernel.cu]

Compiles `raytracingthenextweekcuda_tpu_torch/csrc/SOURCE` of each tree to
a cubin with the package's compile flags (ops/cuda/build.py's
COMPILE_FLAGS, read from NEW_TREE), disassembles both with `cuobjdump
-sass`, and prints for each kernel of NEW_TREE its instruction count and
whether its instructions equal, one for one, those of the OLD_TREE kernel
of the same name (template arguments aside: `k<false>` is compared with a
plain `k`). An earlier commit is unpacked with `git archive <commit> | tar
-x -C _verify/parent`. Needs the CUDA toolkit (nvcc and cuobjdump).
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys
import tempfile

CSRC = pathlib.Path("raytracingthenextweekcuda_tpu_torch/csrc")


def _kernels(cubin: pathlib.Path, cuobjdump: str) -> dict:
    """{name: [instruction, ...]} of every kernel in `cubin`, the name with
    its template argument (`kernel`, `kernel<false>`, `kernel<true>`)."""
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?\d([a-z_]+_kernel)(ILb([01])E)?E", line)
        if m:
            name = m.group(1) + ("" if m.group(2) is None else
                                 "<true>" if m.group(3) == "1" else "<false>")
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", line):
            # the instruction and its encoding, without the address
            out[name].append(" ".join(line.split()[1:]))
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("old_tree")
    p.add_argument("new_tree")
    p.add_argument("--source", default="bvh_winner_kernel.cu")
    args = p.parse_args()
    new_root = pathlib.Path(args.new_tree).resolve()
    sys.path.insert(0, str(new_root))
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    nvcc = build._nvcc()
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    kernels = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, root in (("old", args.old_tree), ("new", new_root)):
            cubin = pathlib.Path(tmp) / f"{label}.cubin"
            subprocess.run([nvcc, *build.COMPILE_FLAGS, "-cubin", "-o", str(cubin),
                            str(pathlib.Path(root) / CSRC / args.source)], check=True)
            kernels[label] = _kernels(cubin, cuobjdump)
    for name, code in kernels["new"].items():
        base = name.split("<")[0]
        old = kernels["old"].get(name, kernels["old"].get(base))
        same = "no such kernel" if old is None else (
            f"{len(old)} instructions, identical: {old == code}")
        print(f"{args.source} {name}: {len(code)} instructions | {args.old_tree}: {same}")


if __name__ == "__main__":
    main()
