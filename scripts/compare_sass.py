"""Compare the machine code (SASS) of kernels built from one CUDA source in
two trees, instruction for instruction.

    python3 scripts/compare_sass.py --tree build/parent \
        --source nvfi_torch/csrc/plane_product_bwd.cu \
        --kernel 'plane_product_bwd_kernelILi(\\d+)ELb0E'

Builds ``--source`` of this checkout and of ``--tree`` (a checkout of
another commit, e.g. its ``git archive`` unpacked under ``build/``) to a
cubin with nvfi_torch's nvcc flags, prints ptxas' registers and spills of
every kernel, disassembles both with cuobjdump and compares, for each kernel
whose mangled name matches ``--kernel`` (the match's groups name it), the
instructions with their addresses and encodings left out.  Prints one JSON
line and exits 1 if a matched kernel differs or is missing.  Needs the CUDA
toolkit (nvcc, cuobjdump), not a card.
"""

import argparse
import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from nvfi_torch.ops import kernels  # noqa: E402


def sass(source, out_dir, tag):
    """ptxas' report and {mangled kernel name: [instructions]} of one source."""
    cubin = out_dir / f"{tag}.cubin"
    nvcc = kernels._nvcc()
    built = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                            str(source.parent), "-cubin", str(source), "-o", str(cubin)],
                           capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(f"nvcc failed on {source}:\n{built.stderr[-4000:]}")
    report = [line.strip() for line in built.stderr.splitlines()
              if "registers" in line or "spill" in line or "entry function" in line]
    dump = subprocess.run([str(pathlib.Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    functions, current = {}, None
    for line in dump.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            current = functions.setdefault(head.group(1), [])
            continue
        text = re.sub(r"/\*.*?\*/", "", line).strip()
        if current is not None and text and not text.startswith("."):
            current.append(re.sub(r"\s+", " ", text))
    return report, functions


def matched(functions, pattern):
    out = {}
    for name, body in functions.items():
        m = re.search(pattern, name)
        if m:
            out["/".join(m.groups()) or m.group(0)] = body
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="the other checkout")
    ap.add_argument("--source", required=True, help="the .cu file, relative to each tree")
    ap.add_argument("--kernel", required=True, help="regex on the mangled kernel names")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        other_report, other = sass(pathlib.Path(args.tree).resolve() / args.source, tmp, "tree")
        this_report, this = sass(ROOT / args.source, tmp, "this")
    for tag, report in (("tree", other_report), ("this", this_report)):
        for line in report:
            print(f"[{tag}] {line}")
    old, new = matched(other, args.kernel), matched(this, args.kernel)
    result = {}
    for name in sorted(set(old) | set(new)):
        a, b = old.get(name), new.get(name)
        differ = None if a is None or b is None else sum(x != y for x, y in zip(a, b))
        result[name] = {"tree_instructions": None if a is None else len(a),
                        "this_instructions": None if b is None else len(b),
                        "differing_positions": differ, "equal": a is not None and a == b}
    ok = bool(result) and all(r["equal"] for r in result.values())
    print(json.dumps({"source": args.source, "kernel": args.kernel, "equal": ok,
                      "kernels": result}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
