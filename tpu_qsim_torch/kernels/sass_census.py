"""The SASS of every kernel instance of the port's libraries, and whether it
equals another tree's.

    python -m tpu_qsim_torch.kernels.sass_census [--against ROOT] [--json PATH]

Builds every library of ``_build.SIGNATURES`` (``nvcc``, on the machine
with the card) and lists each function in it (``_build.sass_listing``):
its instruction count and its count of each opcode. With ``--against
ROOT`` (the root of another checkout of the repo, e.g. the parent commit
unpacked with ``git archive``) it builds that tree's libraries too, from
its own sources into its own ``kernels/_build/``, and compares the two
function by function: the same instructions (opcode and operands, in
order) or not. A function's name is compared with its anonymous
namespace's hash removed, which differs between two builds. Prints the
card as ``nvidia-smi`` names it and one JSON line; exits 1 when a function
differs or is missing on either side.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

from . import _build

_ANON = re.compile(r"(\d+)_GLOBAL__N__")


def strip_anonymous(name: str) -> str:
    """A mangled name with each anonymous namespace's name (its length
    prefix says where it ends) cut to ``_GLOBAL__N__``."""
    out, pos = [], 0
    for m in _ANON.finditer(name):
        if m.start() < pos:
            continue
        out += [name[pos:m.start()], "12_GLOBAL__N__"]
        pos = m.end(1) + int(m.group(1))
    return "".join(out) + name[pos:]


def _other_build(root: Path):
    """The ``_build`` module of the checkout at ``root``, loaded under a name
    of its own so that its paths are its tree's."""
    path = root / "tpu_qsim_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location("_sass_census_other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def listings(build) -> dict[str, dict[str, list[tuple[str, str]]]]:
    """library -> function (anonymous namespace hash removed) -> its
    instructions as (opcode, operands), every library built first."""
    build.build_all()
    out = {}
    for lib in build.SIGNATURES:
        out[lib] = {strip_anonymous(fn): [(op, args) for _, op, args in body]
                    for fn, body in build.sass_listing(lib).items()}
    return out


def census(funcs: dict[str, list[tuple[str, str]]]) -> dict[str, dict]:
    return {fn: {"instructions": len(body), "opcodes": dict(Counter(op for op, _ in body))}
            for fn, body in funcs.items()}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, help="root of another checkout to compare with")
    ap.add_argument("--json", type=Path, help="also write the full result here")
    args = ap.parse_args(argv)
    print(card(), flush=True)
    mine = listings(_build)
    result = {"libraries": {lib: census(funcs) for lib, funcs in mine.items()}}
    ok = True
    if args.against is not None:
        theirs = listings(_other_build(args.against.resolve()))
        result["against"] = {lib: census(funcs) for lib, funcs in theirs.items()}
        same = {}
        for lib in mine:
            names = sorted(set(mine[lib]) | set(theirs.get(lib, {})))
            same[lib] = {fn: mine[lib].get(fn) == theirs.get(lib, {}).get(fn) for fn in names}
            ok = ok and all(same[lib].values())
        result["same"] = same
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    summary = {lib: {fn[-60:]: f["instructions"] for fn, f in funcs.items()}
               for lib, funcs in result["libraries"].items()}
    if "same" in result:
        summary = {"same": ok, "instructions": summary,
                   "differ": [f"{lib}:{fn}" for lib, fns in result["same"].items()
                              for fn, eq in fns.items() if not eq]}
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
