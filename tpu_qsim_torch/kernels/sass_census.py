"""The SASS of every kernel instance of the port's libraries, and whether it
equals another tree's; and the instructions of each register-op class.

    python -m tpu_qsim_torch.kernels.sass_census [--against ROOT] [--json PATH]
        [--classes]

Builds every library of ``_build.SIGNATURES`` (``nvcc``, on the machine
with the card) and lists each function in it (``_build.sass_listing``):
its instruction count and its count of each opcode. With ``--against
ROOT`` (the root of another checkout of the repo, e.g. the parent commit
unpacked with ``git archive``) it builds that tree's libraries too, from
its own sources into its own ``kernels/_build/``, and compares the two
function by function, in the libraries both trees have: the same
instructions (opcode and operands, in order) or not. A function's name is
compared with its anonymous namespace's hash removed, which differs
between two builds. Prints the card as ``nvidia-smi`` names it and one
JSON line; exits 1 when a function of a library both have differs or is
missing on either side (a library only one tree has is listed as
``unpaired``).

With ``--classes`` it reads the grid sweep's measurement build
(``grid_sweep_stamps``: ``csrc/grid_sweep.cu`` with ``QSIM_STAMPS``), whose
``Marks`` instances (compiled, never launched) mark the top of the op loop
and the start of each register-op class's code with a ``pmevent``
(``ptx.cuh::pm_marker``, ``PMTRIG`` in the SASS); it checks that each has
the opcodes of the main library's instance but its markers and its
alignment NOPs (:func:`marks_match`), and counts each class's instructions
(:func:`class_census`): the decode, the shortest path through the code from
the loop's marker to the class's (the op's descriptor loads, its tests
and its dispatch); and the class's own code, every instruction
reachable from its marker and from no other marker (a conditional branch
going either way, an indirect branch, the dispatch's jump table, to any
code that nothing else reaches). Local loads and stores (LDL, STL: spills)
count like any other instruction.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from collections import Counter, deque
from pathlib import Path

from . import _build

_ANON = re.compile(r"(\d+)_GLOBAL__N__")
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)(?:\.[A-Z0-9_.]+)?\s*([^;]*);")
# block_program.cuh's OpMark ids, in order
MARKS = ("loop", "swap", "swap_lane", "dense1", "dense1_lane", "diag")
STOP = {"EXIT", "RET", "BRX", "JMX", "BPT"}


def parse_functions(text: str) -> dict[str, list[tuple[int, bool, str, str]]]:
    """``cuobjdump -sass`` text as function -> (address, predicated, opcode,
    operands) of each instruction."""
    out: dict[str, list] = {}
    body = None
    for line in text.splitlines():
        if "Function :" in line:
            body = out.setdefault(line.split("Function :", 1)[1].strip(), [])
            continue
        m = _LINE.search(line) if body is not None else None
        if m:
            body.append((int(m.group(1), 16), bool(m.group(2)), m.group(3), m.group(4).strip()))
    return out


def _mark_ids(body) -> dict[int, int]:
    """Instruction index -> marker id of each PMTRIG. ``pmevent a`` shows as
    PMTRIG a or as its mask 1 << a, told apart by the values present."""
    values = {i: int(args.split()[0], 16) for i, (_, _, op, args) in enumerate(body)
              if op == "PMTRIG" and args.split() and args.split()[0].startswith("0x")}
    as_mask = bool(values) and (max(values.values()) >= len(MARKS) or 0 not in values.values())
    return {i: (v.bit_length() - 1 if as_mask else v) for i, v in values.items()}


def successors(body) -> list[list[int]]:
    """Each instruction's successors: the next one unless it is an
    unconditional jump or an exit; a direct branch's target; and, for an
    indirect branch, every instruction that starts code no fall-through or
    direct branch reaches (a jump table's cases)."""
    at = {addr: i for i, (addr, _, _, _) in enumerate(body)}
    n = len(body)
    succ: list[list[int]] = [[] for _ in range(n)]
    targets, dead = set(), set()
    for i, (_, pred, op, args) in enumerate(body):
        target = args.split()[0] if args.split() else ""
        if op == "BRA" and target.startswith("0x") and int(target, 16) in at:
            succ[i].append(at[int(target, 16)])
            targets.add(at[int(target, 16)])
        if op in STOP or (op == "BRA" and not pred):
            dead.add(i + 1)
        elif i + 1 < n:
            succ[i].append(i + 1)
    cases = sorted(j for j in dead if j < n and j not in targets)
    for i, (_, _, op, _) in enumerate(body):
        if op in ("BRX", "JMX"):
            succ[i] += cases
    return succ


def shortest(body, succ, start: int, goals: set[int]) -> Counter | None:
    """Opcodes on the shortest path from instruction ``start`` (excluded)
    to the nearest of ``goals`` (excluded), None where none is reached."""
    parent = {start: None}
    queue = deque([start])
    while queue:
        i = queue.popleft()
        for j in succ[i]:
            if j in parent:
                continue
            parent[j] = i
            if j in goals:
                path, k = Counter(), parent[j]
                while k != start:
                    path[body[k][2]] += 1
                    k = parent[k]
                return path
            queue.append(j)
    return None


def reach(body, succ, start: int, marks) -> set[int]:
    """Instructions reachable from ``start`` without passing a marker."""
    seen, todo = set(), [start]
    while todo:
        for j in succ[todo.pop()]:
            if j not in seen and j not in marks:
                seen.add(j)
                todo.append(j)
    return seen


def class_census(body) -> dict[str, dict]:
    """Per marker class of a kernel's SASS (the loop's marker, id 0, and
    each class's sites): the decode (shortest path from the loop's marker to
    the site), the body (the code reachable from the site and from no other
    marker), their sum with its local loads and stores, and the sum's
    opcodes at the first site."""
    marks = _mark_ids(body)
    loops = {i for i, m in marks.items() if m == 0}
    succ = successors(body)
    reached = {i: reach(body, succ, i, marks) for i in marks}
    out: dict[str, dict] = {}
    for i, mid in sorted(marks.items()):
        if mid == 0:
            continue
        name = MARKS[mid] if 0 < mid < len(MARKS) else f"mark{mid}"
        heads = [shortest(body, succ, j, {i}) for j in loops]
        head = min((h for h in heads if h is not None), key=lambda c: sum(c.values()),
                   default=Counter())
        own = reached[i].difference(*(r for j, r in reached.items() if j != i))
        tail = Counter(body[j][2] for j in own)
        both = head + tail
        rec = out.setdefault(name, {"decode": [], "body": [], "sites": [], "local": [],
                                    "opcodes": dict(both)})
        rec["decode"].append(sum(head.values()))
        rec["body"].append(sum(tail.values()))
        rec["sites"].append(sum(both.values()))
        rec["local"].append(both.get("LDL", 0) + both.get("STL", 0))
    return out


def classes(build, lib: str = "grid_sweep_stamps") -> dict[str, dict]:
    """:func:`class_census` of each marked kernel instance of ``lib``'s
    build (the grid sweep's ``Marks`` instances)."""
    funcs = parse_functions(build.sass_text(lib))
    return {strip_anonymous(fn): class_census(body) for fn, body in funcs.items()
            if any(op == "PMTRIG" for _, _, op, _ in body)}


_MAXM = re.compile(r"grid_sweep(?:_stamp)?_kernelILi(\d+)E")


def narrow_decode(cls: dict[str, dict]) -> dict[str, int]:
    """The fewest decode instructions of each class in the narrow grid
    sweep's marked instance, of :func:`classes`' result: what
    ``floor.DECODE`` holds."""
    from .fused_circuit import NARROW_CORE

    (census,) = [c for fn, c in cls.items() if int(_MAXM.search(fn).group(1)) == NARROW_CORE]
    return {name: min(c["decode"]) for name, c in census.items()}


def marks_match(build) -> dict[str, dict]:
    """Whether the markers leave the code as it is: each marked instance's
    instructions, its PMTRIGs and NOPs (alignment padding) taken out,
    against those of the main library's grid sweep instance of the same
    core width (``grid_sweep_kernel<MAXM>``, what the main path runs): the
    same count of each opcode (``equal``), and the same opcodes in the same
    order (``same_order``)."""
    pad = {"PMTRIG", "NOP"}
    main = {int(_MAXM.search(fn).group(1)): [op for _, op, _ in body if op not in pad]
            for fn, body in build.sass_listing("grid_sweep").items() if _MAXM.search(fn)}
    nops = {int(_MAXM.search(fn).group(1)): sum(op == "NOP" for _, op, _ in body)
            for fn, body in build.sass_listing("grid_sweep").items() if _MAXM.search(fn)}
    out = {}
    for fn, body in parse_functions(build.sass_text("grid_sweep_stamps")).items():
        if not any(op == "PMTRIG" for _, _, op, _ in body):
            continue
        maxm = int(_MAXM.search(fn).group(1))
        marked = [op for _, _, op, _ in body if op not in pad]
        theirs = main.get(maxm, [])
        mine_n, theirs_n = Counter(marked), Counter(theirs)
        out[strip_anonymous(fn)] = {
            "equal": mine_n == theirs_n, "same_order": marked == theirs,
            "marked": len(marked), "main": len(theirs),
            "nops": [sum(op == "NOP" for _, _, op, _ in body), nops.get(maxm, 0)],
            "differ": {op: [mine_n[op], theirs_n[op]] for op in sorted(set(mine_n) | set(theirs_n))
                       if mine_n[op] != theirs_n[op]}}
    return out


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
    ap.add_argument("--classes", action="store_true",
                    help="only the instructions of each register-op class (no --against)")
    args = ap.parse_args(argv)
    if args.classes and args.against is not None:
        ap.error("--classes reads this tree's build only")
    print(card(), flush=True)
    if args.classes:
        result = {"classes": classes(_build), "marks_match": marks_match(_build)}
        for fn, m in result["marks_match"].items():
            print(f"sass {fn[-44:]}: {m['marked']} instructions but its markers and NOPs "
                  f"({m['nops'][0]} NOPs), the main instance {m['main']} ({m['nops'][1]}): "
                  f"{'equal opcodes' if m['equal'] else m['differ']}, "
                  f"{'in' if m['same_order'] else 'not in'} the same order", flush=True)
        for fn, cls in result["classes"].items():
            for name, c in cls.items():
                print(f"sass classes {fn[-44:]} {name}: decode {c['decode']} + body "
                      f"{c['body']} = {c['sites']} instructions a site, local {c['local']}; "
                      f"{json.dumps(c['opcodes'])}", flush=True)
        if args.json is not None:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(result, indent=1))
        print(json.dumps(result))
        return 0
    mine = listings(_build)
    result = {"libraries": {lib: census(funcs) for lib, funcs in mine.items()}}
    ok = True
    if args.against is not None:
        theirs = listings(_other_build(args.against.resolve()))
        result["against"] = {lib: census(funcs) for lib, funcs in theirs.items()}
        same = {}
        for lib in sorted(set(mine) & set(theirs)):
            names = sorted(set(mine[lib]) | set(theirs[lib]))
            same[lib] = {fn: mine[lib].get(fn) == theirs[lib].get(fn) for fn in names}
            ok = ok and all(same[lib].values())
        result["same"] = same
        result["unpaired"] = sorted(set(mine) ^ set(theirs))
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    summary = {lib: {fn[-60:]: f["instructions"] for fn, f in funcs.items()}
               for lib, funcs in result["libraries"].items()}
    if "same" in result:
        summary = {"same": ok, "instructions": summary, "unpaired": result["unpaired"],
                   "differ": [f"{lib}:{fn}" for lib, fns in result["same"].items()
                              for fn, eq in fns.items() if not eq]}
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
