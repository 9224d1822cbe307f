"""Trip-count-aware HLO cost analysis.

``compiled.cost_analysis()`` counts a ``while`` body ONCE — under
scan-over-layers that undercounts FLOPs/bytes/collective payload by the
layer count (and by seq_len for recurrent scans). This module parses the
compiled HLO text, recovers each while's static trip count from its
condition (`compare(iv, constant), direction=LT`), and accumulates:

* dot FLOPs (2 · prod(result dims) · prod(contracting dims)),
* HBM traffic proxy: Σ over top-level ops of (result + operand bytes) —
  post-fusion, inter-op buffers are materialized, so this tracks real
  traffic (fusion-internal ops excluded by construction),
* collective payload bytes by kind,

each scaled by the product of enclosing-loop trip counts. Whiles whose
trip count is data-dependent (the graph engine's fixpoint) multiply by 1
and set ``has_dynamic_loops`` — their numbers are per-iteration.

All numbers are for the PER-DEVICE (SPMD-partitioned) program.
"""
from __future__ import annotations

import dataclasses
import re

_DT_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
             "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
             "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16}

_SHAPE_RE = re.compile(
    r"\b(f64|f32|bf16|f16|s64|u64|s32|u32|s16|u16|s8|u8|pred|f8e4m3fn|"
    r"f8e5m2|c64|c128)\[([0-9,]*)\]")
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(.*\{\s*$")
_OP_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(.*)$")
_WHILE_RE = re.compile(
    r"while\(.*?\),\s*condition=%?([\w\.\-]+),\s*body=%?([\w\.\-]+)")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALL_RE = re.compile(r"\bcall\(.*?\),\s*to_apply=%?([\w\.\-]+)")
_COND_RE = re.compile(
    r"conditional\(.*?(?:true_computation=%?([\w\.\-]+),\s*"
    r"false_computation=%?([\w\.\-]+)|branch_computations={([^}]*)})")
_CONST_RE = re.compile(r"constant\((-?\d+)\)")
_DOT_CONTRACT = re.compile(r"lhs_contracting_dims={([0-9,]*)}")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _shape_elems(dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n


def _first_shape_bytes(text: str) -> float:
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(text):
        total += _shape_elems(dims) * _DT_BYTES[dt]
    return total


@dataclasses.dataclass
class Analysis:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    has_dynamic_loops: bool = False
    num_whiles: int = 0

    @property
    def collective_total(self) -> float:
        return float(sum(self.collective_bytes.values()))


def _split_computations(hlo: str) -> dict[str, list[str]]:
    comps: dict[str, list[str]] = {}
    cur = None
    depth = 0
    for line in hlo.splitlines():
        stripped = line.strip()
        if cur is None:
            m = _COMP_HDR.match(stripped)
            if m:
                cur = m.group(1)
                comps[cur] = []
                depth = stripped.count("{") - stripped.count("}")
                if depth <= 0:
                    cur = None
            continue
        depth += stripped.count("{") - stripped.count("}")
        if depth <= 0:
            cur = None
            continue
        comps[cur].append(line)
    return comps


def _trip_count(cond_lines: list[str]) -> int | None:
    """Recover `iv < constant` trip counts. Returns None if data-dependent."""
    consts: dict[str, int] = {}
    cmp_const: int | None = None
    direction = None
    for line in cond_lines:
        mo = _OP_RE.match(line)
        if not mo:
            continue
        name, rhs = mo.groups()
        mc = _CONST_RE.search(rhs)
        if rhs.lstrip().startswith(("s32[]", "s64[]", "u32[]", "u64[]")) and \
                "constant(" in rhs and mc:
            consts[name] = int(mc.group(1))
        if " compare(" in rhs or rhs.startswith("pred[] compare("):
            md = re.search(r"direction=(\w+)", rhs)
            direction = md.group(1) if md else None
            # operand names
            ops = re.findall(r"%([\w\.\-]+)", rhs.split("compare(", 1)[1])
            for op in ops:
                if op in consts:
                    cmp_const = consts[op]
    if cmp_const is not None and direction in ("LT", "GT", "LE", "GE", "NE"):
        return max(cmp_const, 1)
    return None


def _build_symtab(lines: list[str]) -> dict[str, tuple]:
    """op name -> (dims tuple of first result shape, bytes of result)."""
    tab: dict[str, tuple] = {}
    for line in lines:
        mo = _OP_RE.match(line)
        if not mo:
            continue
        name, rhs = mo.groups()
        m0 = _SHAPE_RE.search(rhs.split("(", 1)[0]) or _SHAPE_RE.search(rhs)
        if m0:
            dims = tuple(int(d) for d in m0.group(2).split(",") if d)
            tab[name] = (dims, _first_shape_bytes(rhs.split(" ", 1)[0])
                         or _shape_elems(m0.group(2)) * _DT_BYTES[m0.group(1)])
    return tab



_FUSION_CALLS = re.compile(r"(?:calls|to_apply)=%?([\w\.\-]+)")
_PARAM_IDX = re.compile(r"parameter\((\d+)\)")


def _fusion_bytes(operand_names, symtab, body_lines):
    """HBM traffic of a fusion: slice-aware reads + root-aware writes.

    A fusion param consumed (transitively through bitcast/reshape/copy/
    convert/transpose) only by dynamic-slice/gather reads just the slices;
    a param that is only the aliased destination of a dynamic-update-slice
    is not re-read; a DUS root (possibly behind a bitcast, or inside a
    tuple root) writes just the update. Keeps scan-carried stacked buffers
    (params stacks, activation stashes) from being charged at full size
    every loop iteration.
    """
    itab = _build_symtab(body_lines)
    producers: dict[str, tuple] = {}
    param_idx: dict[str, int] = {}
    root_name = None
    for line in body_lines:
        mo = _OP_RE.match(line)
        if not mo:
            continue
        name, rhs = mo.groups()
        opm = re.search(r"\b([a-z][a-z0-9\-]*)\(", rhs)
        opn = opm.group(1) if opm else ""
        args = rhs.split(opn + "(", 1) if opn else [rhs]
        ops = (_OPERAND_RE.findall(args[1].split(")", 1)[0])
               if len(args) > 1 else [])
        producers[name] = (opn, ops, rhs)
        mp = _PARAM_IDX.search(rhs)
        if opn == "parameter" and mp:
            param_idx[name] = int(mp.group(1))
        if line.lstrip().startswith("ROOT"):
            root_name = name

    _TRANSPARENT = ("bitcast", "reshape", "copy", "transpose", "convert",
                    "broadcast")
    consumers: dict[str, list] = {}
    for name, (opn, ops, _) in producers.items():
        for o in ops:
            consumers.setdefault(o, []).append(name)

    def effective_consumers(pname):
        out = []
        stack = [pname]
        seen = set()
        while stack:
            cur = stack.pop()
            for c in consumers.get(cur, []):
                if c in seen:
                    continue
                seen.add(c)
                opn = producers[c][0]
                if opn in _TRANSPARENT:
                    stack.append(c)
                else:
                    out.append((opn, c, cur))
        return out

    read = 0.0
    for i, on in enumerate(operand_names):
        full = symtab.get(on, ((), 0.0))[1]
        pname = next((n for n, idx in param_idx.items() if idx == i), None)
        if pname is None:
            read += full
            continue
        eff = effective_consumers(pname)
        if eff and all(op in ("dynamic-slice", "gather") for op, _, _ in eff):
            sbytes = sum(itab.get(n, ((), 0.0))[1] for _, n, _ in eff)
            read += min(sbytes or full, full)
        elif eff and all(
                op == "dynamic-update-slice" and
                producers[n][1] and producers[n][1][0] == src
                for op, n, src in eff):
            pass  # pure aliased DUS destination: no read
        else:
            read += full

    def resolve(name, depth=0):
        if depth > 20 or name not in producers:
            return name
        opn, ops, _ = producers[name]
        if opn in ("bitcast", "reshape", "copy", "transpose", "convert") and ops:
            return resolve(ops[0], depth + 1)
        return name

    def write_bytes_of(name):
        rn = resolve(name)
        opn, ops, rhs = producers.get(rn, ("", [], ""))
        if opn == "dynamic-update-slice" and len(ops) > 1:
            return itab.get(ops[1], ((), 0.0))[1]
        if opn == "tuple":
            return sum(write_bytes_of(o) for o in ops)
        return itab.get(rn, ((), 0.0))[1]

    write = write_bytes_of(root_name) if root_name else 0.0
    return read + write


_OPERAND_RE = re.compile(r"%([\w\.\-]+)")


def _line_costs(line: str, symtab: dict, comps: dict | None = None):
    """(flops, bytes, collective_kind_or_None, coll_bytes) for one op line."""
    mo = _OP_RE.match(line)
    if not mo:
        return 0.0, 0.0, None, 0.0
    rhs = mo.group(2)
    opm = re.search(r"\b([a-z][a-z0-9\-]*)\(", rhs)
    opname = opm.group(1) if opm else ""
    if opname in ("parameter", "constant", "get-tuple-element", "tuple",
                  "bitcast", "after-all", "partition-id", "replica-id",
                  "while", "call", "conditional"):
        return 0.0, 0.0, None, 0.0

    # result bytes: all shapes before the op name (covers tuple results)
    pre = rhs.split(opname + "(", 1)[0] if opname else rhs
    result_bytes = _first_shape_bytes(pre)
    # operand bytes via symbol table
    args = rhs.split(opname + "(", 1)
    operand_bytes = 0.0
    operand_names = []
    if len(args) > 1:
        argstr = args[1].split("), ", 1)[0].split(")", 1)[0]
        operand_names = _OPERAND_RE.findall(argstr)
        for on in operand_names:
            if on in symtab:
                operand_bytes += symtab[on][1]
    nbytes = result_bytes + operand_bytes
    if opname == "fusion" and comps is not None:
        mc = _FUSION_CALLS.search(rhs)
        body = comps.get(mc.group(1)) if mc else None
        if body:
            nbytes = _fusion_bytes(operand_names, symtab, body)
    elif opname == "dynamic-update-slice":
        # aliased in-place: traffic = 2 x update slice
        upd = operand_names[1] if len(operand_names) > 1 else None
        if upd and upd in symtab:
            nbytes = 2.0 * symtab[upd][1]
    elif opname in ("dynamic-slice", "gather"):
        nbytes = 2.0 * result_bytes

    flops = 0.0
    if opname == "dot":
        m0 = _SHAPE_RE.search(pre)
        result_elems = _shape_elems(m0.group(2)) if m0 else 0
        mc = _DOT_CONTRACT.search(rhs)
        contract = 1
        if mc and operand_names and operand_names[0] in symtab:
            lhs_dims = symtab[operand_names[0]][0]
            for ci in mc.group(1).split(","):
                if ci and int(ci) < len(lhs_dims):
                    contract *= lhs_dims[int(ci)]
        flops = 2.0 * result_elems * contract
    elif opname == "convolution":
        m0 = _SHAPE_RE.search(pre)
        flops = 2.0 * (_shape_elems(m0.group(2)) if m0 else 0)

    coll_kind = None
    coll_bytes = 0.0
    for kind in _COLLECTIVES:
        if re.search(rf"\b{kind}(-start)?\(", rhs):
            if re.search(rf"\b{kind}-done\(", rhs):
                break  # counted at -start
            coll_kind = kind
            coll_bytes = result_bytes
            break
    return flops, nbytes, coll_kind, coll_bytes


def analyze(hlo: str) -> Analysis:
    comps = _split_computations(hlo)
    symtabs = {name: _build_symtab(lines) for name, lines in comps.items()}

    res = Analysis()
    m = re.search(r"ENTRY\s+%?([\w\.\-]+)", hlo)
    entry = m.group(1) if m else list(comps)[-1]

    def walk(comp: str, mult: float):
        lines = comps.get(comp)
        if lines is None:
            return
        tab = symtabs[comp]
        for line in lines:
            f, b, ck, cb = _line_costs(line, tab, comps)
            res.flops += f * mult
            res.bytes_accessed += b * mult
            if ck:
                res.collective_bytes[ck] = (
                    res.collective_bytes.get(ck, 0.0) + cb * mult)
            mw = _WHILE_RE.search(line)
            if mw:
                cond, body = mw.groups()
                res.num_whiles += 1
                mt = _TRIP_RE.search(line)  # XLA backend_config, if present
                tc = int(mt.group(1)) if mt else _trip_count(
                    comps.get(cond, []))
                if tc is None:
                    res.has_dynamic_loops = True
                    tc = 1
                walk(body, mult * tc)
                walk(cond, mult * tc)
                continue
            if "fusion(" not in line:
                mc = _CALL_RE.search(line)
                if mc:
                    walk(mc.group(1), mult)
            md = _COND_RE.search(line)
            if md:
                branches = [g for g in md.groups()[:2] if g]
                if md.group(3):
                    branches += re.findall(r"%?([\w\.\-]+)", md.group(3))
                for br in branches:
                    walk(br, mult)  # upper bound: all branches

    walk(entry, 1.0)
    return res
