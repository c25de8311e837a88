#!/usr/bin/env python
"""What precision bundle adjustment's contractions run at, from the HLO.

    python scripts/ba_hlo_precision.py [--bucket C,P,N,T]

Compiles ops/ba.solve for one bucket of the shape journal
(scripts/shape_journal.json; default the local-BA bucket C=64, P=8192,
N=32768, T=32) on the default device, and sorts the FLOPs of every
contraction into where XLA put it:

  cublas   a cuBLAS GEMM custom call; f32 operands at DEFAULT or HIGH run
           as TF32 on the tensor cores, at HIGHEST in fp32
  triton   a dot inside a Triton GEMM fusion (same rule)
  dot      a dot left anywhere else (with the kind of fusion holding it)
  reduced  contractions XLA rewrote into multiply + reduce (no dot is left):
           the pre-optimisation dot FLOPs minus the three above; fp32

FLOPs are 2 * |output| * |contracted dims|, multiplied by the trip count of
each enclosing loop where the compiler knows it (the point-chunk scans); the
LM loop's trip count is dynamic and counts once, so the shares are those of
one LM iteration. Prints a table and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_SHAPE = re.compile(r"[a-z]\w*\[([\d,]*)\]")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")


def _split_type(s: str) -> tuple[str, str]:
    """'(f32[2]{0}, s8[4]{0}) custom-call(...' -> (type, 'custom-call(...')."""
    if s.startswith("("):
        depth = 0
        for i, ch in enumerate(s):
            depth += ch == "("
            depth -= ch == ")"
            if depth == 0:
                return s[: i + 1], s[i + 1 :].lstrip()
    t, _, rest = s.partition(" ")
    return t, rest


def _operands(rest: str) -> list[str]:
    """Operand names of 'op(a, f32[2]{0} %b), attrs' -> ['a', 'b']."""
    body, depth, out = rest[rest.index("(") + 1 :], 1, []
    cur = ""
    for ch in body:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
            if depth == 0:
                break
        if ch == "," and depth == 1:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    out.append(cur)
    return [o.strip().split()[-1].lstrip("%") for o in out if o.strip()]


def _dims(type_str: str) -> list[int]:
    m = _SHAPE.search(type_str)
    return [int(d) for d in m.group(1).split(",") if d] if m else []


def parse(hlo: str):
    """(computations {name: [instr]}, shapes {name: dims}, entry name)."""
    comps, shapes, entry, cur = defaultdict(list), {}, None, None
    for line in hlo.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            head = line.split()
            is_entry = head[0] == "ENTRY"
            cur = head[1 if is_entry else 0].lstrip("%")
            entry = cur if is_entry else entry
            continue
        m = _INSTR.match(line)
        if cur is None or not m:
            continue
        typ, rest = _split_type(m.group(2))
        op = rest.split("(", 1)[0]
        ins = dict(name=m.group(1), type=typ, op=op, rest=rest)
        comps[cur].append(ins)
        shapes[ins["name"]] = _dims(typ)
    return comps, shapes, entry


def _trip_count(ins, comps) -> int:
    m = re.search(r'"known_trip_count":\{"n":"(\d+)"', ins["rest"])
    if m:
        return int(m.group(1))
    cond = re.search(r"condition=%?([\w.\-]+)", ins["rest"]).group(1)
    body = [i for i in comps.get(cond, []) if i["op"] not in ("parameter", "get-tuple-element")]
    consts = [i for i in body if i["op"] == "constant" and i["type"].startswith("s32[]")]
    lts = [i for i in body if i["op"] == "compare" and "direction=LT" in i["rest"]]
    if len(consts) == 1 and len(lts) == 1 and len(body) == 2:  # a scan's i < n
        return int(re.search(r"constant\((\d+)\)", consts[0]["rest"]).group(1))
    return 1  # dynamic (the LM loop)


def weights(comps, entry):
    """{computation: executions per run}, and {computation: calling fusion's
    backend kind} for fused computations."""
    w, fusion_kind = defaultdict(float), {}

    def visit(comp, mult):
        w[comp] += mult
        for ins in comps.get(comp, []):
            r = ins["rest"]
            if ins["op"] == "while":
                body = re.search(r"body=%?([\w.\-]+)", r).group(1)
                visit(body, mult * _trip_count(ins, comps))
                continue
            if ins["op"] == "fusion":
                callee = re.search(r"calls=%?([\w.\-]+)", r).group(1)
                k = re.search(r'"kind":"([^"]+)"', r) or re.search(r"kind=(\w+)", r)
                fusion_kind[callee] = k.group(1) if k else "fusion"
                visit(callee, mult)
                continue
            names = re.findall(r"(?:to_apply|true_computation|false_computation)=%?([\w.\-]+)", r)
            for grp in re.findall(r"branch_computations=\{([^}]*)\}", r):
                names += [n.strip().lstrip("%") for n in grp.split(",")]
            if ins["op"] in ("call", "conditional"):
                for n in names:
                    visit(n, mult)

    visit(entry, 1.0)
    return w, fusion_kind


def contractions(hlo: str):
    """[(category, flops per run, precision, op_name)] of every dot and GEMM."""
    comps, shapes, entry = parse(hlo)
    w, fusion_kind = weights(comps, entry)
    out = []
    for comp, instrs in comps.items():
        mult = w.get(comp, 0.0)
        if not mult:
            continue
        for ins in instrs:
            r = ins["rest"]
            opname = re.search(r'op_name="([^"]*)"', r)
            opname = opname.group(1) if opname else ""
            if ins["op"] == "dot":
                lhs = shapes.get(_operands(r)[0], [])
                cd = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", r).group(1)
                prec = re.search(r"operand_precision=\{([^}]*)\}", r)
                kind = fusion_kind.get(comp)
                cat = ("triton" if kind and "triton" in kind
                       else "cudnn" if kind and "cudnn" in kind
                       else f"dot in {kind}" if kind else "dot")
            elif ins["op"] == "custom-call" and re.search(r'target="__cublas\$(gemm|lt)', r):
                lhs = shapes.get(_operands(r)[0], [])
                cd = ",".join(re.search(r'"lhs_contracting_dimensions":\[([^\]]*)\]', r)
                              .group(1).replace('"', "").split(","))
                prec = re.search(r'"operand_precision":\[([^\]]*)\]', r)
                cat = "cublas"
            else:
                continue
            k = math.prod(lhs[int(d)] for d in cd.split(",") if d)
            flops = 2.0 * math.prod(_dims(ins["type"])) * k * mult
            p = prec.group(1).replace('"', "").lower() if prec else "default"
            alg = re.search(r'"algorithm":"(\w+)"', r)
            if alg and alg.group(1) != "ALG_UNSET":
                p += f" {alg.group(1)}"
            out.append((cat, flops, p, opname))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bucket", default="64,8192,32768,32",
                    help="C,P,N,T of a 'ba' entry in scripts/shape_journal.json")
    args = ap.parse_args()

    import jax

    from colmap_pcd_tpu.ops import ba
    from colmap_pcd_tpu.utils import compile_cache, prewarm

    compile_cache.enable()
    C, P, N, T = (int(x) for x in args.bucket.split(","))
    with open(os.path.join(REPO, "scripts", "shape_journal.json")) as f:
        entry = next(e for e in json.load(f) if e["kind"] == "ba"
                     and (e["C"], e["P"], e["N"], e["T"]) == (C, P, N, T))
    prob, cfg = prewarm.ba_dummy_problem(entry)
    lowered = ba.solve.lower(prob, cfg)
    pre = sum(f for _, f, _, _ in contractions(lowered.as_text(dialect="hlo")))
    post = contractions(lowered.compile().as_text())
    dev = jax.devices()[0]
    by_cat = defaultdict(float)
    by_prec = defaultdict(float)
    for cat, f, p, _ in post:
        by_cat[cat] += f
        by_prec[f"{cat} {p}"] += f
    by_cat["reduced"] = max(pre - sum(by_cat.values()), 0.0)
    print(f"ba.solve bucket C={C} P={P} N={N} T={T} point_chunk={cfg.point_chunk} "
          f"on {dev.device_kind}: {pre / 1e9:.3f} GFLOP of contractions per LM iteration")
    for k, f in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {k:8s} {f / 1e9:10.4f} GFLOP  share {f / max(pre, 1):.4f}")
    for k, f in sorted(by_prec.items(), key=lambda kv: -kv[1]):
        print(f"  precision {k}: {f / 1e9:.4f} GFLOP")
    print("largest contractions:")
    for cat, f, p, name in sorted(post, key=lambda x: -x[1])[:12]:
        print(f"  {f / 1e9:10.4f} GFLOP  {cat:7s} {p:14s} {name}")
    print(json.dumps({"device_kind": dev.device_kind, "bucket": [C, P, N, T],
                      "pre_opt_flops": pre, "flops_by_category": dict(by_cat),
                      "flops_by_category_precision": dict(by_prec)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
