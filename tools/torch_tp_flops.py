"""FLOPs a device of every applicable (arch x shape) cell on small meshes,
the port's dry-run beside the JAX package's compiled module.

The port's side is ``repro_torch.launch.dryrun.run_cell`` on a fake
world of the mesh's size (host analysis, no GPU).  The reference's side
runs in a subprocess with 8 host devices: its ``launch.cells.build_cell``
lowered and compiled, counted by its ``hlo_analysis``.  One JSON line a
cell and mesh goes to ``--out``: the two FLOP counts, their ratio, the
port's status (and error), its collective counts and wall seconds.

    PYTHONPATH=src python tools/torch_tp_flops.py --out r.jsonl
    PYTHONPATH=src python tools/torch_tp_flops.py --arch yi-6b \\
        --meshes 4x2 --out r.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap
import time

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, applicability
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("8x1", "4x2", "2x4")

_REFERENCE = textwrap.dedent(r"""
    import json, sys
    import jax
    from repro import hlo_analysis
    from repro.launch import cells
    from repro.launch.mesh import make_mesh
    for arch, shape, dims in json.loads(sys.argv[1]):
        mesh = make_mesh(tuple(dims), ("data", "model"),
                         devices=jax.devices()[:8])
        try:
            cell = cells.build_cell(arch, shape, mesh)
            flops = hlo_analysis.analyze(
                cell.lowered.compile().as_text())["flops"]
        except Exception as e:
            flops = f"FAIL {type(e).__name__}: {str(e)[:200]}"
        print(json.dumps({"key": [arch, shape, list(dims)],
                          "flops": flops}), flush=True)
""")


def reference_flops(todo: list) -> dict:
    """{(arch, shape, mesh name): the reference's FLOPs a device}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps(todo)], capture_output=True, text=True,
                         env=env, timeout=3600)
    out = {}
    for line in res.stdout.splitlines():
        rec = json.loads(line)
        arch, shape, dims = rec["key"]
        out[(arch, shape, "x".join(map(str, dims)))] = rec["flops"]
    if res.returncode:
        print(res.stderr[-3000:], file=sys.stderr)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append",
                    help="an arch (repeatable; default: all)")
    ap.add_argument("--meshes", default=",".join(MESHES))
    ap.add_argument("--out", required=True, help="append JSONL records here")
    args = ap.parse_args(argv)
    meshes = args.meshes.split(",")
    todo = [(a, s, [int(x) for x in m.split("x")])
            for a in (args.arch or configs.list_archs()) for s in SHAPES
            if applicability(configs.get(a), s)[0] for m in meshes]
    ref = reference_flops(todo)
    for arch, shape, dims in todo:
        name = "x".join(map(str, dims))
        t0 = time.time()
        rec = {"arch": arch, "shape": shape, "mesh": name}
        try:
            got = dryrun.run_cell(arch, shape, verbose=False,
                                  mesh=dryrun.fake_mesh(dims,
                                                        ("data", "model")))
            rec.update(status=got["status"],
                       port_flops=got["hlo_flops_per_device"],
                       collective_counts=got["collective_counts"])
        except Exception as e:   # a failing cell is a finding; record it
            rec.update(status="FAIL", error=f"{type(e).__name__}: "
                       f"{str(e)[:300]}")
        want = ref.get((arch, shape, name))
        rec["jax_flops"] = want
        if isinstance(want, float) and rec.get("port_flops"):
            rec["ratio"] = rec["port_flops"] / want
        rec["wall_s"] = time.time() - t0
        with open(args.out, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")
        print(f"{rec['status']:5s} {arch} {shape} {name} "
              f"{rec.get('ratio')}", flush=True)


if __name__ == "__main__":
    main()
